"""Hold the port's beam coverage penalty to the JAX package at the
flagship's full width, on the reads whose identity `chip_smoke.py`
phase 15 (f) gates.

Both packages basecall the first 20 simulated reads of phase 4 (seed 1,
3000 bases; attn stitch) with the MQA flagship (bench_results), beam 5,
f32 compute and an f32 wire, at beta 0 and with the coverage penalty
("wu" and "summary") at beta 0.2: the JAX package on the host CPU (XLA,
use_pallas false), the port on the card (the kernel route, which the
coverage penalty leaves for the unfolded step).  For each setting it
prints both sides' mean identity to the truth and mean call length, and
how many of the 20 calls are equal; the last line is one JSON object.

Needs a CUDA card and the JAX package importable beside the port:

    python scripts/coverage_witness.py [--reads 20] [--batch 16]
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

os.environ["JAX_PLATFORMS"] = "cpu"  # JAX stays off the card

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402

SETTINGS = (("none", 0.0), ("wu", 0.2), ("summary", 0.2))


def jax_translator(kind: str, beta: float, batch: int):
    import jax

    from nanodecoder_tpu.config import Config
    from nanodecoder_tpu.decode.translator import Translator
    from nanodecoder_tpu.models.model import init_model

    with open(cs.CONFIG) as f:
        cfg = Config.from_json(f.read())
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                       use_pallas=False),
        decode=dataclasses.replace(cfg.decode, mode="beam", beam_size=5,
                                   batch_chunks_beam=batch, h2d_dtype="float32",
                                   use_pallas=False, coverage_penalty=kind, beta=beta))
    return Translator(load_jax_params(init_model(jax.random.PRNGKey(0), cfg.model)), cfg)


def load_jax_params(like):
    """The flagship npz in the structure of `like`, as the JAX package's
    train.checkpoint.load_params_npz reads it (that module needs orbax)."""
    import jax

    data = np.load(cs.NPZ)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(like)
    return jax.tree_util.tree_unflatten(treedef, [
        data["/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)].astype(
            leaf.dtype) for kp, leaf in leaves])


def jax_calls(tr, reads) -> list[str]:
    from nanodecoder_tpu.io.fast5 import RawRead

    return [tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method="attn").sequence
            for i, (_truth, sig) in enumerate(reads)]


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reads", type=int, default=20)
    ap.add_argument("--batch", type=int, default=16,
                    help="chunks per decode batch (each read is one batch at 16)")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("coverage_witness: no CUDA device", file=sys.stderr)
        return 2
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.identity import read_identity
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    torch.backends.cuda.matmul.allow_tf32 = False
    reads = cs.simulated_reads(args.reads)
    truths = [truth for truth, _sig in reads]
    params = load_params_npz(cs.NPZ, cs.load_config("float32", "float32", 640).model,
                             device=torch.device("cuda", 0))
    out = {}
    for kind, beta in SETTINGS:
        t0 = time.perf_counter()
        ref = jax_calls(jax_translator(kind, beta, args.batch), reads)
        jax_s = time.perf_counter() - t0
        cfg = cs.load_config("float32", "float32", 640, mode="beam", beam_size=5,
                             batch_chunks_beam=args.batch, coverage_penalty=kind,
                             beta=beta)
        got = cs.call_reads(Translator(params, cfg), reads)[3]
        row = {
            "jax_identity": float(np.mean([read_identity(s, t) for s, t in zip(ref, truths)])),
            "port_identity": float(np.mean([read_identity(s, t) for s, t in zip(got, truths)])),
            "jax_length": float(np.mean([len(s) for s in ref])),
            "port_length": float(np.mean([len(s) for s in got])),
            "equal_calls": sum(a == b for a, b in zip(got, ref)),
            "port_vs_jax_identity": float(np.mean([read_identity(a, b)
                                                   for a, b in zip(got, ref)])),
            "jax_cpu_s": jax_s}
        out[f"{kind}_{beta}"] = row
        print(f"coverage {kind} beta {beta}, beam 5 f32, {len(reads)} reads: identity to "
              f"the truth JAX {row['jax_identity']:.4f}, port {row['port_identity']:.4f}; "
              f"mean length JAX {row['jax_length']:.2f}, port {row['port_length']:.2f} "
              f"bases; {row['equal_calls']}/{len(reads)} calls equal, port vs JAX "
              f"identity {row['port_vs_jax_identity']:.4f} (JAX on the CPU "
              f"{jax_s:.1f} s)", flush=True)
    print(json.dumps({"coverage_witness": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
