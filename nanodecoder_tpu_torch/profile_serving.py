"""Where one serving batch of the PyTorch port spends its time, on a card.

    python3 -m nanodecoder_tpu_torch.profile_serving [--mode greedy|beam]
        [--batch N] [--dtype bfloat16] [--ckpt PATH]
        [--form lean-mha|unfolded|rnn] [--trace DIR]

The model is `--ckpt` (an .npz params export with config.json beside it,
or a checkpoint directory of cli.train; default the committed MQA
flagship) in the form `--form` gives, built as chip_smoke.py phases 7, 8
and 14 build them: "lean-mha" tiles the MQA decoder's K/V projections
across the query heads (the same function in MHA form), "unfolded" does
that and serves it with lean_step false (per-layer self caches, the
unfolded encoder), "rnn" takes the checkpoint's widths with a biLSTM
encoder and an input-feed RNN decoder and random params (seed 14; no
recurrent checkpoint is committed).  `--trace DIR` writes the profiled
batch's Chrome trace there (`utils.profiling.device_trace`).

Fills one batch of `--batch` chunks from simulated reads (seed 1; by
default 640 chunks greedy, 256 chunks in beam mode, with the config's
beam size 5), runs it
once to warm up, then times it with CUDA events split into phases
(greedy: encode, decode; beam: encode, decode steps, advance + reorder,
backtrack), and profiles it with torch.profiler: device busy time (the
sum of kernel times; one stream, so kernels never overlap), the
device's idle share of the batch, and the kernels that take the most
device time.  It profiles the kernel route: it sets model.use_pallas
and decode.use_pallas true, as the evaluate CLI does on the card (the
committed config says model.use_pallas false).  Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import os
import subprocess
import sys
import time

import numpy as np
import torch
from torch.autograd import DeviceType

from nanodecoder_tpu_torch.cli.common import load_params_and_config
from nanodecoder_tpu_torch.decode.beam import beam_decode
from nanodecoder_tpu_torch.decode.greedy import greedy_decode
from nanodecoder_tpu_torch.decode.translator import Translator
from nanodecoder_tpu_torch.io.signal import (chunk_signal, convert_h2d,
                                             normalize_signal, wire_to_f32)
from nanodecoder_tpu_torch.models.model import encode
from nanodecoder_tpu_torch.train.checkpoint import (expected_param_shapes,
                                                    params_from_numpy, params_to_numpy)
from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read
from nanodecoder_tpu_torch.utils.profiling import device_trace

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP = os.path.join(REPO, "bench_results", "flagship_params.npz")
RNN_MODEL = {"encoder_type": "lstm", "decoder_type": "rnn"}
RNN_SEED, RNN_CELL_SCALE = 14, 3.0


def expand_kv_heads(flat: dict, heads: int) -> dict:
    """Flat MQA params -> the same model in MHA form: every decoder K/V
    projection (self and cross, w (D, Dh) and b (Dh,)) tiled across the
    heads.  The MHA model computes the same function."""
    out = dict(flat)
    for key, arr in flat.items():
        if key.startswith("decoder/layers/") and any(
                f"_attn/{p}/" in key for p in "kv"):
            out[key] = np.tile(arr, (1,) * (arr.ndim - 1) + (heads,))
    return out


def random_params(cfg, seed: int, generator_scale: float = 3.0,
                  rnn_cell_scale: float = 1.0) -> dict:
    """Flat params at cfg's shapes from a numpy seed: glorot-scaled dense
    and conv weights, embeddings of std 1/sqrt(D), unit LN scales, zero
    biases, the generator scaled up so that with this seed some chunks
    end early (EOS, then PAD) and some run to max_decode_len; an RNN
    decoder's LSTM weights scaled by rnn_cell_scale (at the init's scale a
    random recurrence settles on one token a chunk)."""
    rng = np.random.default_rng(seed)
    flat = {}
    for key, shape in expected_param_shapes(cfg).items():
        if key.endswith("/scale"):
            a = np.ones(shape)
        elif key.endswith("/bias") or key.endswith("/b"):
            a = np.zeros(shape)
        elif key.endswith("/table"):
            a = rng.standard_normal(shape) / np.sqrt(shape[1])
        else:
            fan_in = int(np.prod(shape[:-1]))
            a = rng.standard_normal(shape) * np.sqrt(2.0 / (fan_in + shape[-1]))
        flat[key] = a.astype(np.float32)
    flat["generator/w"] = flat["generator/w"] * generator_scale
    if cfg.decoder_type == "rnn":
        for key in flat:
            if key.startswith("decoder/layers/") and key[-3:] in ("/wx", "/wh"):
                flat[key] = flat[key] * rnn_cell_scale
    return flat


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mode", choices=["greedy", "beam"], default="greedy")
    ap.add_argument("--batch", type=int, default=0,
                    help="chunks per batch (default 640 greedy, 256 beam)")
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--h2d", default="int6")
    ap.add_argument("--top", type=int, default=12)
    ap.add_argument("--ckpt", default=FLAGSHIP,
                    help=".npz params (config.json beside it) or a checkpoint "
                         "directory of cli.train (default: the committed flagship)")
    ap.add_argument("--form", choices=["lean-mha", "unfolded", "rnn"], default=None,
                    help="serve the checkpoint in another form (default: as it is)")
    ap.add_argument("--trace", default=None,
                    help="directory for the profiled batch's Chrome trace")
    return ap


def build(args, device: str | torch.device = "cuda") -> Translator:
    """The Translator of `args`' checkpoint in `args.form`, on the kernel
    route (model.use_pallas and decode.use_pallas set true, as the
    evaluate CLI does on the card; the committed config says false)."""
    params, cfg = load_params_and_config(args.ckpt, "cpu")
    flat = params_to_numpy(params)
    model = {}
    if args.form in ("lean-mha", "unfolded"):
        if cfg.model.dec_kv_heads != 1:
            raise ValueError(f"--form {args.form} tiles an MQA decoder's K/V; this "
                             f"checkpoint has dec_kv_heads {cfg.model.dec_kv_heads}")
        flat = expand_kv_heads(flat, cfg.model.dec_heads)
        model = {"dec_kv_heads": 0, "lean_step": args.form == "lean-mha"}
    elif args.form == "rnn":
        model = RNN_MODEL
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=args.dtype,
                                       use_pallas=True, **model),
        decode=dataclasses.replace(cfg.decode, mode=args.mode, h2d_dtype=args.h2d,
                                   use_pallas=True,
                                   batch_chunks=args.batch,
                                   batch_chunks_beam=args.batch))
    if args.form == "rnn":
        flat = random_params(cfg.model, RNN_SEED, rnn_cell_scale=RNN_CELL_SCALE)
    return Translator(params_from_numpy(flat, cfg.model, device="cpu"), cfg, device=device)


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, timeout=60).stdout.strip()
    print(card)
    args.batch = args.batch or (256 if args.mode == "beam" else 640)
    tr = build(args)
    cfg = tr.config
    print(f"model: {args.ckpt}, form {args.form or 'as saved'}")

    spec, scfg = SimSpec(), cfg.signal
    levels = spec.level_table()
    rng = np.random.default_rng(1)
    chunks, lengths = [], []
    while sum(c.shape[0] for c in chunks) < args.batch:
        _seq, sig = simulate_read(rng, 3000, spec, levels)
        cb = chunk_signal(normalize_signal(sig, scfg.normalization, scfg.mad_scale,
                                           scfg.clip_sigma),
                          scfg.chunk_len, scfg.chunk_overlap, scfg.min_chunk_fill)
        chunks.append(cb.chunks)
        lengths.append(cb.lengths)
    chunks = np.concatenate(chunks)[:args.batch]
    lengths = np.concatenate(lengths)[:args.batch]
    wire = convert_h2d(chunks, tr._h2d, scfg.clip_sigma)

    marks: list[tuple[str, torch.cuda.Event]] = []

    def mark(name: str) -> None:
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append((name, ev))

    @torch.inference_mode()
    def run():
        marks.clear()
        signal = wire_to_f32(torch.from_numpy(wire).to(tr.device), tr._h2d,
                             scfg.clip_sigma, scfg.chunk_len)
        lens = torch.from_numpy(lengths).to(tr.device)
        mark("encode")
        memory, mem_lengths = encode(tr.params, cfg.model, signal, lens)
        if args.mode == "beam":
            res = beam_decode(tr.params, cfg.model, cfg.decode, memory, mem_lengths,
                              mark=mark)
        else:
            mark("decode")
            res = greedy_decode(tr.params, cfg.model, memory, mem_lengths)
        mark("end")
        return res

    run()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    phase_ms: dict[str, float] = collections.defaultdict(float)
    for (name, start), (_next, end) in zip(marks, marks[1:]):
        phase_ms[name] += start.elapsed_time(end)
    rows = args.batch * (cfg.decode.beam_size if args.mode == "beam" else 1)
    dec_ms = sum(ms for name, ms in phase_ms.items() if name != "encode")
    print(f"{args.mode} batch {args.batch} chunks ({rows} rows) {args.dtype}/{args.h2d}: "
          f"wall {wall_ms:.1f} ms, decode {dec_ms:.2f} ms over {res.steps} steps "
          f"({dec_ms / max(res.steps, 1):.3f} ms/step)")
    for name, ms in phase_ms.items():
        print(f"  {name:18s} {ms:9.2f} ms")

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with (device_trace(args.trace) if args.trace else
          torch.profiler.profile(activities=acts)) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        prof_wall_us = (time.perf_counter() - t0) * 1e6
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    if not kernels:
        print("profiler recorded no device time")
        return 1
    print(f"profiled batch: wall {prof_wall_us / 1e3:.1f} ms, device busy "
          f"{busy_us / 1e3:.1f} ms, idle share {1 - busy_us / prof_wall_us:.3f}, "
          f"{len(kernels)} kernels ({len(kernels) / max(res.steps, 1):.1f} per step)")
    by_name: dict[str, list[float]] = collections.defaultdict(list)
    for e in kernels:
        by_name[e.name].append(e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -sum(kv[1]))[:args.top]
    for name, ts in top:
        print(f"  {sum(ts) / 1e3:9.2f} ms {len(ts):6d}x  {name[:90]}")
    if args.trace:
        print(f"trace: {sorted(os.listdir(args.trace))}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
