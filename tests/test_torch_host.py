"""PyTorch port, host side: config, vocab, wire, simulator, weights,
stitching, identity, FASTQ, and the port's import and device rules.

Each test feeds the same numpy inputs to the JAX package and to the port
and compares the results."""

import ast
import dataclasses
import io
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = os.path.join(REPO, "nanodecoder_tpu_torch")
CONFIG = os.path.join(REPO, "bench_results", "config.json")
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")

FORBIDDEN = ("jax", "jaxlib", "orbax", "optax", "tensorstore", "zstandard", "nanodecoder_tpu")
# The one import of these the port keeps: the pod5 writer's compressor,
# zstandard at level 1 as the JAX package's writer (tests/test_torch_io.py
# holds the bytes equal), imported at its first call.  Reading pod5 and
# orbax checkpoints decodes zstd natively.
ALLOWED = ("nanodecoder_tpu_torch/io/pod5.py: zstandard",)


@pytest.mark.parametrize("text", [
    open(CONFIG).read(),
    json.dumps({"model": {"kmer_k": 3}, "decode": {"h2d_dtype": "int4"}}),
])
def test_config_from_json_field_equal(text):
    from nanodecoder_tpu.config import Config as JaxConfig
    from nanodecoder_tpu_torch.config import Config

    assert dataclasses.asdict(Config.from_json(text)) == \
        dataclasses.asdict(JaxConfig.from_json(text))


@pytest.mark.parametrize("k", [1, 4])
def test_vocab_matches_jax(k, rng_np):
    from nanodecoder_tpu.vocab import make_vocab as jax_vocab
    from nanodecoder_tpu_torch.vocab import make_vocab

    ours, ref = make_vocab(k), jax_vocab(k)
    assert ours.itos == ref.itos
    ids = rng_np.integers(0, ours.size, size=200)
    stream = rng_np.normal(size=200)
    got, ref_out = ours.decode_expand(ids, stream), ref.decode_expand(ids, stream)
    assert got[0] == ref_out[0]
    np.testing.assert_array_equal(got[1], ref_out[1])


@pytest.mark.parametrize("wire", ["float32", "float16", "int8", "int6", "int4"])
def test_wire_to_f32_bit_exact(wire, rng_np):
    import jax.numpy as jnp
    from nanodecoder_tpu.io import signal as jsig
    from nanodecoder_tpu_torch.io import signal as tsig

    x = np.clip(rng_np.normal(size=(5, 256)) * 1.7, -5, 5).astype(np.float32)
    x[3] = 0.0  # an all-zero (padding) row
    w = tsig.convert_h2d(x, wire, 5.0)
    w_ref = jsig.convert_h2d(x, wire, 5.0)
    assert w.dtype == w_ref.dtype and w.tobytes() == w_ref.tobytes()
    assert w.shape[1] == tsig.wire_columns(256, wire)
    got = tsig.wire_to_f32(torch.from_numpy(w), wire, 5.0, 256).numpy()
    ref = np.asarray(jsig.wire_to_f32(jnp.asarray(w_ref), wire, 5.0, 256))
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()


def test_normalize_and_chunk_match_jax(rng_np):
    from nanodecoder_tpu.io import signal as jsig
    from nanodecoder_tpu_torch.io import signal as tsig

    raw = rng_np.normal(80.0, 12.0, size=5000).astype(np.float32)
    norm = tsig.normalize_signal(raw)
    np.testing.assert_array_equal(norm, jsig.normalize_signal(raw))
    cb, ref = tsig.chunk_signal(norm, 1024, 128), jsig.chunk_signal(norm, 1024, 128)
    np.testing.assert_array_equal(cb.chunks, ref.chunks)
    np.testing.assert_array_equal(cb.lengths, ref.lengths)
    np.testing.assert_array_equal(cb.starts, ref.starts)


@pytest.mark.parametrize("seed,n", [(101, 900), (1, 3000)])
def test_simulate_read_bit_exact(seed, n):
    from nanodecoder_tpu.train.data import SimSpec as JSpec
    from nanodecoder_tpu.train.data import simulate_read_with_dwells as jsim
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read_with_dwells

    got = simulate_read_with_dwells(np.random.default_rng(seed), n, SimSpec())
    ref = jsim(np.random.default_rng(seed), n, JSpec())
    assert got[0] == ref[0]
    assert got[1].tobytes() == ref[1].tobytes()
    np.testing.assert_array_equal(got[2], ref[2])


def test_params_round_trip_flagship():
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import (load_params_npz,
                                                        params_to_numpy)

    cfg = Config.from_json(open(CONFIG).read())
    params = load_params_npz(NPZ, cfg.model, device="cpu")
    flat = params_to_numpy(params)
    with np.load(NPZ) as data:
        assert len(data.files) == 191
        assert sorted(flat) == sorted(data.files)
        for key in data.files:
            assert flat[key].shape == data[key].shape, key
            np.testing.assert_array_equal(flat[key], data[key], err_msg=key)
    # torch layouts: conv (O, I, W), dense (in, out)
    assert tuple(params["encoder"]["frontend"]["convs"][0]["w"].shape) == (64, 1, 5)
    assert tuple(params["decoder"]["layers"][2]["self_attn"]["k"]["w"].shape) == (256, 32)
    assert len(params["encoder"]["body"]["layers"]) == 6


def test_params_from_numpy_rejects_mismatch():
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    cfg = Config.from_json(open(CONFIG).read())
    with np.load(NPZ) as data:
        flat = {k: data[k] for k in data.files}
    flat.pop("generator/b")
    with pytest.raises(ValueError, match="missing"):
        params_from_numpy(flat, cfg.model, device="cpu")
    flat["generator/b"] = np.zeros(7, np.float32)
    with pytest.raises(ValueError, match="shape"):
        params_from_numpy(flat, cfg.model, device="cpu")


def test_read_identity_matches_native(rng_np):
    from nanodecoder_tpu.native import edit_distance as native_ed
    from nanodecoder_tpu.native import read_identity as native_id
    from nanodecoder_tpu_torch.identity import edit_distance, read_identity

    for _ in range(200):
        a = "".join(rng_np.choice(list("ACGT"), int(rng_np.integers(0, 60))))
        b = list(a)
        for _ in range(int(rng_np.integers(0, 15))):
            p = int(rng_np.integers(0, len(b) + 1))
            op = int(rng_np.integers(0, 3))
            if op == 0:
                b.insert(p, "ACGT"[int(rng_np.integers(4))])
            elif b and p < len(b):
                if op == 1:
                    b.pop(p)
                else:
                    b[p] = "ACGT"[int(rng_np.integers(4))]
        b = "".join(b)
        assert edit_distance(a, b) == native_ed(a, b), (a, b)
    truth = "".join(rng_np.choice(list("ACGT"), 3000))
    called = truth[:900] + truth[1000:2500] + "ACGT" * 30 + truth[2500:]
    assert read_identity(called, truth) == native_id(called, truth)


@pytest.mark.parametrize("method", ["trim", "align", "attn"])
def test_stitch_matches_jax(method, rng_np):
    from nanodecoder_tpu.io import stitch as jst
    from nanodecoder_tpu_torch.io import stitch as tst

    starts = np.array([0, 1792, 3584], np.int64)
    lengths = np.array([2048, 2048, 1200], np.int32)
    seqs = ["".join(rng_np.choice(list("ACGT"), n)) for n in (230, 226, 140)]
    quals = [rng_np.uniform(1, 50, len(s)).astype(np.float32) for s in seqs]
    if method == "attn":
        pos = [np.sort(rng_np.integers(0, int(l), len(s)))
               for s, l in zip(seqs, lengths)]
        got = tst.stitch_chunks_attn(seqs, pos, starts, lengths, quals=quals)
        ref = jst.stitch_chunks_attn(seqs, pos, starts, lengths, quals=quals)
    else:
        # Give adjacent calls a true overlap for the align rule to find.
        seqs[1] = seqs[0][-25:] + seqs[1][25:]
        got = tst.stitch_chunks(seqs, starts, lengths, 2048, 256, method, quals)
        ref = jst.stitch_chunks(seqs, starts, lengths, 2048, 256, method, quals)
    assert got[0] == ref[0]
    np.testing.assert_array_equal(got[1], ref[1])


def test_fastq_writer_and_phred_match_jax(rng_np):
    from nanodecoder_tpu.decode.translator import _phred_from_log_probs as jphred
    from nanodecoder_tpu.io.fastx import write_fastq as jwrite
    from nanodecoder_tpu_torch.decode.finish import _phred_from_log_probs
    from nanodecoder_tpu_torch.io.fastx import write_fastq

    lps = -rng_np.exponential(0.05, size=300).astype(np.float32)
    q = _phred_from_log_probs(lps)
    np.testing.assert_array_equal(q, jphred(lps))
    recs = [("r1", "ACGT" * 75, q), ("r2", "AC", 12.4), ("r3", "GGT", None)]
    a, b = io.StringIO(), io.StringIO()
    assert write_fastq(recs, a) == jwrite(recs, b) == 3
    assert a.getvalue() == b.getvalue()


def _port_files():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _dirs, names in os.walk(PORT):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    return sorted(files)


def test_port_imports_no_jax_ast():
    offenders = []
    for path in _port_files():
        tree = ast.parse(open(path).read(), path)
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                if name.split(".")[0] in FORBIDDEN:
                    offenders.append(f"{os.path.relpath(path, REPO)}: {name}")
    assert len(_port_files()) > 20
    assert os.path.join(PORT, "ops", "attention.py") in _port_files()
    assert os.path.join(PORT, "models", "importer.py") in _port_files()
    assert not [o for o in offenders if o not in ALLOWED], offenders


def test_port_imports_no_jax_subprocess():
    mods = sorted(
        os.path.relpath(p, REPO)[:-3].replace(os.sep, ".").replace(".__init__", "")
        for p in _port_files() if not p.endswith("chip_smoke.py"))
    code = (
        "import importlib, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "import chip_smoke\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN!r}]\n"
        "assert 'jax' not in sys.modules and not bad, bad\n"
        "print('ok', len(sys.modules))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0 and res.stdout.startswith("ok"), res.stderr


def test_chip_smoke_fails_without_card(tmp_path):
    res = subprocess.run([sys.executable, os.path.join(REPO, "chip_smoke.py")],
                         cwd=tmp_path, capture_output=True, text=True, timeout=300)
    assert res.returncode != 0 and res.stdout == "", res.stdout


def test_chip_smoke_fails_outside_checkout(tmp_path, monkeypatch, capsys):
    import chip_smoke

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(chip_smoke, "REPO", str(tmp_path))
    assert chip_smoke.main() != 0
    assert capsys.readouterr().out == ""


def test_entry_points_default_to_cuda(monkeypatch):
    from nanodecoder_tpu_torch.cli import evaluate
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.device import resolve_device
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config.from_json(open(CONFIG).read())
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        load_params_npz(NPZ, cfg.model)
    params = load_params_npz(NPZ, cfg.model, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Translator(params, cfg)
    beam = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode, mode="beam"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Translator(params, beam)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--ckpt", NPZ, "--simulate", "1", "--beam", "5"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        evaluate.main(["--ckpt", NPZ, "--simulate", "1", "--int8-cross"])
    unfolded = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, lean_step=False, dec_kv_heads=0, cross_cache_int8=True))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Translator(params, unfolded)
    assert resolve_device("cpu") == torch.device("cpu")
    # ops/attention.py: the plain version only for CPU tensors; any other
    # device goes to the kernel or raises.
    from nanodecoder_tpu_torch.ops import attention

    q, kv = torch.zeros(2, 64), torch.zeros(2, 8, 64)
    n = torch.full((2,), 8, dtype=torch.int32)
    before = attention.decode_attention.launches
    assert attention.decode_attention(q, kv, kv, n, 4)[0].device.type == "cpu"
    assert attention.decode_attention.launches == before
    with pytest.raises(ValueError, match="CUDA device"):
        attention.decode_attention(q.to("meta"), kv.to("meta"), kv.to("meta"),
                                   n.to("meta"), 4)
    with pytest.raises(ValueError, match="CUDA device"):
        attention.decode_attention_grouped(torch.zeros(4, 64, device="meta"),
                                           kv.to("meta"), kv.to("meta"),
                                           n.to("meta"), 4, 2)
