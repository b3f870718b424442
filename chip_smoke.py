#!/usr/bin/env python3
"""Drive the PyTorch port (nanodecoder_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, nvcc and the repository checkout around
this file; the first phase builds the kernels from nanodecoder_tpu_torch/csrc.
Phases, in order; any failure exits non-zero before the last line:

  1. the card's name and power limit (nvidia-smi) and the kernel build;
  2. kernels: K1 (encoder attention) in f32 and bf16 and K2 (cache block
     write, bit-exact) against their plain PyTorch versions at the
     flagship's main-path shapes, with the kernel's, the plain version's
     and one PyTorch library call's time (CUDA events, median of 25);
  3. golden: f32 compute, float32 wire, the flagship checkpoint, the 3
     golden reads (identity to the stored string must reach 0.99);
  4. serving: bf16 compute, int6 wire, batch_chunks 640, 100 simulated
     reads of 3000 bases from seed 1 (mean identity to the simulator's
     truth must reach 0.90);
  5. a `kernels` JSON line: launches during phases 3-4, errors, times;
  6. the last line: {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.abspath(__file__))
CONFIG = os.path.join(REPO, "bench_results", "config.json")
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
GOLDEN = os.path.join(REPO, "tests", "golden", "flagship_golden.json")
GOLDEN_READS = [(101, 900), (202, 2500), (303, 5200)]  # (seed, n_bases)

# H100 SXM data-sheet rates (dense): device memory, f32 on the CUDA cores,
# bf16 on the tensor cores.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}

# Kernel-vs-plain tolerances.  f32: both sides accumulate in f32 in
# another order.  bf16: one bf16 rounding step (2^-8 relative) on an
# output or on a probability that sits at a rounding boundary.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (3e-2, 2e-2)}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def cuda_ms(fn, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call of fn, in ms (CUDA events)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound(nbytes: float, flops: float, dtype) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def phase_card() -> None:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    print(res.stdout.strip().splitlines()[0])


def phase_build() -> None:
    from nanodecoder_tpu_torch.ops import _build

    t0 = time.perf_counter()
    log = _build.build(verbose=True)
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(_build.sources())} sources)")
    for line in log.splitlines():
        if "Used" in line or "Compiling entry" in line:
            print("  ptxas:", line.split("ptxas info    :")[-1].strip())


def phase_k1(dtype, dev, rng) -> dict:
    import torch.nn.functional as F

    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    b, s, h, dh = 640, 256, 2, 128
    d = h * dh
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * d), np.float32)).to(dev, dtype)
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    lengths[:3] = (0, 100, s)  # a padding row, a partial row, a full row
    lens = torch.from_numpy(lengths).to(dev)
    got = ea.flash_encoder_attention_qkv(qkv, lens, h)
    ref = ea.encoder_attention_plain(qkv, lens, h)
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"K1 {dtype}: non-finite output")
    err = (got.float() - ref.float()).abs()
    atol, rtol = K1_TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    max_err = float(err.max())
    check(ok, f"K1 {dtype}: max |kernel - plain| {max_err} over tolerance")

    q, k, v = (qkv[..., i * d:(i + 1) * d].reshape(b, s, h, dh).transpose(1, 2)
               .contiguous() for i in range(3))
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    ms = cuda_ms(lambda: ea.flash_encoder_attention_qkv(qkv, lens, h))
    plain_ms = cuda_ms(lambda: ea.encoder_attention_plain(qkv, lens, h))
    lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask))
    # Work this data needs: every query row; keys up to each row's length
    # (all S for a length-0 row, whose attention is uniform).
    n_eff = np.where(lengths > 0, lengths, s).astype(np.float64)
    flops = float(4.0 * h * s * dh * n_eff.sum())
    nbytes = qkv.numel() * qkv.element_size() + got.numel() * got.element_size() \
        + lens.numel() * 4
    bms, by = bound(nbytes, flops, dtype)
    print(f"K1 {str(dtype)[6:]}: max_abs_err {max_err:.3g}  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def phase_k2(dtype, dev) -> dict:
    from nanodecoder_tpu_torch.ops import cache_update as cu

    b, t, c = 640, 96, 256
    gen = torch.Generator(device=dev).manual_seed(2)
    cache = torch.randn(b, t, c, device=dev, generator=gen).to(dtype)
    ref = cache.clone()
    for step in range(t):
        slab = torch.randn(b, cu.BLOCK, c, device=dev, generator=gen).to(dtype)
        ref = cu.write_cache_block_plain(ref, slab, step)
        cache = cu.write_cache_block(cache, slab, step)
    torch.cuda.synchronize()
    check(torch.equal(cache, ref), f"K2 {dtype}: kernel differs from plain")
    step = 61
    t0 = (step // cu.BLOCK) * cu.BLOCK
    ms = cuda_ms(lambda: cu.write_cache_block(cache, slab, step))
    plain_ms = cuda_ms(lambda: cu.write_cache_block_plain(cache, slab, step))
    lib_ms = cuda_ms(lambda: cache[:, t0:t0 + cu.BLOCK].copy_(slab))
    bms, by = bound(2 * slab.numel() * slab.element_size(), 0.0, dtype)
    print(f"K2 {str(dtype)[6:]}: bit-exact over {t} steps  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  copy_ {lib_ms:.4f} ms  bound {bms:.4f} ms ({by})")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms}


def load_config(compute_dtype: str, h2d: str, batch_chunks: int):
    from nanodecoder_tpu_torch.config import Config

    with open(CONFIG) as f:
        cfg = Config.from_json(f.read())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype),
        decode=dataclasses.replace(cfg.decode, h2d_dtype=h2d,
                                   batch_chunks=batch_chunks))


def phase_golden(params, cfg) -> tuple[int, int]:
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.identity import read_identity
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    with open(GOLDEN) as f:
        golden = json.load(f)["reads"]
    tr = Translator(params, cfg)
    spec = SimSpec()
    levels = spec.level_table()
    exact, idents = 0, []
    for seed, n in GOLDEN_READS:
        _truth, sig = simulate_read(np.random.default_rng(seed), n, spec, levels)
        rid = f"golden_{seed}"
        bc = tr.basecall_read(RawRead(rid, sig, "sim"))
        want = golden[rid]["sequence"]
        exact += bc.sequence == want
        idents.append(read_identity(bc.sequence, want))
        check(bool(np.isfinite(bc.qualities).all())
              and len(bc.qualities) == len(bc.sequence), f"{rid}: bad qualities")
    print(f"golden f32: {exact}/3 exact, identity to golden "
          + ", ".join(f"{x:.4f}" for x in idents))
    check(min(idents) >= 0.99, f"golden identity {min(idents)} below 0.99")
    return tr.batches, tr.decode_steps


def phase_serving(params, cfg, n_reads=100, n_bases=3000) -> tuple[int, int]:
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.identity import read_identity
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    tr = Translator(params, cfg)
    spec = SimSpec()
    levels = spec.level_table()
    rng = np.random.default_rng(1)
    reads = [simulate_read(rng, n_bases, spec, levels) for _ in range(n_reads)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method="attn")
             for i, (_truth, sig) in enumerate(reads)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idents = [read_identity(bc.sequence, truth)
              for bc, (truth, _sig) in zip(calls, reads)]
    samples = sum(bc.n_samples for bc in calls)
    chunks = sum(bc.n_chunks for bc in calls)
    mean_id = float(np.mean(idents))
    print(f"serving bf16/int6/b{cfg.decode.batch_chunks}: {n_reads} reads, "
          f"{chunks} chunks, {tr.batches} batches, {tr.decode_steps} decode steps, "
          f"mean identity {mean_id:.4f} (min {min(idents):.4f}), "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s)")
    check(mean_id >= 0.90, f"serving mean identity {mean_id} below 0.90")
    return tr.batches, tr.decode_steps


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not os.path.isdir(os.path.join(REPO, "nanodecoder_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nanodecoder_tpu_torch.ops.cache_update import write_cache_block
    from nanodecoder_tpu_torch.ops.encoder_attention import flash_encoder_attention_qkv
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    dev = torch.device("cuda", 0)
    try:
        phase_card()
        phase_build()
        rng = np.random.default_rng(0)
        k1 = {dt: phase_k1(dt, dev, rng) for dt in (torch.float32, torch.bfloat16)}
        k2 = {dt: phase_k2(dt, dev) for dt in (torch.float32, torch.bfloat16)}

        golden_cfg = load_config("float32", "float32", 640)
        serve_cfg = load_config("bfloat16", "int6", 640)
        params = load_params_npz(NPZ, golden_cfg.model, device=dev)
        flash_encoder_attention_qkv.launches = 0
        write_cache_block.launches = 0
        gb, gs = phase_golden(params, golden_cfg)
        sb, ss = phase_serving(params, serve_cfg)
        launches = {"K1": flash_encoder_attention_qkv.launches,
                    "K2": write_cache_block.launches}
        batches, steps = gb + sb, gs + ss
        layers = golden_cfg.model.enc_layers
        check(launches["K1"] == layers * batches,
              f"K1 launched {launches['K1']} times for {batches} batches")
        check(launches["K2"] >= steps > 0,
              f"K2 launched {launches['K2']} times for {steps} decode steps")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def entry(name, source, replaces, stats):
        bf16, f32 = stats[torch.bfloat16], stats[torch.float32]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[name.split()[0]],
                **bf16, "dtype": "bfloat16", "float32": f32}

    kernels = [
        entry("K1 flash_encoder_attention_qkv",
              "nanodecoder_tpu_torch/csrc/encoder_attention.cu",
              "nanodecoder_tpu/ops/encoder_attention.py:154", k1),
        entry("K2 write_cache_block", "nanodecoder_tpu_torch/csrc/cache_update.cu",
              "nanodecoder_tpu/ops/cache_update.py:35", k2),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
