#!/usr/bin/env python3
"""Drive the PyTorch port (nanodecoder_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Needs one NVIDIA Hopper card, nvcc and the repository checkout around
this file; the first phase builds the kernels from nanodecoder_tpu_torch/csrc.
Phases, in order; any failure exits non-zero before the last line:

  1. the card's name and power limit (nvidia-smi) and the kernel build;
  2. kernels: K1 (encoder attention) in f32 and bf16, K2 (cache block
     write, bit-exact), K3 (beam advance) and K7 (beam top-k), both
     bit-exact in f32, against their plain PyTorch versions at the
     flagship's main-path shapes, with the kernel's, the plain version's
     and one PyTorch library call's time (CUDA events, median of 25);
  3. golden: f32 compute, float32 wire, the flagship checkpoint, the 3
     golden reads (identity to the stored string must reach 0.99);
  4. serving: bf16 compute, int6 wire, batch_chunks 640, 100 simulated
     reads of 3000 bases from seed 1 (mean identity to the simulator's
     truth must reach 0.90);
  5. beam parity: f32, float32 wire, beam 5, golden read 101 beam-called
     on the card and on the CPU (identity of the two must reach 0.99);
  6. beam serving: bf16, int6 wire, beam 5, one full batch of 256 chunks
     (1280 decode rows), then the first 20 reads of phase 4 (mean
     identity must reach 0.90);
  7. a `kernels` JSON line: launches during the greedy path (phases 3-4)
     and the beam path (phases 5-6), errors, times;
  8. the last line: {"ok": true, "device": {...}}.
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


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def beam_cases(dev, b=256, k=5, v=344):
    """Beam-step inputs at the flagship's shapes: a mid-decode step (EOS
    likely in some rows, part of the finished set filled), the first step
    (alive [0, -1e9 x4], every finished score -1e9), and all ties."""
    from nanodecoder_tpu_torch.vocab import EOS_ID

    gen = torch.Generator(device=dev).manual_seed(3)
    lp = torch.log_softmax(2 * torch.randn(b, k, v, device=dev, generator=gen), -1)
    lp[:16, :, EOS_ID] = -0.05
    alive = -torch.rand(b, k, device=dev, generator=gen).mul(9).sort(
        dim=1, descending=True).values
    fin = torch.full((b, k), -1e9, device=dev)
    fin[:, :2] = -torch.rand(b, 2, device=dev, generator=gen)
    first = torch.full((b, k), -1e9, device=dev)
    first[:, 0] = 0.0
    return {"mid": (alive, lp, fin),
            "step0": (first, lp, torch.full((b, k), -1e9, device=dev)),
            "ties": (torch.zeros_like(alive), torch.zeros_like(lp), fin)}


def phase_k3(dev) -> dict:
    from nanodecoder_tpu_torch.ops import beam_step as bs
    from nanodecoder_tpu_torch.vocab import EOS_ID

    b, k, v = 256, 5, 344
    pen = 13.0  # the avg length penalty at step 13
    cases = beam_cases(dev, b, k, v)
    for name, (alive, lp, fin) in cases.items():
        got = bs.beam_advance(alive, lp, fin, pen, k, v, EOS_ID)
        ref = bs.beam_advance_plain(alive, lp, fin, pen, k, v, EOS_ID)
        torch.cuda.synchronize()
        check(all(g.dtype == r.dtype and torch.equal(_bits(g), _bits(r))
                  for g, r in zip(got, ref)), f"K3 {name}: kernel differs from plain")
    alive, lp, fin = cases["mid"]
    flat = (alive[:, :, None] + lp).reshape(b, k * v)
    ms = cuda_ms(lambda: bs.beam_advance(alive, lp, fin, pen, k, v, EOS_ID))
    plain_ms = cuda_ms(lambda: bs.beam_advance_plain(alive, lp, fin, pen, k, v, EOS_ID))
    lib_ms = cuda_ms(lambda: torch.topk(flat, 2 * k, dim=1))
    # Read alive, log-probs and finished once; write the five outputs.
    nbytes = 4 * (b * k + b * k * v + b * k) + 4 * (b * 2 * k + 4 * b * k)
    # The add, 2K block-wide argmax rounds over K*V, two small picks.
    flops = float(b * k * v * (1 + 2 * k) + b * (2 * k * k + 3 * k * k))
    bms, by = bound(nbytes, flops, torch.float32)
    print(f"K3 float32: bit-exact on {len(cases)} cases (mid-decode, step 0 with "
          f"an all -1e9 finished set, all ties)  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  topk(2K) {lib_ms:.4f} ms  bound {bms:.4f} ms ({by}; "
          f"a launch costs more: launch- and latency-bound)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def phase_k7(dev) -> dict:
    from nanodecoder_tpu_torch.ops import beam_step as bs

    b, k, v, n_out = 256, 5, 344, 10
    cases = beam_cases(dev, b, k, v)
    for name, (alive, lp, _fin) in cases.items():
        s, i = bs.beam_topk(alive, lp, n_out)
        rs, ri = bs.beam_topk_plain(alive, lp, n_out)
        torch.cuda.synchronize()
        check(torch.equal(_bits(s), _bits(rs)) and torch.equal(i, ri),
              f"K7 {name}: kernel differs from plain")
    alive, lp, _fin = cases["mid"]
    flat = (alive[:, :, None] + lp).reshape(b, k * v)
    ms = cuda_ms(lambda: bs.beam_topk(alive, lp, n_out))
    plain_ms = cuda_ms(lambda: bs.beam_topk_plain(alive, lp, n_out))
    lib_ms = cuda_ms(lambda: torch.topk(flat, n_out, dim=1))
    nbytes = 4 * (b * k + b * k * v) + 8 * b * n_out
    bms, by = bound(nbytes, float(b * k * v * (1 + n_out)), torch.float32)
    print(f"K7 float32: bit-exact on {len(cases)} cases  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  topk({n_out}) {lib_ms:.4f} ms  bound {bms:.4f} ms "
          f"({by}; launch- and latency-bound)")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms}


def load_config(compute_dtype: str, h2d: str, batch_chunks: int, **decode):
    from nanodecoder_tpu_torch.config import Config

    with open(CONFIG) as f:
        cfg = Config.from_json(f.read())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype),
        decode=dataclasses.replace(cfg.decode, h2d_dtype=h2d,
                                   batch_chunks=batch_chunks, **decode))


def simulated_reads(n_reads: int, n_bases: int = 3000):
    """The first n_reads simulated reads of seed 1 (truth, signal)."""
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    spec = SimSpec()
    levels = spec.level_table()
    rng = np.random.default_rng(1)
    return [simulate_read(rng, n_bases, spec, levels) for _ in range(n_reads)]


def call_reads(tr, reads) -> tuple[list[float], int, float]:
    """Basecall reads (attn stitch): (identities, samples, wall seconds)."""
    from nanodecoder_tpu_torch.identity import read_identity
    from nanodecoder_tpu_torch.io.fast5 import RawRead

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method="attn")
             for i, (_truth, sig) in enumerate(reads)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idents = [read_identity(bc.sequence, truth)
              for bc, (truth, _sig) in zip(calls, reads)]
    return idents, sum(bc.n_samples for bc in calls), wall


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


def phase_serving(params, cfg, n_reads=100):
    """Returns (batches, decode steps, per-read identities)."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    tr = Translator(params, cfg)
    idents, samples, wall = call_reads(tr, simulated_reads(n_reads))
    mean_id = float(np.mean(idents))
    print(f"serving bf16/int6/b{cfg.decode.batch_chunks}: {n_reads} reads, "
          f"{tr.batches} batches, {tr.decode_steps} decode steps, "
          f"mean identity {mean_id:.4f} (min {min(idents):.4f}), "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s)")
    check(mean_id >= 0.90, f"serving mean identity {mean_id} below 0.90")
    return tr.batches, tr.decode_steps, idents


def phase_beam_parity(params, cfg) -> tuple[int, int]:
    """Golden read 101 beam-called on the card and on the CPU."""
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.identity import read_identity
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    spec = SimSpec()
    _truth, sig = simulate_read(np.random.default_rng(101), 900, spec,
                                spec.level_table())
    tr = Translator(params, cfg)
    cpu = Translator(params, cfg, device="cpu")
    got = tr.basecall_read(RawRead("golden_101", sig, "sim"))
    ref = cpu.basecall_read(RawRead("golden_101", sig, "sim"))
    ident = read_identity(got.sequence, ref.sequence)
    print(f"beam parity f32/K{cfg.decode.beam_size}: golden_101 card vs CPU "
          f"{'exact' if got.sequence == ref.sequence else 'not exact'}, identity "
          f"{ident:.4f} ({len(got.sequence)} / {len(ref.sequence)} bases, "
          f"{tr.decode_steps} decode steps; GPU f32 sums run in another order)")
    check(bool(np.isfinite(got.qualities).all())
          and len(got.qualities) == len(got.sequence), "beam parity: bad qualities")
    check(ident >= 0.99, f"beam parity identity {ident} below 0.99")
    return tr.batches, tr.decode_steps


def phase_beam_serving(params, cfg, greedy_idents, n_reads=20):
    """One full beam batch, then the first n_reads reads of phase 4."""
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal

    tr = Translator(params, cfg)
    bsz = cfg.decode.effective_batch_chunks()
    scfg = cfg.signal
    chunks, lengths = [], []
    reads = iter(simulated_reads(40))
    while sum(c.shape[0] for c in chunks) < bsz:
        cb = chunk_signal(normalize_signal(next(reads)[1], scfg.normalization,
                                           scfg.mad_scale, scfg.clip_sigma),
                          scfg.chunk_len, scfg.chunk_overlap, scfg.min_chunk_fill)
        chunks.append(cb.chunks)
        lengths.append(cb.lengths)
    chunks = np.concatenate(chunks)[:bsz]
    lengths = np.concatenate(lengths)[:bsz]
    tr.decode_chunk_batch(chunks, lengths)  # warm-up
    steps0 = tr.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.decode_chunk_batch(chunks, lengths)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = tr.decode_steps - steps0
    check(out[0].shape[0] == bsz and bool((out[1] > 0).all()),
          "beam batch: missing or empty hypotheses")
    print(f"beam batch bf16/int6: {bsz} chunks x K{cfg.decode.beam_size} = "
          f"{bsz * cfg.decode.beam_size} rows, wall {wall_ms:.1f} ms, {steps} decode "
          f"steps, {wall_ms / max(steps, 1):.3f} ms/step")
    idents, samples, wall = call_reads(tr, simulated_reads(n_reads))
    mean_id = float(np.mean(idents))
    greedy = float(np.mean(greedy_idents[:n_reads]))
    print(f"beam serving bf16/int6/b{bsz}/K{cfg.decode.beam_size}: {n_reads} reads, "
          f"mean identity {mean_id:.4f} (min {min(idents):.4f}), greedy on the same "
          f"reads {greedy:.4f} (difference {mean_id - greedy:+.4f}), "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s)")
    check(mean_id >= 0.90, f"beam serving mean identity {mean_id} below 0.90")
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
    from nanodecoder_tpu_torch.ops.beam_step import beam_advance, beam_topk
    from nanodecoder_tpu_torch.ops.cache_update import write_cache_block
    from nanodecoder_tpu_torch.ops.encoder_attention import flash_encoder_attention_qkv
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    wrappers = {"K1": flash_encoder_attention_qkv, "K2": write_cache_block,
                "K3": beam_advance, "K7": beam_topk}

    def reset():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {name: fn.launches for name, fn in wrappers.items()}

    dev = torch.device("cuda", 0)
    try:
        phase_card()
        phase_build()
        rng = np.random.default_rng(0)
        k1 = {dt: phase_k1(dt, dev, rng) for dt in (torch.float32, torch.bfloat16)}
        k2 = {dt: phase_k2(dt, dev) for dt in (torch.float32, torch.bfloat16)}
        k3, k7 = phase_k3(dev), phase_k7(dev)

        golden_cfg = load_config("float32", "float32", 640)
        serve_cfg = load_config("bfloat16", "int6", 640)
        params = load_params_npz(NPZ, golden_cfg.model, device=dev)
        layers = golden_cfg.model.enc_layers

        reset()  # the greedy path: phases 3-4
        gb, gs = phase_golden(params, golden_cfg)
        sb, ss, greedy_idents = phase_serving(params, serve_cfg)
        greedy = counts()
        batches, steps = gb + sb, gs + ss
        check(greedy["K1"] == layers * batches,
              f"K1 launched {greedy['K1']} times for {batches} greedy batches")
        check(greedy["K2"] >= steps > 0,
              f"K2 launched {greedy['K2']} times for {steps} greedy decode steps")

        beam = {"mode": "beam", "beam_size": 5, "batch_chunks_beam": 256}
        reset()  # the beam path: phases 5-6
        pb, ps = phase_beam_parity(params, load_config(
            "float32", "float32", 640, **{**beam, "batch_chunks_beam": 8}))
        bb, bsteps = phase_beam_serving(params, load_config("bfloat16", "int6", 640,
                                                            **beam), greedy_idents)
        beamc = counts()
        batches, steps = pb + bb, ps + bsteps
        check(beamc["K1"] == layers * batches,
              f"K1 launched {beamc['K1']} times for {batches} beam batches")
        check(beamc["K2"] >= steps > 0,
              f"K2 launched {beamc['K2']} times for {steps} beam decode steps")
        check(beamc["K3"] == steps,
              f"K3 launched {beamc['K3']} times for {steps} beam decode steps")
        check(greedy["K3"] == greedy["K7"] == beamc["K7"] == 0,
              "a beam kernel launched where no path runs it")
        print(f"launches: greedy path {greedy}, beam path {beamc}")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def entry(name, source, replaces, stats, note=""):
        key = name.split()[0]
        by_path = {"greedy": greedy[key], "beam": beamc[key]}
        if torch.float32 in stats:
            stats = {**stats[torch.bfloat16], "dtype": "bfloat16",
                     "float32": stats[torch.float32]}
        else:
            stats = {**stats, "dtype": "float32"}
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path, **stats}
        return {**out, "note": note} if note else out

    kernels = [
        entry("K1 flash_encoder_attention_qkv",
              "nanodecoder_tpu_torch/csrc/encoder_attention.cu",
              "nanodecoder_tpu/ops/encoder_attention.py:154", k1),
        entry("K2 write_cache_block", "nanodecoder_tpu_torch/csrc/cache_update.cu",
              "nanodecoder_tpu/ops/cache_update.py:35", k2),
        entry("K3 beam_advance", "nanodecoder_tpu_torch/csrc/beam_step.cu",
              "nanodecoder_tpu/ops/beam_step.py:68", k3,
              "one launch per beam decode step"),
        entry("K7 beam_topk", "nanodecoder_tpu_torch/csrc/beam_step.cu",
              "nanodecoder_tpu/ops/beam_step.py:37", k7,
              "on no serving path (its only JAX caller is a test); launched only "
              "in phase 2"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
