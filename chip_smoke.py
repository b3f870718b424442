#!/usr/bin/env python3
"""Drive the PyTorch port (nanodecoder_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --kernels K4a,K3,K2,K7 [--root DIR]

Needs one NVIDIA Hopper card, nvcc and the repository checkout around
this file; the first phase builds the kernels from nanodecoder_tpu_torch/csrc.
Phases, in order; any failure exits non-zero before the last line:

  1. the card's name and power limit (nvidia-smi), the kernel build and
     the launch floor (an empty kernel's device-only time);
  2. kernels, each against its plain PyTorch version at the main path's
     shapes, with the kernel's, the plain version's and one PyTorch
     library call's time (CUDA events, median of 25) beside its bound and
     the bound's share of the kernel's time.  The per-call time includes
     the wrapper's host dispatch (tens of microseconds of Python), so
     every kernel and its library call are also timed device-only: N
     calls (10 for the encoder attention, 50 for K4a/K4b, 100 for the
     short kernels) captured into one CUDA graph, its replay over N; K2
     and K4a/K4b cycle through input sets of at least 100 MB in all, so
     their inputs come cold from device memory, as in a serving step:
     K1 (encoder attention on the QKV slab), K5 and K6 (the same on
     separate q/k/v and on the (B, S, H, Dh) layout) in f32 and bf16;
     K2 (cache block write, bit-exact) at the MQA and the MHA self-cache
     widths; K3 (beam advance) and K7 (beam top-k), bit-exact in f32 on
     six input cases (mid-decode, first step, ties, all below -1e9, fewer
     than 2K above -1e9, -inf log-probs), at V 344 and V 8;
     K4a (decode attention, B 640) and K4b (grouped, B 256 x G 5) in
     f32, bf16 and int8, and K4a on GQA caches (1 and 2 KV heads);
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
  7. lean MHA: the flagship in MHA form (every decoder K/V projection
     tiled across the 8 heads, the same function) through K4a/K4b:
     golden f32 (0.99), 20 reads bf16/int6 (0.90), the same with int8
     cross caches (0.90, the gap to exact printed), beam 5 f32 on golden
     read 101 (0.99 to phase 5's card call) and one full beam batch;
  8. unfolded MHA (lean_step false: K5 encoder, per-layer self caches):
     golden f32 (0.99), 20 reads bf16/int6 (0.90), beam 5 f32 on golden
     read 101 (0.99 to phase 5's card call);
  9. without kernels: the flagship with use_pallas false (the plain
     PyTorch route, the JAX package's XLA path): golden f32 (0.99) and
     beam 5 f32 on golden read 101 (0.99 to phase 5's card call); no
     kernel but K2 (which the lean step runs whatever the flag) launches;
 10. wide shapes: K4a, K4b and K1/K5/K6 at shapes the earlier kernels
     refused (Dh 8 to 512, D 384 to 2048, groups 9 to 16, GQA in K4b, 16
     query heads per KV head, f32 encoder attention at S 2048 and 4096,
     32 heads x T 1800 in K4a/K4b, MHA and GQA, whose scores overflow
     shared memory), K1/K5 on operands not 16-byte aligned, K1 at B 65540
     and K2 on a batch row's block of 2^31 + 8 bytes, each against its
     plain version at phase 2's tolerances (K2 bit for bit against
     copy_), with the kernel each ran (fast, padded or scalar);
 11. tiny: the JAX package's tiny_test_config with random params,
     greedy and beam 5, lean and unfolded, by the kernel route (its
     kernels counted) against the plain route on the card (0.99);
 12. engine: the streaming engine on signal files written to a temporary
     directory (fast5 where h5py imports, else pod5 where pyarrow,
     zstandard and flatbuffers do, else .npz through a substitute
     reader): the golden reads in f32, trim stitch (0.99; this run
     also starts the ingest pool), greedy bf16/int6 at 512-chunk batches
     on 200 simulated reads (every read back once; mean identity 0.90 to
     the truth, 0.99 to phase 4's Translator calls), beam 5 on 20 reads
     at 256-chunk batches (0.90, K3 launched), with real rows per batch,
     ksamples/s and the stage split; then the basecall CLI once as a
     subprocess on 20 reads (one FASTQ record a read); the ingest pool,
     its forkserver and the resource tracker are stopped and waited for,
     and the run fails if any child process is still running;
 13. train: the flagship at full width with the committed train section
     (cosine, lr 3e-4, label smoothing 0.1, guided attention 0.3, dropout
     0.1), use_pallas true and TRAIN_OVERRIDES (warmup 10, train_steps
     60): (a) two Adam steps at a constant lr 4e-5 from the flagship
     params at dropout 0, batch 8, f32 without TF32, on the card and on
     the CPU, each step from the card's state (losses within rtol 1e-4;
     the FFN ReLU inputs that fall on the other side of 0 on the card
     printed; gradients within rtol 1e-4 / atol 1e-6 in all but 0.1% of the
     elements and each tensor within 1e-3 of its norm; the card's params
     within 1e-6 of the host's update on the card's gradients, within
     1e-4 of the CPU's, and within 1e-5 but for the elements the
     gradients' tolerance did not hold or under 1e-6, under 10%), then
     one more such step at dropout 0.1 (both trainers key their masks
     from PRNGKey(train.seed), so the card's R1 draws the CPU's masks and
     the same gates hold); (b) 50 steps from init_model(PRNGKey(0)),
     f32, batch 32, behind prefetch_batches (every loss finite, the mean
     of the last 10 below that of the first 10; median step ms, chunks/s,
     ksamples/s, target tokens/s, peak memory, the host's wait for data;
     3 more steps under torch.profiler: device busy ms, idle share,
     kernels a step, the costliest kernels), then 10 bf16 steps
     (finite), all at the committed dropout 0.1; (b)'s trainers capture
     their step as a CUDA graph at the second step and replay it after,
     (a)'s are held eager; the training steps launch no kernel but R1,
     one launch a dropout draw (3 an encoder layer, 4 a decoder layer) of
     each step that is not replayed (an eager step, a capture);
     (c) validation of (a)'s params on 4 batches of 32 with K5 and
     without (K5 launches
     6 x 4 and 0, xent_sum within rtol 1e-4, n_correct within 0.1% of
     the tokens, the ms of each); (d) (a)'s trainer saved, restored into
     a fresh trainer, one more step on each (within 1e-6), the restored
     params served by Translator (bf16/int6, K1 and K2) on the first 20
     reads of phase 4 (mean identity 0.90); (e) cli.preprocess
     --synthetic, cli.train --data 5 steps, --resume to 8, cli.evaluate
     on the checkpoint directory, as subprocesses (exit 0, checkpoints 5
     and 8, 2 reads evaluated);
 14. rnn: the recurrent family at the RNN flagship's widths (the
     committed config with encoder_type lstm and decoder_type rnn,
     "general" Luong attention), random params from seed 14 (generator
     and the RNN decoder's LSTM weights scaled 3x), each card result
     against the port's own CPU run on the same params and inputs:
     (a) f32, float32 wire: greedy on the 3 golden reads' signals
     (identity >= 0.99 on each, the share of chunks with equal tokens
     printed, some bases called), beam 5 on golden read 101 (0.99, K3),
     greedy on read 101 with dot and mlp attention (0.99); (b) bf16,
     int6 wire, batch 640: greedy on the first 20 reads of phase 4
     (every read a finite score; ksamples/s), one full batch timed apart
     (encode ms with its sequential LSTM cell steps, decode ms and steps),
     one full beam batch of 256 chunks x 5; (c) the hybrids, f32, greedy
     on the golden reads and beam 5 on read 101 (0.99): transformer
     encoder + RNN decoder (lean, K1) and biLSTM encoder + MQA
     transformer decoder (lean, K2); (d) training (lstm, rnn): phase 13
     (a)'s parity and gates from the random params, then 10 steps at batch
     32 from init_model (finite losses, median step ms, peak memory),
     launching no kernel; (e) the importer: a synthetic OpenNMT
     state_dict (biLSTM encoder + MQA transformer decoder) saved as a .pt
     and loaded by load_torch_checkpoint onto the card and the CPU,
     greedy on the golden reads (0.99); (f) the streaming engine with
     (b)'s params at 256-chunk batches on (b)'s 20 reads (every read back
     once, mean identity to (b)'s Translator calls 0.99); its wall time;
 15. decode modes on the MQA flagship, kernel route: (a) sample mode at
     topk 1, f32, on the 3 golden reads: tokens equal to the card's
     greedy call; (b) sample at temperature 1.0, topk 5, topp 0.9, f32,
     32-chunk batches, from one sampling_seed on the card (R1 draws the
     noise) and on the CPU (its plain version): tokens equal on each
     golden read whose winning draws all lead by more than 1e-5 (the
     CPU's leads recorded), identity >= 0.99 on each; (c) served sample
     mode (bf16, int6 wire, batch 640) at temperature 0.3 on phase 4's
     first 20 reads: mean identity
     no more than 0.02 under greedy's on the same reads, the seed again
     gives the same calls (5 reads), another seed other calls;
     temperature 1.0 printed on 10 of the reads, not gated; greedy and
     sample ms per decode step on one 640-chunk batch, in turns; (d) the
     engine in sample mode at topk 1 on those 20 reads: mean identity
     >= 0.99 to its greedy calls; (e) the path-indirection beam reorder
     flag (which the port runs as the physical reorder), beam 5, on
     read 101 (f32, 8-chunk batches) and on a 256 x 5 bf16/int6 batch: tokens and
     lengths equal to the physical reorder, ms per step of both ways in
     turns; (f) the coverage penalty ("wu" and "summary", beta 0.2), beam
     5: card vs CPU identity >= 0.99 on read 101 (f32), (e)'s batch with
     ms per step and at least one best score that differs from beta 0,
     and 20 served reads at mean identity >= 0.90 ("summary") and >= 0.85
     ("wu", which pays hypotheses for length; COVERAGE_MIN_IDENTITY);
     (g) launches of each mode's own runs (ModeRuns): sample K1, K2 and
     R1 (one a decode step), path_reorder K1, K2 and K3 (one a step),
     coverage K1 only (0 of K2 and K3);
 16. the host tier and data parallelism: (a) the native host library
     (built with g++ in phase 1, where the run fails if it does not
     load) is loaded from the build directory; (b) its edit distance and
     overlap scorer equal the numpy versions on 1000 random pairs, and
     its read identity equals numpy's on phase 4's pairs; the seconds
     read identity took in phases 3-15 (native), numpy's estimated from
     10 of those calls timed serially, and per read on 3 of phase 4's
     reads, numpy and native, serially; (c) a NCCL group of
     one rank: the streaming engine with a mesh plan on 20 reads (bf16,
     int6 wire, 512-chunk batches) gives FASTQ byte-equal to the engine
     without one; (d) two ranks sharing the card (subprocesses; gloo,
     which the bootstrap picks where ranks outnumber cards): which
     collectives gloo takes on CUDA tensors of each dtype; a greedy batch
     of 640 chunks and a beam-5 batch of 256 chunks of the MQA flagship
     (f32, kernel route) sharded over the ranks against one rank's call
     (every chunk's identity >= 0.99; the count of exactly equal chunks
     printed); phase 13 (a)'s data-parallel Adam steps at batch 8 (two at
     dropout 0, then one at dropout 0.1 from the flagship params, each
     rank drawing its rows of the masks) each held to one rank's step from
     the same state and key at phase 13 (a)'s tolerances; the gather ms of a batch and the gradient
     all-reduce ms of a step; each rank's launches (K1, K2, K3, R1 once a
     draw);
     then the basecall CLI at world 2 on 20 reads in 4 files: every read
     exactly once in the merged FASTQ, no shard left; (e) no child process
     left; (f) utils.profiling.device_trace writes a Chrome trace of one
     batch; the phase's wall;
 17. orbax: the JAX package's orbax checkpoint directory (the committed
     tests/golden/jax_orbax_tiny: the tiny config after 3 Adam steps
     with clip, written by scripts/make_orbax_fixture.py), read without
     JAX through the native zstd library (built in phase 1; no
     fallback): (a) the TrainState read on the host bit-equal to the JAX
     package's restore (tests/golden/jax_orbax_tiny_expected.npz):
     params, mu, nu, count, step; its seconds (first and median of 3)
     and MB/s of files; (b) load_params_and_config onto the card, kernel
     route, f32: greedy and beam 5 on 4 reads made as phase 11 makes
     them, equal to the same calls on the npz export's params (K1, K2,
     K4a; K1, K2, K3, K4b launched); the basecall CLI (--parity, .npz
     signal files) with --ckpt the orbax directory byte-equal to the same
     CLI on the npz export, and the evaluate CLI's JSON equal on both;
     (c) cli.train --resume 3 -> 5 on the card from a copy of the
     directory and from the port-format copy of the same state: params
     within 1e-6, the JAX step's files hashed unchanged; (d) with the
     zstd library unbuildable the read raises ZstdUnavailable; the
     phase's wall;
 18. prng: kernel R1 (threefry2x32 draws) against JAX's draws in the
     committed tests/golden/jax_prng.npz (scripts/make_prng_fixture.py)
     and its plain version on the card: bits, uniform and bernoulli at
     2^24 draws from counter 0 and from past 2^32, exact; normal within 4
     ulps and gumbel within 2e-6 of JAX's; then the bernoulli masks of a
     flagship train step (32 x 256 x 256 and x 1024, 32 x 96 x 256 and x
     1024) timed per call and device-only beside their bound (the built
     kernel's SASS instructions per element on the SM's busiest pipe at
     the card's SM count and highest clock, mask bytes against 3.35 TB/s),
     the plain version and torch.rand, and the table-keyed kernel (its key
     read from a device key table, as the train step's captured graph
     draws) beside the scalar-keyed one, equal to it, per call and
     device-only; R1 launched on the train, sample, dp_rank0 and dp_rank1
     paths and on no other;
 19. a `kernels` JSON line: launches on each path (greedy, phases 3-4;
     beam, 5-6; mha, 7; unfolded, 8; no_pallas, 9; tiny, 11; engine,
     12; train, 13 (a)-(c); train_serve, 13 (d); rnn, 14 (a)-(b);
     rnn_hybrid, 14 (c); rnn_train, 14 (d); rnn_import, 14 (e);
     rnn_engine, 14 (f); sample, path_reorder and coverage, 15; dp_nccl,
     16 (c); dp_rank0 and dp_rank1, 16 (d), counted in each rank's
     process; orbax, 17 (b) in this process), K4a's and K4b's launches of
     the scalar decode-attention kernel apart (none on phases 3-9),
     errors, times; R1's times at the train step's mask shapes;
 20. the last line: {"ok": true, "device": {...}}.

`--kernels` runs phase 1 and the named kernels' phase 2 only (R1: its
phase 18) and prints their numbers as one JSON line; with `--root` it imports (and builds) the
package of another checkout, such as an older tree unpacked into a
git-ignored directory, to compare two versions in one call.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import importlib
import io
import json
import math
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
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
# Device-only times of the bytes-bound kernels cycle through input sets
# holding at least this much, twice the L2 (graph_ms).
COLD_BYTES = 100e6

# Kernel-vs-plain tolerances (atol, rtol).  f32: both sides accumulate in
# f32 in another order.  bf16: one bf16 rounding step (2^-8 relative) on
# an output or on a probability that sits at a rounding boundary.  int8:
# f32 sums of integers up to 127 in another order, then scaled.
K1_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (3e-2, 2e-2)}
K4_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2), "int8": (2e-5, 1e-5)}


class SmokeError(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeError(msg)


def live_children() -> list[str]:
    """The command lines of this process's children that are still running
    (zombies aside), read from /proc."""
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
            with open(f"/proc/{pid}/cmdline") as f:
                cmd = f.read().replace("\0", " ").strip()
        except OSError:
            continue
        if int(ppid) == os.getpid() and state != "Z":
            found.append(f"{pid}: {cmd[:120]}")
    return found


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


def graph_ms(fns, n: int = 100, reps: int = 10) -> float:
    """Device time of one call without host dispatch, in ms: n calls
    captured back to back into one CUDA graph, its replay timed with CUDA
    events (median of reps), over n.  `fns` is one callable or a list of
    them, each on its own set of inputs; the captured calls cycle through
    the list, so a list whose sets together exceed the 50 MB L2 times the
    kernel with its inputs cold, as a serving step finds them."""
    fns = fns if isinstance(fns, (list, tuple)) else [fns]
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for fn in fns:
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, capture_error_mode="thread_local"):
        for i in range(n):
            fns[i % len(fns)]()
    return cuda_ms(graph.replay, reps=reps, warmup=1) / n


def n_sets(set_bytes: float) -> int:
    """Input sets for graph_ms so that they hold at least COLD_BYTES."""
    return max(1, math.ceil(COLD_BYTES / set_bytes))


def phase_floor() -> float:
    """The launch floor: an empty kernel's device-only time (graph_ms)."""
    from nanodecoder_tpu_torch.ops import _build

    lib = _build.load()
    ms = graph_ms(lambda: _build.check(lib.nd_empty_kernel(
        torch.cuda.current_stream().cuda_stream), "empty kernel"))
    print(f"launch floor (an empty kernel, device only, CUDA graph): {ms:.4f} ms")
    return ms


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

    from nanodecoder_tpu_torch import native
    from nanodecoder_tpu_torch.native import zstd

    t0 = time.perf_counter()
    log = _build.build(verbose=True)
    _build.load()
    print(f"kernel build: {time.perf_counter() - t0:.1f} s "
          f"({len(_build.sources())} sources)")
    t0 = time.perf_counter()
    check(native.load() is not None, "the native host library (g++) did not build or "
          "load: read identity would run its numpy version")
    print(f"native host library build or load: {time.perf_counter() - t0:.1f} s "
          f"({native.LIBRARY_NAME} in {_build.build_dir()})")
    t0 = time.perf_counter()
    try:
        zstd.load()
    except zstd.ZstdUnavailable as e:
        raise SmokeError(str(e)) from e
    print(f"native zstd library build or load: {time.perf_counter() - t0:.1f} s "
          f"({zstd.LIBRARY_NAME}; phase 17 reads orbax checkpoints with it, no fallback)")
    # One line per kernel: its mangled name without the namespace prefix,
    # registers and spills (shared memory is dynamic, sized at launch).
    lines = log.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry" in line:
            name = re.sub(r"^_ZN\d+_GLOBAL__N__\w+?_cu_[0-9a-f]+\d+", "",
                          line.split("'")[1])
            info = [x.split(":")[-1].strip() for x in lines[i + 1:i + 4]
                    if "Used" in x or "spill" in x]
            print("  ptxas:", name[:60], "|", " | ".join(info))


def enc_bound(qkv, lengths) -> tuple[float, str]:
    """Bound of one encoder attention call on the (B, S, 3D) qkv: read
    once, the (B, S, D) output written once, the lengths; every query row
    against the keys up to its row's length (all S for a length-0 row,
    whose attention is uniform), 4 operations per lane."""
    b, s, d3 = qkv.shape
    n_eff = np.where(lengths > 0, lengths, s).astype(np.float64)
    flops = float(4.0 * s * (d3 // 3) * n_eff.sum())
    nbytes = qkv.numel() * qkv.element_size() * 4 / 3 + b * 4
    return bound(nbytes, flops, qkv.dtype)


def phase_enc_attn(name, dtype, dev, rng) -> dict:
    """K1 (QKV slab), K5 (separate q/k/v) or K6 ((B, S, H, Dh)) at the
    flagship encoder's shape."""
    import torch.nn.functional as F

    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    b, s, h, dh = 640, 256, 2, 128
    d = h * dh
    qkv = torch.from_numpy(rng.standard_normal((b, s, 3 * d), np.float32)).to(dev, dtype)
    lengths = rng.integers(1, s + 1, size=b).astype(np.int32)
    lengths[:3] = (0, 100, s)  # a padding row, a partial row, a full row
    lens = torch.from_numpy(lengths).to(dev)
    q, k, v = (qkv[..., i * d:(i + 1) * d].contiguous() for i in range(3))
    heads = [x.view(b, s, h, dh) for x in (q, k, v)]
    if name == "K1":
        run = lambda: ea.flash_encoder_attention_qkv(qkv, lens, h)  # noqa: E731
        plain = lambda: ea.encoder_attention_plain(qkv, lens, h)  # noqa: E731
    elif name == "K5":
        run = lambda: ea.flash_encoder_attention_nld(q, k, v, lens, h)  # noqa: E731
        plain = lambda: ea.encoder_attention_nld_plain(q, k, v, lens, h)  # noqa: E731
    else:
        run = lambda: ea.flash_encoder_attention(*heads, lens)  # noqa: E731
        plain = lambda: ea.encoder_attention_heads_plain(*heads, lens)  # noqa: E731
    got, ref = run(), plain()
    torch.cuda.synchronize()
    check(bool(torch.isfinite(got).all()), f"{name} {dtype}: non-finite output")
    err = (got.float() - ref.float()).abs()
    atol, rtol = K1_TOL[dtype]
    ok = bool((err <= atol + rtol * ref.float().abs()).all())
    max_err = float(err.max())
    check(ok, f"{name} {dtype}: max |kernel - plain| {max_err} over tolerance")

    qt, kt, vt = (x.transpose(1, 2).contiguous() for x in heads)
    mask = (torch.arange(s, device=dev)[None, :] < lens[:, None])[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask)  # noqa: E731
    ms = cuda_ms(run)
    plain_ms = cuda_ms(plain)
    lib_ms = cuda_ms(sdpa)
    g_ms, g_lib = graph_ms(run, 10), graph_ms(sdpa, 10)
    bms, by = enc_bound(qkv, lengths)
    print(f"{name} {str(dtype)[6:]}: max_abs_err {max_err:.3g}  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  sdpa {lib_ms:.4f} ms  bound {bms:.4f} ms ({by}); "
          f"device only (CUDA graph): kernel {g_ms:.4f} ms  sdpa {g_lib:.4f} ms, bound "
          f"share {bms / g_ms:.3f}, kernel / sdpa {g_ms / g_lib:.3f}")
    out = {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
           "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
           "graph_ms": g_ms, "library_graph_ms": g_lib}
    if name == "K1":
        # Device time against the keys each row needs: every length 1, 64
        # (one 64-key tile) and 256 (no key skipped).
        sweep = {}
        for n in (1, 64, 256):
            lens_n = torch.full((b,), n, dtype=torch.int32, device=dev)
            mask_n = (torch.arange(s, device=dev) < n)[None, None, None, :]
            sweep[str(n)] = [
                graph_ms(lambda: ea.flash_encoder_attention_qkv(qkv, lens_n, h), 10),
                graph_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                attn_mask=mask_n), 10)]
        print(f"{name} {str(dtype)[6:]} device only by length (kernel / sdpa ms): "
              + ", ".join(f"all {n}: {k:.4f} / {l:.4f}" for n, (k, l) in sweep.items()))
        out["graph_ms_by_length"] = {n: k for n, (k, _l) in sweep.items()}
        out["library_graph_ms_by_length"] = {n: l for n, (_k, l) in sweep.items()}
    return out


def head_sum_gap(q, k, lens, heads, group, row, t_a, t_b, k_scale=None) -> float:
    """Relative gap, in f64, between the head-summed attention
    probabilities of query row `row` at positions t_a and t_b (k may hold
    fewer KV heads than q has heads)."""
    bi = row // group
    qq = q[row].double() * (k_scale[bi].double() if k_scale is not None else 1.0)
    t, dh = k.shape[1], q.shape[1] // heads
    n_kv = k.shape[2] // dh
    kh = k[bi].double().view(t, n_kv, dh).repeat_interleave(heads // n_kv, dim=1)
    s = (kh * qq.view(1, heads, dh)).sum(-1) / dh ** 0.5
    n = int(lens[bi])
    if n > 0:
        s[n:] = -1e9
    p = torch.softmax(s, dim=0).sum(dim=1)
    return float((p[t_a] - p[t_b]).abs() / p.max())


def k4_inputs(kind: str, b: int, group: int, t: int, h: int, dh: int, n_kv: int, dev,
              rng) -> tuple:
    """One input set of the MHA flagship's cross attention: (q, k, v, lens,
    lengths, scales).  Most chunks full, the last chunk of a read partial,
    batch padding rows 0."""
    from nanodecoder_tpu_torch.ops import attention as at

    d = h * dh
    qdt = torch.float32 if kind == "int8" else getattr(torch, kind)
    q = torch.from_numpy(rng.standard_normal((b * group, d), np.float32)).to(dev, qdt)
    kf, vf = (torch.from_numpy(rng.standard_normal((b, t, n_kv * dh), np.float32)).to(dev)
              for _ in range(2))
    lengths = np.full(b, t, np.int32)
    lengths[3::16] = rng.integers(1, t + 1, size=len(lengths[3::16]))
    head = (0, 100, t)[:b]
    lengths[:len(head)] = head
    lens = torch.from_numpy(lengths).to(dev)
    if kind == "int8":
        (k, ks), (v, vs) = at.quantize_cache_int8(kf), at.quantize_cache_int8(vf)
        return q, k, v, lens, lengths, {"k_scale": ks, "v_scale": vs}
    return q, kf.to(qdt), vf.to(qdt), lens, lengths, {}


def check_k4(name, kind, out, amax, rout, ramax, q, k, lens, h, group,
             scales) -> tuple[float, int]:
    """Kernel against plain: outputs within K4_TOL, attention positions
    equal except at a near-tie of the head sums (the two sides sum exp in
    another order).  Returns the largest |error| and the near-ties."""
    check(bool(torch.isfinite(out).all()), f"{name} {kind}: non-finite output")
    err = (out.float() - rout.float()).abs()
    atol, rtol = K4_TOL[kind]
    max_err = float(err.max())
    check(bool((err <= atol + rtol * rout.float().abs()).all()),
          f"{name} {kind}: max |kernel - plain| {max_err} over tolerance")
    bad = (amax != ramax).nonzero()[:, 0].tolist()
    check(len(bad) <= max(1, amax.numel() // 1000),
          f"{name} {kind}: {len(bad)} attention positions differ")
    for row in bad:
        gap = head_sum_gap(q.float(), k.float(), lens, h, group, row, int(amax[row]),
                           int(ramax[row]), scales.get("k_scale"))
        check(gap < 1e-5, f"{name} {kind}: row {row} position differs, gap {gap}")
    return max_err, len(bad)


def k4_bound(q, k, lengths, group: int, scales) -> tuple[float, str]:
    """Bound of one K4a/K4b call on these inputs: the cache rows below each
    chunk's length (all T for a length-0 row) read once for the chunk's
    `group` queries, q read and the output written, the lengths, the
    positions and any int8 scales; 4 operations per query lane and row."""
    b, t, dk = k.shape
    d = q.shape[1]
    n_eff = float(np.where(lengths > 0, lengths, t).astype(np.float64).sum())
    nbytes = 2 * n_eff * dk * k.element_size() + 2 * q.numel() * q.element_size() \
        + b * 4 + q.shape[0] * 4 + (2 * b * d * 4 if scales else 0)
    return bound(nbytes, 4.0 * group * n_eff * d,
                 torch.float32 if k.dtype == torch.int8 else q.dtype)


def phase_k4(kind: str, group: int, dev, rng) -> dict:
    """K4a (group 1, B 640) or K4b (B 256, group 5): T 256, D 256, 8 heads
    of 32, the MHA flagship's cross attention; kind float32, bfloat16 or
    int8 (int8 caches, f32 queries).  Device-only times cycle through
    input sets of at least COLD_BYTES in all (cold caches)."""
    import torch.nn.functional as F

    from nanodecoder_tpu_torch.ops import attention as at

    b = 640 if group == 1 else 256
    t, h, dh = 256, 8, 32
    sets = [k4_inputs(kind, b, group, t, h, dh, h, dev, rng)]
    q, k, v, lens, lengths, scales = sets[0]
    set_bytes = sum(x.numel() * x.element_size() for x in (q, k, v, *scales.values()))
    sets += [k4_inputs(kind, b, group, t, h, dh, h, dev, rng)
             for _ in range(n_sets(set_bytes) - 1)]
    if group == 1:
        name = "K4a"
        runs = [lambda s=s: at.decode_attention(s[0], s[1], s[2], s[3], h, **s[5])
                for s in sets]
        plain = lambda: at.decode_attention_plain(q, k, v, lens, h, **scales)  # noqa: E731
    else:
        name = "K4b"
        runs = [lambda s=s: at.decode_attention_grouped(s[0], s[1], s[2], s[3], h, group,
                                                        **s[5]) for s in sets]
        plain = lambda: at.decode_attention_grouped_plain(  # noqa: E731
            q, k, v, lens, h, group, **scales)
    (out, amax), (rout, ramax) = runs[0](), plain()
    torch.cuda.synchronize()
    max_err, n_bad = check_k4(name, kind, out, amax, rout, ramax, q, k, lens, h, group,
                              scales)

    ms = cuda_ms(runs[0])
    plain_ms = cuda_ms(plain)
    g_ms = graph_ms(runs, 50)
    lib_ms = g_lib = None
    if kind != "int8":  # no library call takes int8 caches
        sdpas = []
        for sq, sk, sv, sl, _l, _s in sets:
            qt = sq.view(b, group, h, dh).transpose(1, 2).contiguous()
            kt, vt = (x.view(b, t, h, dh).transpose(1, 2).contiguous() for x in (sk, sv))
            mask = (torch.arange(t, device=dev)[None, :] < sl[:, None])[:, None, None, :]
            sdpas.append(lambda qt=qt, kt=kt, vt=vt, mask=mask:
                         F.scaled_dot_product_attention(qt, kt, vt, attn_mask=mask))
        lib_ms, g_lib = cuda_ms(sdpas[0]), graph_ms(sdpas, 50)
    bms, by = k4_bound(q, k, lengths, group, scales)
    lib = f"sdpa {lib_ms:.4f} ms" if lib_ms is not None else "sdpa n/a (int8)"
    glib = f"sdpa {g_lib:.4f} ms, kernel / sdpa {g_ms / g_lib:.3f}" \
        if g_lib is not None else "sdpa n/a"
    print(f"{name} {kind} B{b} G{group}: max_abs_err {max_err:.3g}, {n_bad} near-tie "
          f"positions  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  {lib}  bound "
          f"{bms:.4f} ms ({by}); device only (CUDA graph, {len(sets)} input set(s), "
          f"{len(sets) * set_bytes / 1e6:.0f} MB): kernel {g_ms:.4f} ms  {glib}, "
          f"bound share {bms / g_ms:.3f}")
    return {"max_abs_err": max_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "graph_ms": g_ms, "library_graph_ms": g_lib, "input_sets": len(sets)}


def phase_k4a_gqa(kind: str, n_kv: int, dev, rng) -> dict:
    """K4a on GQA/MQA caches (n_kv KV heads for the 8 query heads) at
    phase 2's shapes, against its plain version; device-only time over
    cold input sets."""
    from nanodecoder_tpu_torch.ops import attention as at

    b, t, h, dh = 640, 256, 8, 32
    sets = [k4_inputs(kind, b, 1, t, h, dh, n_kv, dev, rng)]
    q, k, v, lens, lengths, _ = sets[0]
    set_bytes = sum(x.numel() * x.element_size() for x in (q, k, v))
    sets += [k4_inputs(kind, b, 1, t, h, dh, n_kv, dev, rng)
             for _ in range(n_sets(set_bytes) - 1)]
    out, amax = at.decode_attention(q, k, v, lens, h)
    rout, ramax = at.decode_attention_plain(q, k, v, lens, h)
    torch.cuda.synchronize()
    max_err, n_bad = check_k4(f"K4a GQA n_kv {n_kv}", kind, out, amax, rout, ramax, q, k,
                              lens, h, 1, {})
    g_ms = graph_ms([lambda s=s: at.decode_attention(s[0], s[1], s[2], s[3], h)
                     for s in sets], 50)
    bms, by = k4_bound(q, k, lengths, 1, {})
    print(f"K4a GQA {kind} n_kv {n_kv} B{b}: max_abs_err {max_err:.3g}, {n_bad} near-tie "
          f"positions; device only (CUDA graph, {len(sets)} input set(s)): kernel "
          f"{g_ms:.4f} ms, bound {bms:.4f} ms ({by}), bound share {bms / g_ms:.3f}")
    return {"max_abs_err": max_err, "graph_ms": g_ms, "bound_ms": bms, "bound_by": by}


def phase_k2(dtype, dev, c=256) -> dict:
    """K2 at the MQA (C 256) or the MHA (C 1536) self-cache width.  Its
    device-only time rotates through fresh slabs and the cache's blocks,
    COLD_BYTES of slab reads and block writes in all (the greedy loop
    writes each block 8 times in a row, from a slab made the step before)."""
    from nanodecoder_tpu_torch.ops import cache_update as cu

    b, t = 640, 96
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
    run = lambda: cu.write_cache_block(cache, slab, step)  # noqa: E731
    lib = lambda: cache[:, t0:t0 + cu.BLOCK].copy_(slab)  # noqa: E731
    ms, lib_ms = cuda_ms(run), cuda_ms(lib)
    plain_ms = cuda_ms(lambda: cu.write_cache_block_plain(cache, slab, step))
    slab_bytes = slab.numel() * slab.element_size()
    slabs = [torch.randn(b, cu.BLOCK, c, device=dev, generator=gen).to(dtype)
             for _ in range(n_sets(2 * slab_bytes))]
    blocks = t // cu.BLOCK
    runs = [lambda i=i: cu.write_cache_block(cache, slabs[i], cu.BLOCK * (i % blocks))
            for i in range(len(slabs))]
    libs = [lambda i=i: cache[:, cu.BLOCK * (i % blocks):cu.BLOCK * (i % blocks + 1)].copy_(
        slabs[i]) for i in range(len(slabs))]
    g_ms, g_lib = graph_ms(runs), graph_ms(libs)
    bms, by = bound(2 * slab_bytes, 0.0, dtype)
    print(f"K2 {str(dtype)[6:]} C{c}: bit-exact over {t} steps  kernel {ms:.4f} ms  "
          f"plain {plain_ms:.4f} ms  copy_ {lib_ms:.4f} ms  bound {bms:.4f} ms ({by}); "
          f"device only (CUDA graph, {len(slabs)} slabs over {blocks} blocks): kernel "
          f"{g_ms:.4f} ms  copy_ {g_lib:.4f} ms, bound share {bms / g_ms:.3f}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": lib_ms,
            "graph_ms": g_ms, "library_graph_ms": g_lib, "input_sets": len(slabs)}


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def beam_cases(dev, b=256, k=5, v=344):
    """Beam-step inputs: a mid-decode step (EOS likely in some rows, part
    of the finished set filled), the first step (alive [0, -1e9 x4], every
    finished score -1e9), all ties, "below" (every candidate under -1e9:
    alive -2e9), "few" (beam 0 has 6 finite log-probs, the rest -inf, and
    the other beams give exactly -1e9: fewer than 2K candidates above -1e9
    beside exact -1e9 ties) and "neg_inf" (-inf log-probs in a mid step,
    a whole beam of them in some rows)."""
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
    no_fin = torch.full((b, k), -1e9, device=dev)
    few = lp.clone()
    few[:, 0, min(6, v):] = -float("inf")
    holes = lp.clone()
    holes[:, :, 1::7] = -float("inf")
    holes[::5, 1] = -float("inf")
    return {"mid": (alive, lp, fin),
            "step0": (first, lp, no_fin),
            "ties": (torch.zeros_like(alive), torch.zeros_like(lp), fin),
            "below": (torch.full_like(alive, -2e9), lp, no_fin),
            "few": (first, few, no_fin),
            "neg_inf": (alive, holes, fin)}


def phase_k3(dev, floor_ms=None) -> dict:
    from nanodecoder_tpu_torch.ops import beam_step as bs
    from nanodecoder_tpu_torch.vocab import EOS_ID

    b, k, v = 256, 5, 344
    pen = 13.0  # the avg length penalty at step 13
    cases = {**beam_cases(dev, b, k, v),
             **{f"{name}_v8": c for name, c in beam_cases(dev, b, k, 8).items()}}
    for name, (alive, lp, fin) in cases.items():
        vv = lp.shape[2]
        got = bs.beam_advance(alive, lp, fin, pen, k, vv, EOS_ID)
        ref = bs.beam_advance_plain(alive, lp, fin, pen, k, vv, EOS_ID)
        torch.cuda.synchronize()
        check(all(g.dtype == r.dtype and torch.equal(_bits(g), _bits(r))
                  for g, r in zip(got, ref)), f"K3 {name}: kernel differs from plain")
    alive, lp, fin = cases["mid"]
    flat = (alive[:, :, None] + lp).reshape(b, k * v)
    run = lambda: bs.beam_advance(alive, lp, fin, pen, k, v, EOS_ID)  # noqa: E731
    lib = lambda: torch.topk(flat, 2 * k, dim=1)  # noqa: E731
    ms, lib_ms = cuda_ms(run), cuda_ms(lib)
    plain_ms = cuda_ms(lambda: bs.beam_advance_plain(alive, lp, fin, pen, k, v, EOS_ID))
    g_ms, g_lib = graph_ms(run), graph_ms(lib)
    # Read alive, log-probs and finished once; write the five outputs.
    nbytes = 4 * (b * k + b * k * v + b * k) + 4 * (b * 2 * k + 4 * b * k)
    # The add, 2K block-wide argmax rounds over K*V, two small picks.
    flops = float(b * k * v * (1 + 2 * k) + b * (2 * k * k + 3 * k * k))
    bms, by = bound(nbytes, flops, torch.float32)
    floor = f", launch floor {floor_ms:.4f} ms" if floor_ms is not None else ""
    print(f"K3 float32: bit-exact on {len(cases)} cases ({', '.join(cases)}; *_v8 at "
          f"V 8 < 2K)  kernel {ms:.4f} ms  plain {plain_ms:.4f} ms  topk(2K) "
          f"{lib_ms:.4f} ms  bound {bms:.4f} ms ({by}; below a launch: launch- and "
          f"latency-bound); device only (CUDA graph, log-probs L2-warm as the step that "
          f"wrote them leaves them): kernel {g_ms:.4f} ms  topk(2K) {g_lib:.4f} ms{floor}")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "graph_ms": g_ms,
            "library_graph_ms": g_lib}


def phase_k7(dev) -> dict:
    from nanodecoder_tpu_torch.ops import beam_step as bs

    b, k, v, n_out = 256, 5, 344, 10
    cases = {**beam_cases(dev, b, k, v),
             **{f"{name}_v8": c for name, c in beam_cases(dev, b, k, 8).items()}}
    for name, (alive, lp, _fin) in cases.items():
        s, i = bs.beam_topk(alive, lp, n_out)
        rs, ri = bs.beam_topk_plain(alive, lp, n_out)
        torch.cuda.synchronize()
        check(torch.equal(_bits(s), _bits(rs)) and torch.equal(i, ri),
              f"K7 {name}: kernel differs from plain")
    alive, lp, _fin = cases["mid"]
    flat = (alive[:, :, None] + lp).reshape(b, k * v)
    run = lambda: bs.beam_topk(alive, lp, n_out)  # noqa: E731
    lib = lambda: torch.topk(flat, n_out, dim=1)  # noqa: E731
    ms, lib_ms = cuda_ms(run), cuda_ms(lib)
    plain_ms = cuda_ms(lambda: bs.beam_topk_plain(alive, lp, n_out))
    g_ms, g_lib = graph_ms(run), graph_ms(lib)
    nbytes = 4 * (b * k + b * k * v) + 8 * b * n_out
    bms, by = bound(nbytes, float(b * k * v * (1 + n_out)), torch.float32)
    print(f"K7 float32: bit-exact on {len(cases)} cases  kernel {ms:.4f} ms  plain "
          f"{plain_ms:.4f} ms  topk({n_out}) {lib_ms:.4f} ms  bound {bms:.4f} ms "
          f"({by}; launch- and latency-bound); device only (CUDA graph): kernel "
          f"{g_ms:.4f} ms  topk({n_out}) {g_lib:.4f} ms")
    return {"max_abs_err": 0.0, "ms": ms, "plain_ms": plain_ms, "bound_ms": bms,
            "bound_by": by, "library_ms": lib_ms, "graph_ms": g_ms,
            "library_graph_ms": g_lib}


def load_config(compute_dtype: str, h2d: str, batch_chunks: int, model=None,
                pallas: bool = True, **decode):
    """The flagship config with these serving settings; `model` holds
    ModelConfig overrides (the MHA form, lean_step, int8 caches).
    `pallas` sets model.use_pallas and decode.use_pallas (the committed
    config's model.use_pallas is false): the kernel route, as the JAX
    package's CLI takes it on an accelerator, or the plain PyTorch one."""
    from nanodecoder_tpu_torch.config import Config

    with open(CONFIG) as f:
        cfg = Config.from_json(f.read())
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype=compute_dtype,
                                       use_pallas=pallas, **(model or {})),
        decode=dataclasses.replace(cfg.decode, h2d_dtype=h2d, use_pallas=pallas,
                                   batch_chunks=batch_chunks, **decode))


class IdentityLog:
    """Every read identity that phases 3-15 compute, through the port's
    `identity.read_identity` (native where the host library loads): the
    pair and the result, and the seconds all the calls took.  Phase 16
    holds phase 4's pairs to the numpy version and times a sample of the
    pairs in numpy."""

    def __init__(self):
        self.calls: list[tuple[str, str, float]] = []
        self.seconds = 0.0

    def __call__(self, called: str, truth: str) -> float:
        from nanodecoder_tpu_torch import identity

        t0 = time.perf_counter()
        value = identity.read_identity(called, truth)
        self.seconds += time.perf_counter() - t0
        self.calls.append((called, truth, value))
        return value


IDENTITY = IdentityLog()


def read_identity(called: str, truth: str) -> float:
    """The port's read identity, logged in IDENTITY."""
    return IDENTITY(called, truth)


def simulated_reads(n_reads: int, n_bases: int = 3000):
    """The first n_reads simulated reads of seed 1 (truth, signal)."""
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    spec = SimSpec()
    levels = spec.level_table()
    rng = np.random.default_rng(1)
    return [simulate_read(rng, n_bases, spec, levels) for _ in range(n_reads)]


def call_reads(tr, reads) -> tuple[list[float], int, float, list[str]]:
    """Basecall reads (attn stitch): (identities, samples, wall seconds,
    sequences)."""
    from nanodecoder_tpu_torch.io.fast5 import RawRead

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method="attn")
             for i, (_truth, sig) in enumerate(reads)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    idents = [read_identity(bc.sequence, truth)
              for bc, (truth, _sig) in zip(calls, reads)]
    return idents, sum(bc.n_samples for bc in calls), wall, [bc.sequence for bc in calls]


def phase_golden(params, cfg, label="golden f32") -> tuple[int, int]:
    from nanodecoder_tpu_torch.decode.translator import Translator
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
    print(f"{label}: {exact}/3 exact, identity to golden "
          + ", ".join(f"{x:.4f}" for x in idents))
    check(min(idents) >= 0.99, f"{label}: identity {min(idents)} below 0.99")
    return tr.batches, tr.decode_steps


def phase_serving(params, cfg, n_reads=100, label=None, record=None):
    """Returns (batches, decode steps, per-read identities); fills
    `record` with the calls' sequences and ksamples/s."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    label = label or f"serving bf16/int6/b{cfg.decode.batch_chunks}"
    tr = Translator(params, cfg)
    idents, samples, wall, seqs = call_reads(tr, simulated_reads(n_reads))
    if record is not None:
        record.update(seqs=seqs, idents=idents, ksamples_per_s=samples / wall / 1e3)
    mean_id = float(np.mean(idents))
    print(f"{label}: {n_reads} reads, {tr.batches} batches, {tr.decode_steps} decode "
          f"steps, mean identity {mean_id:.4f} (min {min(idents):.4f}), "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s)")
    check(mean_id >= 0.90, f"{label}: mean identity {mean_id} below 0.90")
    return tr.batches, tr.decode_steps, idents


def phase_beam_parity(params, cfg, ref=None, label=None):
    """Golden read 101 beam-called on the card, against the CPU's call
    (ref None) or the sequence `ref`.  Returns (batches, decode steps,
    the card's sequence)."""
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    spec = SimSpec()
    _truth, sig = simulate_read(np.random.default_rng(101), 900, spec,
                                spec.level_table())
    tr = Translator(params, cfg)
    got = tr.basecall_read(RawRead("golden_101", sig, "sim"))
    if ref is None:
        cpu = Translator(params, cfg, device="cpu")
        ref, against = cpu.basecall_read(RawRead("golden_101", sig, "sim")).sequence, "CPU"
    else:
        against = "phase 5's card call (MQA)"
    ident = read_identity(got.sequence, ref)
    label = label or f"beam parity f32/K{cfg.decode.beam_size}"
    print(f"{label}: golden_101 card vs {against} "
          f"{'exact' if got.sequence == ref else 'not exact'}, identity "
          f"{ident:.4f} ({len(got.sequence)} / {len(ref)} bases, "
          f"{tr.decode_steps} decode steps; GPU f32 sums run in another order)")
    check(bool(np.isfinite(got.qualities).all())
          and len(got.qualities) == len(got.sequence), f"{label}: bad qualities")
    check(ident >= 0.99, f"{label}: identity {ident} below 0.99")
    return tr.batches, tr.decode_steps, got.sequence


def batch_of_chunks(scfg, bsz: int, n_reads: int):
    """The first bsz chunks (and their lengths) of the first n_reads reads
    of seed 1: one full batch."""
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal

    chunks, lengths = [], []
    reads = iter(simulated_reads(n_reads))
    while sum(c.shape[0] for c in chunks) < bsz:
        cb = chunk_signal(normalize_signal(next(reads)[1], scfg.normalization,
                                           scfg.mad_scale, scfg.clip_sigma),
                          scfg.chunk_len, scfg.chunk_overlap, scfg.min_chunk_fill)
        chunks.append(cb.chunks)
        lengths.append(cb.lengths)
    return np.concatenate(chunks)[:bsz], np.concatenate(lengths)[:bsz]


def phase_beam_serving(params, cfg, greedy_idents=None, n_reads=20, label="beam"):
    """One full beam batch, then (with greedy_idents) the first n_reads
    reads of phase 4."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    tr = Translator(params, cfg)
    bsz = cfg.decode.effective_batch_chunks()
    chunks, lengths = batch_of_chunks(cfg.signal, bsz, 40)
    tr.decode_chunk_batch(chunks, lengths)  # warm-up
    steps0 = tr.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.decode_chunk_batch(chunks, lengths)
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    steps = tr.decode_steps - steps0
    check(out[0].shape[0] == bsz and bool((out[1] > 0).all()),
          f"{label} batch: missing or empty hypotheses")
    print(f"{label} batch bf16/int6: {bsz} chunks x K{cfg.decode.beam_size} = "
          f"{bsz * cfg.decode.beam_size} rows, wall {wall_ms:.1f} ms, {steps} decode "
          f"steps, {wall_ms / max(steps, 1):.3f} ms/step")
    if greedy_idents is None:
        return tr.batches, tr.decode_steps
    idents, samples, wall, _seqs = call_reads(tr, simulated_reads(n_reads))
    mean_id = float(np.mean(idents))
    greedy = float(np.mean(greedy_idents[:n_reads]))
    print(f"beam serving bf16/int6/b{bsz}/K{cfg.decode.beam_size}: {n_reads} reads, "
          f"mean identity {mean_id:.4f} (min {min(idents):.4f}), greedy on the same "
          f"reads {greedy:.4f} (difference {mean_id - greedy:+.4f}), "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s)")
    check(mean_id >= 0.90, f"beam serving mean identity {mean_id} below 0.90")
    return tr.batches, tr.decode_steps


# Shapes the earlier kernels refused, each against its plain version
# (phase 10).  K4a: (heads, Dh, KV heads, cache kinds); K4b: (group,
# heads, Dh, KV heads, kinds); encoder: (Dh, heads, S, dtypes).
ALL_KINDS, EXACT_KINDS = ("float32", "bfloat16", "int8"), ("float32", "bfloat16")
K4A_WIDE = [(4, 8, 4, ALL_KINDS), (6, 64, 6, ALL_KINDS), (12, 64, 12, ALL_KINDS),
            (16, 32, 1, EXACT_KINDS), (32, 16, 2, EXACT_KINDS)]
K4B_WIDE = [(9, 8, 32, 8, ALL_KINDS), (12, 8, 32, 8, ALL_KINDS), (16, 8, 32, 8, ALL_KINDS),
            (5, 8, 32, 1, EXACT_KINDS), (12, 8, 32, 1, EXACT_KINDS),
            (5, 8, 32, 2, EXACT_KINDS), (12, 8, 32, 2, EXACT_KINDS),
            (5, 4, 8, 4, ALL_KINDS), (5, 4, 24, 4, ALL_KINDS), (5, 16, 128, 16, ALL_KINDS)]
# Where one query row's H x T f32 scores overflow shared memory (the
# scalar kernel's device-memory workspace): (B, T, group, heads, Dh, KV
# heads, kinds).
K4_SCORES_WIDE = [(4, 1800, 1, 32, 32, 32, ALL_KINDS), (4, 1800, 3, 32, 32, 32, EXACT_KINDS),
                  (2, 1800, 1, 32, 32, 2, EXACT_KINDS), (2, 1800, 3, 32, 32, 2, EXACT_KINDS)]
F32_BF16 = (torch.float32, torch.bfloat16)
ENC_WIDE = [(8, 4, 256, F32_BF16), (16, 2, 256, F32_BF16), (48, 2, 256, F32_BF16),
            (96, 2, 256, F32_BF16), (256, 1, 256, F32_BF16),
            (128, 2, 2048, (torch.float32,)), (128, 2, 4096, (torch.float32,)),
            (320, 2, 256, F32_BF16), (512, 2, 256, F32_BF16)]


def phase_wide(dev, rng) -> dict:
    """Phase 10: K4a (B 640), K4b (B 256) at T 256, K4a/K4b at 32 heads x
    T 1800 (B 4, and B 2 on GQA caches) and K1/K5/K6 (B 6, lengths 0, 1,
    63, 64, 65 and S) at shapes the earlier kernels refused, each against
    its plain version at phase 2's tolerances, with device-only time (one
    input set, CUDA graph) of K4a, K4b and K1 and the kernel each ran;
    then K1/K5 on operands one element into their storage, K1 at B 65540,
    and K2 on a batch row's block of 2^31 + 8 bytes (phase_repaired)."""
    from nanodecoder_tpu_torch.ops import attention as at
    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    out = {}
    cases = [(640, 256, 1, h, dh, n_kv, kinds) for h, dh, n_kv, kinds in K4A_WIDE] + \
        [(256, 256) + c for c in K4B_WIDE] + K4_SCORES_WIDE
    for b, t, group, h, dh, n_kv, kinds in cases:
        for kind in kinds:
            q, k, v, lens, lengths, scales = k4_inputs(kind, b, group, t, h, dh, n_kv,
                                                       dev, rng)
            if group == 1:
                name = "K4a"
                run = lambda: at.decode_attention(q, k, v, lens, h, **scales)  # noqa: E731
                ref = at.decode_attention_plain(q, k, v, lens, h, **scales)
            else:
                name = "K4b"
                run = lambda: at.decode_attention_grouped(  # noqa: E731
                    q, k, v, lens, h, group, **scales)
                ref = at.decode_attention_grouped_plain(q, k, v, lens, h, group, **scales)
            fn = at.decode_attention if group == 1 else at.decode_attention_grouped
            scalar0 = fn.scalar_launches
            got = run()
            torch.cuda.synchronize()
            kernel = "scalar" if fn.scalar_launches > scalar0 else "fast"
            label = f"{name} {kind} G{group} H{h} Dh{dh} n_kv{n_kv}"
            max_err, n_bad = check_k4(label, kind, *got, *ref, q, k, lens, h, group,
                                      scales)
            g_ms = graph_ms(run, 20)
            bms, by = k4_bound(q, k, lengths, group, scales)
            label += f" T{t}" if t != 256 else ""
            print(f"wide {label} B{b} ({kernel} kernel): max_abs_err {max_err:.3g}, "
                  f"{n_bad} near-tie positions; device only {g_ms:.4f} ms, bound "
                  f"{bms:.4f} ms ({by}), bound share {bms / g_ms:.3f}")
            out[label] = {"kernel": kernel, "max_abs_err": max_err, "graph_ms": g_ms,
                          "bound_ms": bms, "bound_by": by}
    for dh, heads, s, dtypes in ENC_WIDE:
        lengths = np.minimum([0, 1, 63, 64, 65, s], s).astype(np.int32)
        b, d = len(lengths), heads * dh
        n = torch.from_numpy(lengths).to(dev)
        for dtype in dtypes:
            x = torch.from_numpy(rng.standard_normal((b, s, 3 * d), np.float32)).to(dev,
                                                                                     dtype)
            q, k, v = (x[..., i * d:(i + 1) * d].contiguous() for i in range(3))
            split = lambda y: y.view(b, s, heads, dh)  # noqa: E731
            ref = ea.encoder_attention_plain(x, n, heads)
            scalar0 = ea.flash_encoder_attention_qkv.scalar_launches
            got = {"K1": ea.flash_encoder_attention_qkv(x, n, heads),
                   "K5": ea.flash_encoder_attention_nld(q, k, v, n, heads),
                   "K6": ea.flash_encoder_attention(split(q), split(k), split(v),
                                                    n).reshape(b, s, d)}
            torch.cuda.synchronize()
            atol, rtol = K1_TOL[dtype]
            errs = []
            for name, y in got.items():
                check(bool(torch.isfinite(y).all()), f"wide {name} Dh{dh}: non-finite")
                err = (y.float() - ref.float()).abs()
                errs.append(float(err.max()))
                check(bool((err <= atol + rtol * ref.float().abs()).all()),
                      f"wide {name} {dtype} Dh{dh} S{s}: max |kernel - plain| "
                      f"{errs[-1]} over tolerance")
            kernel = ("scalar" if ea.flash_encoder_attention_qkv.scalar_launches > scalar0
                      else "padded" if ea.kernel_head_dim(dh) != dh else "fast")
            g_ms = graph_ms(lambda: ea.flash_encoder_attention_qkv(x, n, heads), 10)
            bms, by = enc_bound(x, lengths)
            label = f"K1/K5/K6 {str(dtype)[6:]} Dh{dh} H{heads} S{s}"
            print(f"wide {label} B{b} ({kernel} kernel): max_abs_err {max(errs):.3g}; K1 "
                  f"device only {g_ms:.4f} ms, bound {bms:.4f} ms ({by}), bound share "
                  f"{bms / g_ms:.3f}")
            out[label] = {"kernel": kernel, "max_abs_err": max(errs), "graph_ms": g_ms,
                          "bound_ms": bms, "bound_by": by}
    out.update(phase_repaired(dev, rng))
    return out


def shifted(x: torch.Tensor) -> torch.Tensor:
    """x's values in a contiguous view one element into its storage (not
    16-byte aligned)."""
    buf = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    view = buf[1:].view(x.shape)
    view.copy_(x)
    return view


def phase_repaired(dev, rng) -> dict:
    """Phase 10, the rest: K1 and K5 on operands one element into their
    storage (the scalar kernel) at B 6, S 256, 2 heads of 128; K1 at B
    65540 (past grid z's 65535), S 32, 1 head of 32, f32 (the fast kernel
    looping over batch rows); K2 at B 1, T 8 on an int8 cache of C 2^28 + 1
    bytes a row (a block of 2^31 + 8 one-byte units), bit for bit against
    copy_, timed, then freed."""
    from nanodecoder_tpu_torch.ops import cache_update as cu
    from nanodecoder_tpu_torch.ops import encoder_attention as ea

    out = {}
    k1, k5 = ea.flash_encoder_attention_qkv, ea.flash_encoder_attention_nld
    lengths = np.asarray([0, 1, 63, 64, 65, 256], np.int32)
    b, s, heads, dh = len(lengths), 256, 2, 128
    d = heads * dh
    n = torch.from_numpy(lengths).to(dev)
    for dtype in F32_BF16:
        x = torch.from_numpy(rng.standard_normal((b, s, 3 * d), np.float32)).to(dev, dtype)
        xs = shifted(x)
        q, k, v = (shifted(x[..., i * d:(i + 1) * d].contiguous()) for i in range(3))
        scalar0 = (k1.scalar_launches, k5.scalar_launches)
        got1, got5 = k1(xs, n, heads), k5(q, k, v, n, heads)
        check((k1.scalar_launches, k5.scalar_launches) == (scalar0[0] + 1, scalar0[1] + 1),
              "unaligned encoder operands did not run the scalar kernel")
        ref = ea.encoder_attention_plain(x, n, heads)
        torch.cuda.synchronize()
        atol, rtol = K1_TOL[dtype]
        errs = []
        for name, y in (("K1", got1), ("K5", got5)):
            err = (y.float() - ref.float()).abs()
            errs.append(float(err.max()))
            check(bool(torch.isfinite(y).all())
                  and bool((err <= atol + rtol * ref.float().abs()).all()),
                  f"unaligned {name} {dtype}: max |kernel - plain| {errs[-1]}")
        g_ms = graph_ms(lambda: k1(xs, n, heads), 10)
        g_fast = graph_ms(lambda: k1(x, n, heads), 10)
        bms, by = enc_bound(x, lengths)
        label = f"K1/K5 unaligned {str(dtype)[6:]} Dh{dh} H{heads} S{s}"
        print(f"wide {label} B{b} (scalar kernel): max_abs_err {max(errs):.3g}; K1 device "
              f"only {g_ms:.4f} ms (aligned, fast kernel: {g_fast:.4f} ms), bound "
              f"{bms:.4f} ms ({by}), bound share {bms / g_ms:.3f}")
        out[label] = {"kernel": "scalar", "max_abs_err": max(errs), "graph_ms": g_ms,
                      "fast_graph_ms": g_fast, "bound_ms": bms, "bound_by": by}

    b, s, d = 65540, 32, 32
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.randn(b, s, 3 * d, device=dev, generator=gen)
    n = torch.randint(0, s + 1, (b,), device=dev, generator=gen, dtype=torch.int32)
    scalar0 = k1.scalar_launches
    got, ref = k1(x, n, 1), ea.encoder_attention_plain(x, n, 1)
    torch.cuda.synchronize()
    err = (got - ref).abs()
    max_err = float(err.max())
    check(k1.scalar_launches == scalar0 and bool((err <= 1e-5 + 1e-5 * ref.abs()).all()),
          f"K1 B{b}: max |kernel - plain| {max_err}")
    g_ms = graph_ms(lambda: k1(x, n, 1), 10)
    bms, by = enc_bound(x, n.cpu().numpy())
    print(f"wide K1 float32 Dh{d} H1 S{s} B{b} (fast kernel, batch rows past grid z): "
          f"max_abs_err {max_err:.3g}; device only {g_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), bound share {bms / g_ms:.3f}")
    out[f"K1 float32 Dh{d} H1 S{s} B{b}"] = {"kernel": "fast", "max_abs_err": max_err,
                                            "graph_ms": g_ms, "bound_ms": bms,
                                            "bound_by": by}
    del x, n, got, ref, err

    c = 2 ** 28 + 1
    cache = torch.zeros(1, 8, c, dtype=torch.int8, device=dev)
    slab = torch.randint(-128, 128, (1, 8, c), dtype=torch.int8, device=dev, generator=gen)
    ref = torch.empty_like(cache).copy_(slab)
    cu.write_cache_block(cache, slab, 5)
    torch.cuda.synchronize()
    check(torch.equal(cache, ref), f"K2 int8 C{c}: kernel differs from copy_")
    ms = cuda_ms(lambda: cu.write_cache_block(cache, slab, 5), reps=5, warmup=1)
    lib_ms = cuda_ms(lambda: cache.copy_(slab), reps=5, warmup=1)
    bms, by = bound(2 * slab.numel(), 0.0, torch.float32)
    print(f"wide K2 int8 B1 T8 C{c} (a block of 2^31 + 8 one-byte units): bit-exact "
          f"against copy_; kernel {ms:.4f} ms, copy_ {lib_ms:.4f} ms, bound {bms:.4f} ms "
          f"({by}), bound share {bms / ms:.3f}")
    out[f"K2 int8 B1 T8 C{c}"] = {"max_abs_err": 0.0, "ms": ms, "library_ms": lib_ms,
                                 "bound_ms": bms, "bound_by": by}
    del cache, slab, ref
    torch.cuda.empty_cache()
    return out


def phase_tiny(dev, reset, counts) -> dict:
    """Phase 11: the JAX package's tiny_test_config (D 32, 4 heads of 8,
    MHA decoder), f32, random params from seed 3, on 4 simulated reads of
    1500 bases: greedy and beam 5, lean and unfolded, by the kernel route
    (its kernels counted as launched) and by the plain route on the card;
    the two routes' basecalls (trim stitch, which reads no attention
    position) must agree at identity >= 0.99.  Returns the kernel route's
    launches."""
    from nanodecoder_tpu_torch.config import tiny_test_config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal
    from nanodecoder_tpu_torch.profile_serving import random_params
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    base = tiny_test_config()
    params = params_from_numpy(random_params(base.model, 3), base.model, device=dev)
    spec = SimSpec()
    rng = np.random.default_rng(7)
    reads = [RawRead(f"tiny{i}", simulate_read(rng, 1500, spec, spec.level_table())[1],
                     "sim") for i in range(4)]
    need = {("lean", "greedy"): ("K1", "K2", "K4a"),
            ("lean", "beam"): ("K1", "K2", "K3", "K4b"),
            ("unfolded", "greedy"): ("K5", "K4a"),
            ("unfolded", "beam"): ("K5", "K3", "K4b")}
    total = {}
    for (form, mode), kernels in need.items():
        seqs = {}
        for pallas in (True, False):
            model = dataclasses.replace(base.model, use_pallas=pallas,
                                        lean_step=form == "lean")
            decode = dataclasses.replace(base.decode, use_pallas=pallas, batch_chunks=64,
                                         batch_chunks_beam=16, mode=mode, beam_size=5)
            tr = Translator(params, dataclasses.replace(base, model=model, decode=decode))
            reset()
            seqs[pallas] = [tr.basecall_read(r, stitch_method="trim").sequence
                            for r in reads]
            c = counts()
            if pallas:
                for name in kernels:
                    check(c[name] > 0, f"tiny {form} {mode}: {name} not launched")
                total = {name: total.get(name, 0) + n for name, n in c.items()}
                if (form, mode) == ("lean", "greedy"):  # EOS and PAD occur
                    sc = base.signal
                    cbs = [chunk_signal(normalize_signal(r.signal, sc.normalization,
                                                         sc.mad_scale, sc.clip_sigma),
                                        sc.chunk_len, sc.chunk_overlap, sc.min_chunk_fill)
                           for r in reads]
                    lengths = tr.decode_chunk_batch(
                        np.concatenate([cb.chunks for cb in cbs]),
                        np.concatenate([cb.lengths for cb in cbs]))[1]
                    tmax = base.model.max_decode_len
                    print(f"tiny: {len(lengths)} chunks, token lengths {lengths.min()} to "
                          f"{lengths.max()}, {int((lengths < tmax).sum())} ended by EOS")
                    check(bool((lengths < tmax).any() and (lengths == tmax).any()),
                          "tiny: no chunk ends by EOS, or every chunk does")
            else:
                check(all(n == 0 for name, n in c.items() if name != "K2"),
                      f"tiny {form} {mode} without kernels: launches {c}")
        idents = [read_identity(a, b) for a, b in zip(seqs[True], seqs[False])]
        print(f"tiny {form} {mode}: kernel route vs plain route on the card, identity "
              + ", ".join(f"{x:.4f}" for x in idents)
              + f" ({sum(len(x) for x in seqs[True])} bases)")
        check(min(idents) >= 0.99, f"tiny {form} {mode}: identity {min(idents)} < 0.99")
    return total

# The engine phase's signal files: int16 DAC counts, signal = raw *
# range / digitisation (offset 0), as a flow cell's channel calibrates.
# The simulator's signal spans about +-4, so a step of 2 / 8192 keeps 15
# bits of it.
DAC_RANGE, DAC_DIGITISATION = 2.0, 8192.0


def signal_file_format() -> tuple[str, str]:
    """(format, reason) of the signal files the engine phase writes:
    fast5 where h5py imports, else pod5 where pyarrow, zstandard and
    flatbuffers all import, else "npz" (read through a substitute reader,
    read_npz_signals)."""
    have = {}
    for mod in ("h5py", "pyarrow", "zstandard", "flatbuffers"):
        try:
            importlib.import_module(mod)
            have[mod] = True
        except ImportError:
            have[mod] = False
    found = ", ".join(f"{m} {'imports' if ok else 'missing'}" for m, ok in have.items())
    if have["h5py"]:
        return "fast5", found
    if have["pyarrow"] and have["zstandard"] and have["flatbuffers"]:
        return "pod5", found
    return "npz", found


def write_signal_files(root: str, reads, fmt: str, per_file: int = 20) -> list[str]:
    """reads: [(read id, f32 picoamp signal)] -> files of `per_file` reads
    each in `fmt`: multi-read fast5 or pod5 of int16 DAC counts with their
    calibration, or .npz of the f32 signals."""
    scale = DAC_RANGE / DAC_DIGITISATION
    files = []
    for start in range(0, len(reads), per_file):
        group = reads[start:start + per_file]
        path = os.path.join(root, f"reads{start // per_file:03d}.{fmt}")
        if fmt == "fast5":
            import h5py

            with h5py.File(path, "w") as f:
                for rid, sig in group:
                    grp = f.create_group(f"read_{rid}")
                    raw = grp.create_group("Raw")
                    raw.attrs["read_id"] = rid.encode()
                    raw.create_dataset("Signal", data=np.rint(sig / scale).astype(np.int16))
                    ch = grp.create_group("channel_id")
                    ch.attrs["offset"] = 0.0
                    ch.attrs["range"] = DAC_RANGE
                    ch.attrs["digitisation"] = DAC_DIGITISATION
        elif fmt == "pod5":
            from nanodecoder_tpu_torch.io.pod5 import Pod5Read, write_pod5

            write_pod5(path, [Pod5Read(rid, np.rint(sig / scale).astype(np.int16),
                                       calibration_scale=scale) for rid, sig in group])
        else:
            np.savez(path, **{rid: np.asarray(sig, np.float32) for rid, sig in group})
        files.append(path)
    return files


def read_npz_signals(path: str):
    """The substitute file reader: the reads of an .npz of f32 signals."""
    from nanodecoder_tpu_torch.io.fast5 import RawRead

    with np.load(path) as data:
        return [RawRead(rid, data[rid], path) for rid in data.files]


def list_npz_files(root: str) -> list[str]:
    return [root] if os.path.isfile(root) else sorted(
        os.path.join(root, f) for f in os.listdir(root) if f.endswith(".npz"))


def _ingest_npz_worker(path: str, scfg, h2d_name: str):
    """The engine's ingest worker with read_npz_signals installed, for
    this call, in the worker process itself (a pool worker does not see
    the parent's substitution)."""
    from nanodecoder_tpu_torch.io import pipeline

    saved, pipeline.read_fast5_file = pipeline.read_fast5_file, read_npz_signals
    try:
        return pipeline._ingest_file_worker(path, scfg, h2d_name)
    finally:
        pipeline.read_fast5_file = saved


@contextlib.contextmanager
def npz_ingest():
    """The engine's ingest and the CLI's file listing with .npz files in
    place of fast5/pod5."""
    from nanodecoder_tpu_torch.io import fast5, pipeline

    saved = pipeline._ingest_file_worker, fast5.list_signal_files
    pipeline._ingest_file_worker, fast5.list_signal_files = _ingest_npz_worker, list_npz_files
    try:
        yield
    finally:
        pipeline._ingest_file_worker, fast5.list_signal_files = saved


def basecall_cli_npz(argv: list[str]) -> int:
    """The basecall CLI on .npz signal files (run as
    `python -c "import sys, chip_smoke; sys.exit(chip_smoke.basecall_cli_npz(sys.argv[1:]))" ...`)."""
    from nanodecoder_tpu_torch.cli import basecall
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    try:
        with npz_ingest():
            return basecall.main(argv)
    finally:
        stop_ingest_processes()


def parse_fastq(text: str, label: str) -> dict[str, str]:
    """id -> sequence of a FASTQ text: 4 lines a record, one record a read,
    a quality per base."""
    lines = text.splitlines()
    check(len(lines) % 4 == 0 and lines, f"{label}: FASTQ of {len(lines)} lines")
    ids = [x[1:] for x in lines[0::4]]
    check(all(x.startswith("@") for x in lines[0::4]) and all(x == "+" for x in lines[2::4])
          and all(len(q) == len(sq) for sq, q in zip(lines[1::4], lines[3::4])),
          f"{label}: malformed FASTQ record")
    check(len(ids) == len(set(ids)), f"{label}: a read came back more than once")
    return dict(zip(ids, lines[1::4]))


def engine_call(params, cfg, files, label: str, stitch: str = "attn"):
    """One StreamingBasecaller.run over `files` (4 workers): (id ->
    sequence, meter, stage timer, engine)."""
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.utils.profiling import StageTimer

    engine = StreamingBasecaller(params, cfg)
    timer, out = StageTimer(), io.StringIO()
    meter = engine.run(files, out, stitch_method=stitch, num_workers=4, stage_timer=timer)
    torch.cuda.synchronize()
    return parse_fastq(out.getvalue(), label), meter, timer, engine


def phase_engine(params, reset, counts, phase4: dict, root: str) -> dict:
    """Phase 12: the streaming engine (decode/engine.StreamingBasecaller)
    on signal files, at full batches: the golden reads in f32, greedy
    (bf16, int6 wire, 512-chunk batches) on 200 simulated reads, beam 5
    on 20 reads at 256-chunk batches; then the basecall CLI once as a
    subprocess.  Returns the engine runs' launches (the CLI's are in its
    own process)."""
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    fmt, found = signal_file_format()
    print(f"ingest: {fmt} files" + (" through a substitute reader (the port's fast5 "
                                     "reader needs h5py, its pod5 reader pyarrow, "
                                     "zstandard and flatbuffers)" if fmt == "npz" else "")
          + f"; {found}")
    tmp = tempfile.mkdtemp(prefix="chip_smoke_engine_")
    try:
        reads = simulated_reads(200)
        files = write_signal_files(tmp, [(f"sim{i}", sig) for i, (_t, sig) in enumerate(reads)],
                                   fmt)
        spec = SimSpec()
        gold_dir = os.path.join(tmp, "golden")
        os.makedirs(gold_dir)
        gold_files = write_signal_files(
            gold_dir, [(f"golden_{seed}", simulate_read(np.random.default_rng(seed), n, spec,
                                                        spec.level_table())[1])
                       for seed, n in GOLDEN_READS], fmt)
        with (npz_ingest() if fmt == "npz" else contextlib.nullcontext()):
            launches = engine_runs(params, reset, counts, phase4, reads, files, gold_files)
        engine_cli(files[0], fmt, tmp, root, {f"sim{i}" for i in range(20)})
    finally:
        stop_ingest_processes()
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def stage_line(timer) -> str:
    return ", ".join(f"{name} {st['total_sec']:.3f} s / {st['count']}"
                     for name, st in timer.summary().items())


def engine_runs(params, reset, counts, phase4, reads, files, gold_files) -> dict:
    """The engine's three runs, their checks and numbers; returns their
    launches.  The golden run goes first: it also starts the ingest
    pool's processes, so the greedy run's wall is the steady state."""

    reset()
    with open(GOLDEN) as f:
        golden = json.load(f)["reads"]
    gcalls, _m, gtimer, _e = engine_call(params, load_config("float32", "float32", 640),
                                         gold_files, "engine golden", stitch="trim")
    check(sorted(gcalls) == sorted(golden), f"engine golden: reads {sorted(gcalls)}")
    gid = {rid: read_identity(seq, golden[rid]["sequence"]) for rid, seq in gcalls.items()}
    print(f"engine golden f32 (trim stitch, as the goldens): "
          f"{sum(gcalls[r] == golden[r]['sequence'] for r in gcalls)}/3 exact, identity to "
          f"golden " + ", ".join(f"{gid[r]:.4f}" for r in sorted(gid))
          + f"; stages, the ingest pool starting: {stage_line(gtimer)}")
    check(min(gid.values()) >= 0.99, f"engine golden: identity {min(gid.values())} < 0.99")

    serve_cfg = load_config("bfloat16", "int6", 640)
    bsz = serve_cfg.decode.effective_batch_chunks(engine=True)
    check(bsz == 512, f"engine batch {bsz}, expected batch_chunks_engine 512")
    enc_layers = serve_cfg.model.enc_layers
    before = counts()
    calls, meter, timer, engine = engine_call(params, serve_cfg, files, "engine greedy")
    check(sorted(calls) == sorted(f"sim{i}" for i in range(len(reads))),
          f"engine greedy: {len(calls)} reads came back of {len(reads)}")
    # A call equal to phase 4's has phase 4's identity: scoring those
    # reads again would take most of the phase's time.
    idents, to_tr = [], []
    for i, (truth, _s) in enumerate(reads):
        seq = calls[f"sim{i}"]
        same = i < len(phase4["seqs"]) and seq == phase4["seqs"][i]
        if i < len(phase4["seqs"]):
            to_tr.append(1.0 if same else read_identity(seq, phase4["seqs"][i]))
        idents.append(phase4["idents"][i] if same else read_identity(seq, truth))
    wall = timer.totals["wall"]
    greedy = {name: n - before[name] for name, n in counts().items()}
    check(greedy["K1"] == enc_layers * engine.batches and greedy["K3"] == 0
          and greedy["K2"] >= engine.decode_steps > 0,
          f"engine greedy launches {greedy} for {engine.batches} batches")
    print(f"engine greedy bf16/int6/b{bsz}: {len(reads)} reads, {meter.n_chunks} chunks in "
          f"{engine.batches} batches ({meter.n_chunks / engine.batches:.1f} real rows of "
          f"{bsz} a batch), {engine.decode_steps} decode steps; mean identity "
          f"{np.mean(idents):.4f} to the truth (min {min(idents):.4f}), "
          f"{np.mean(to_tr):.4f} to Translator's calls of phase 4's {len(to_tr)} reads "
          f"(min {min(to_tr):.4f}, {sum(x == 1.0 for x in to_tr)} identical); wall "
          f"{wall:.2f} s, {meter.n_samples / wall / 1e3:.1f} ksamples/s (phase 4, "
          f"Translator: {phase4['ksamples_per_s']:.1f})")
    print(f"engine greedy stages: {stage_line(timer)}")
    print(f"engine greedy launches: K1 {greedy['K1']}, K2 {greedy['K2']}, K3 {greedy['K3']}")
    check(np.mean(idents) >= 0.90, f"engine greedy: mean identity {np.mean(idents)} < 0.90")
    check(np.mean(to_tr) >= 0.99,
          f"engine greedy: mean identity to Translator {np.mean(to_tr)} < 0.99")

    beam_cfg = load_config("bfloat16", "int6", 640, mode="beam", beam_size=5,
                           batch_chunks_beam=256, batch_chunks_engine=256)
    k3_before = counts()["K3"]
    bcalls, bmeter, btimer, bengine = engine_call(params, beam_cfg, files[:1], "engine beam")
    n_beam = len(bcalls)
    check(sorted(bcalls) == sorted(f"sim{i}" for i in range(n_beam)) and n_beam == 20,
          f"engine beam: reads {sorted(bcalls)[:5]}...")
    bid = [read_identity(bcalls[f"sim{i}"], reads[i][0]) for i in range(n_beam)]
    k3 = counts()["K3"] - k3_before
    print(f"engine beam bf16/int6/b256/K5: {n_beam} reads, {bmeter.n_chunks} chunks in "
          f"{bengine.batches} batches, {bengine.decode_steps} decode steps, K3 launched "
          f"{k3} times; mean identity {np.mean(bid):.4f} (min {min(bid):.4f}), greedy "
          f"engine on the same reads {np.mean(idents[:n_beam]):.4f} (difference "
          f"{np.mean(bid) - np.mean(idents[:n_beam]):+.4f}); wall "
          f"{btimer.totals['wall']:.2f} s, "
          f"{bmeter.n_samples / btimer.totals['wall'] / 1e3:.1f} ksamples/s; stages: "
          f"{stage_line(btimer)}")
    check(k3 == bengine.decode_steps > 0, f"engine beam: K3 launched {k3} times")
    check(np.mean(bid) >= 0.90, f"engine beam: mean identity {np.mean(bid)} < 0.90")
    return counts()


def engine_cli(path: str, fmt: str, tmp: str, root: str, want: set[str]) -> None:
    """`python -m nanodecoder_tpu_torch.cli.basecall` on one signal file of
    20 reads, with --stage-times (on .npz files through basecall_cli_npz)."""
    out = os.path.join(tmp, "cli.fastq")
    args = ["--input", path, "--output", out, "--ckpt", NPZ, "--stage-times",
            "--workers", "4"]
    cmd = ([sys.executable, "-m", "nanodecoder_tpu_torch.cli.basecall"] if fmt != "npz"
           else [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.basecall_cli_npz(sys.argv[1:]))"]) + args
    t0 = time.perf_counter()
    res = subprocess.run(cmd, cwd=root, capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    check(res.returncode == 0, f"basecall CLI exit {res.returncode}: {res.stderr[-2000:]}")
    with open(out) as f:
        calls = parse_fastq(f.read(), "basecall CLI")
    check(set(calls) == want, f"basecall CLI: {len(calls)} reads, expected {len(want)}")
    stages = [x.split("] ", 1)[-1] for x in res.stderr.splitlines()
              if "] span " in x or "ksamples/s" in x]
    print(f"basecall CLI ({' '.join(cmd[1:3])} ...): {len(calls)} reads, 4 lines a read, "
          f"one record a read, process wall {wall:.1f} s; " + "; ".join(stages))


# Phase 13's training settings: the committed train section (cosine, lr
# 3e-4, label smoothing 0.1, guided attention 0.3, dropout 0.1) at the
# flagship's full width, with these overrides: a warmup that a few dozen
# steps get past, and as many train steps as the learning run takes.
TRAIN_OVERRIDES = {"warmup_steps": 10, "train_steps": 60}
LEARN_STEPS, BF16_STEPS, PARITY_BATCH, PROFILED_STEPS = 50, 10, 8, 3
# The parity steps run at a constant lr, so that every step moves the
# params (the cosine's warmup starts at 0), low enough that the trainer
# still serves the flagship's identity in (d) and that every param stays
# within 1e-4 of the CPU's: where card and CPU take opposite signs of a
# gradient at rounding level, Adam moves them apart by up to 2 x
# ADAM_STEP x lr.  ADAM_STEP: the most an Adam step (b1 0.9, b2 0.998)
# moves an element, in units of lr, in its first steps (1.0013 in the
# second, when the gradient changes between steps).
PARITY_STEPS, PARITY_LR, ADAM_STEP = 2, 4e-5, 1.01
DROPOUT_PARITY_STEPS = 1


def train_draws(model) -> int:
    """Dropout draws (R1 launches) of one training micro-step at a positive
    rate: three a transformer encoder layer (one mask for the attention
    output and its residual, which share a key and a flat count, one for
    the FFN's hidden layer, one for its residual), four a transformer
    decoder layer; the biLSTM encoder and the RNN decoder draw none."""
    if model.dropout <= 0.0:
        return 0
    return (3 * model.enc_layers * (model.encoder_type == "transformer")
            + 4 * model.dec_layers * (model.decoder_type == "transformer"))


def train_config(batch: int, dtype: str = "float32", dropout: float | None = None,
                 pallas: bool = True, model=None):
    """The flagship config (with `model`'s ModelConfig overrides) for
    training: f32 (or `dtype`) compute, the kernel route for validation,
    TRAIN_OVERRIDES and this batch."""
    cfg = load_config(dtype, "float32", 640, model=model, pallas=pallas)
    model = cfg.model if dropout is None else dataclasses.replace(cfg.model,
                                                                  dropout=dropout)
    return dataclasses.replace(cfg, model=model, train=dataclasses.replace(
        cfg.train, batch_size=batch, **TRAIN_OVERRIDES))


def max_param_diff(a, b) -> float:
    from nanodecoder_tpu_torch.models.model import named_leaves

    la, lb = named_leaves(a), named_leaves(b)
    return max(float((la[k].detach().cpu() - lb[k].detach().cpu()).abs().max())
               for k in la)


def quiet_trainer(cfg, params):
    from nanodecoder_tpu_torch.train.trainer import Trainer
    from nanodecoder_tpu_torch.utils.report import ReportManager

    return Trainer(cfg, params, report=ReportManager(report_every=10 ** 9))


def host_leaves(params, grad: bool = False) -> dict:
    """{param key: a host copy of the tensor (or its .grad)}."""
    from nanodecoder_tpu_torch.models.model import named_leaves

    return {k: (t.grad if grad else t).detach().cpu().clone()
            for k, t in named_leaves(params).items()}


@contextlib.contextmanager
def relu_inputs(store: list):
    """While active, keep a host copy of every FFN's ReLU input (the
    encoder's layers, then the decoder's)."""
    from nanodecoder_tpu_torch.models import modules

    real = modules.ffn

    def ffn(p, x, *args, **kwargs):
        store.append(modules.dense(p["in"], x).detach().cpu())
        return real(p, x, *args, **kwargs)

    modules.ffn = ffn
    try:
        yield
    finally:
        modules.ffn = real


def parity_gradients(step: int, gg: dict, gc: dict, label: str = "train parity") -> None:
    """A step's gradients, card (gg) against CPU (gc): within rtol 1e-4 /
    atol 1e-6 in all but 0.1% of the elements, and each tensor within
    1e-3 of its norm (+ 1e-6 sqrt(n)).  The elementwise tolerance cannot
    hold everywhere at this width: a ReLU whose input lies within
    rounding of 0 takes the other side on the card and moves its hidden
    unit's column, and everything below it a little."""
    over = total = 0
    worst, tensor = (0.0, ""), (0.0, "")
    for k, c in gc.items():
        d = (gg[k] - c).abs()
        ratio = d / (1e-6 + 1e-4 * c.abs())
        over, total = over + int((ratio > 1).sum()), total + c.numel()
        worst = max(worst, (float(ratio.max()), k))
        rel = float(d.norm() / (1e-3 * c.norm() + 1e-6 * c.numel() ** 0.5))
        tensor = max(tensor, (rel, k))
    print(f"{label} step {step}: gradients, {over} of {total} elements "
          f"({over / total:.4%}) outside rtol 1e-4 / atol 1e-6 (the worst at "
          f"{worst[0]:.2f} of its allowance, in {worst[1]}); the worst tensor's |card - CPU| "
          f"at {tensor[0]:.3f} of 1e-3 of its norm + 1e-6 sqrt(n), {tensor[1]}")
    check(over <= 1e-3 * total, f"{label}: {over} gradient elements differ")
    check(tensor[0] <= 1.0, f"{label}: the gradient of {tensor[1]} differs")


def train_parity(dev, model=None, flat=None, label="train parity", dropout=0.0,
                 steps=PARITY_STEPS):
    """(a) `steps` Adam steps at a constant lr PARITY_LR from the
    flagship params (or the flat params `flat` of the flagship with
    `model`'s overrides), at `dropout` (0, or 0.1: each trainer keys its
    masks from PRNGKey(train.seed), so the card draws the CPU's masks
    with kernel R1), batch 8, f32 without TF32, on the card
    and on the CPU, each step from the card's state (params and
    optimizer; from one state to the next the card's and the CPU's
    would part wherever Adam's first steps, about lr whatever a
    gradient's size, take opposite signs).  Each step: losses within rtol
    1e-4; the gradients as `parity_gradients` holds them; an optimizer on
    the host fed the card's gradients reproduces the card's params within
    atol 1e-6, so a wrong update on the card (a flipped sign, a lost bias
    correction, a wrong lr) fails; every param within 1e-4 of the CPU's,
    and within 1e-5 but for the elements whose gradient was non-zero and
    under 1e-6 on either side or outside the gradients' rtol 1e-4 /
    atol 1e-6, under 10% of them (5.2% in step 1: the flagship's
    gradients per token are small; 0.5% at the tiny config).  Returns the
    card's trainer and its batches."""
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import synthetic_batches
    from nanodecoder_tpu_torch.train.optim import Optimizer

    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    cfg = train_config(PARITY_BATCH, dropout=dropout, model=model)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(
        cfg.train, optimizer="adam", lr_schedule="constant", learning_rate=PARITY_LR))
    it = synthetic_batches(cfg, seed=0)
    batches = [next(it) for _ in range(steps + 1)]

    def start(device):
        return load_params_npz(NPZ, cfg.model, device=device) if flat is None \
            else params_from_numpy(flat, cfg.model, device)

    card, cpu = quiet_trainer(cfg, start(dev)), quiet_trainer(cfg, start("cpu"))
    # Held eager: each step is checked against the CPU's from the same
    # state, and the ReLU inputs are read on the host inside the forward.
    card._graphs = None
    replay = {k: v.requires_grad_(True) for k, v in host_leaves(card.params).items()}
    replay_opt = Optimizer(replay, cfg.train, cfg.model.d_model)
    t0 = time.perf_counter()
    for i, batch in enumerate(batches[:steps]):
        cpu.state = card.state
        zg, zc = [], []
        with relu_inputs(zg):
            mg = card.train_step(batch)
        with relu_inputs(zc):
            mc = cpu.train_step(batch)
        sides = [int(((a > 0) != (b > 0)).sum()) for a, b in zip(zg, zc)]
        lg, lc = float(mg["loss_sum"]), float(mc["loss_sum"])
        gg, gc = host_leaves(card.params, grad=True), host_leaves(cpu.params, grad=True)
        for k, t in replay.items():
            t.grad = gg[k]
        replay_opt.step()
        pg, pc = host_leaves(card.params), host_leaves(cpu.params)
        update = max(float((replay[k].detach() - v).abs().max()) for k, v in pg.items())
        every = max(float((pg[k] - pc[k]).abs().max()) for k in pc)
        held, n_ex, n_all = 0.0, 0, 0
        for k, c in gc.items():
            d = (gg[k] - c).abs()
            lo, hi = torch.minimum(gg[k].abs(), c.abs()), torch.maximum(gg[k].abs(), c.abs())
            exempt = ((lo < 1e-6) & (hi > 0)) | (d > 1e-6 + 1e-4 * c.abs())
            held = max(held, float((pg[k] - pc[k]).abs().masked_fill(exempt, 0).max()))
            n_ex, n_all = n_ex + int(exempt.sum()), n_all + c.numel()
        print(f"{label} step {i + 1}: loss_sum card {lg:.6f} CPU {lc:.6f} "
              f"(rel {abs(lg - lc) / abs(lc):.2e}), tokens {int(mg['n_tokens'])} / "
              f"{int(mc['n_tokens'])}; params (lr {PARITY_LR:.0e}): max |card - host's "
              f"update on the card's gradients| {update:.3e}, max |card - CPU| {every:.3e}, "
              f"{held:.3e} over the elements held ({n_ex} exempt, {n_ex / n_all:.4%}); "
              f"ReLU inputs on the other side of 0 on the card, by FFN: {sides} (largest "
              f"|card - CPU| input "
              f"{max((float((a - b).abs().max()) for a, b in zip(zg, zc)), default=0.0):.1e})")
        check(int(mg["n_tokens"]) == int(mc["n_tokens"]), f"{label}: token counts")
        check(abs(lg - lc) <= 1e-4 * abs(lc), f"{label}: loss {lg} vs {lc}")
        check(update <= 1e-6, f"{label}: the card's update differs by {update}")
        check(every <= 1e-4 and held <= 1e-5, f"{label}: params differ by {every}, "
              f"{held} over the elements held")
        check(n_ex < 0.1 * n_all, f"{label}: {n_ex} of {n_all} elements exempt")
        parity_gradients(i + 1, gg, gc, label)
    print(f"{label}: {steps} steps at dropout {dropout}, {time.perf_counter() - t0:.1f} s "
          f"with the CPU's steps")
    return card, batches


def profile_train_steps(trainer, batches) -> dict:
    """Train steps under torch.profiler: the window's wall (host clock to
    a synchronize), device busy time (the sum of its kernels' times), the
    idle share, kernels per step and the costliest kernels by name."""
    from torch.autograd import DeviceType

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for batch in batches:
            trainer.train_step(batch)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    # Device events less the ranges that record_function marks on the
    # device, which span kernels.
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA
               and not getattr(e, "is_user_annotation", False)]
    check(bool(kernels), "train profile: the profiler recorded no device time")
    busy_us = sum(e.time_range.elapsed_us() for e in kernels)
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    n = len(batches)
    print(f"train f32 profiled, {n} steps: wall {wall_us / 1e3 / n:.2f} ms a step, device "
          f"busy {busy_us / 1e3 / n:.2f} ms a step, idle share {1 - busy_us / wall_us:.3f}, "
          f"{len(kernels) / n:.0f} kernels a step; costliest: "
          + "; ".join(f"{us / 1e3 / n:.2f} ms {name[:60]}" for name, us in top))
    return {"profiled_step_ms": wall_us / 1e3 / n, "device_busy_ms": busy_us / 1e3 / n,
            "idle_share": 1 - busy_us / wall_us, "kernels_per_step": len(kernels) / n}


def train_learning(dev):
    """(b) From init_model (seed 0), f32, batch 32, LEARN_STEPS steps of
    simulated batches behind prefetch_batches: every loss finite, the mean
    of the last 10 below that of the first 10; step time (CUDA events),
    rates, peak memory and the host's wait for data.  Then BF16_STEPS
    steps in bf16 (losses finite).  Returns the numbers."""
    from nanodecoder_tpu_torch.models.model import init_model, params_to
    from nanodecoder_tpu_torch.prng import PRNGKey
    from nanodecoder_tpu_torch.train.data import prefetch_batches, synthetic_batches

    cfg = train_config(32)
    trainer = quiet_trainer(cfg, params_to(init_model(PRNGKey(0),
                                                      cfg.model), dev))
    it = prefetch_batches(synthetic_batches(cfg, seed=cfg.train.seed))
    losses, step_ms, waits, tokens = [], [], [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(LEARN_STEPS):
        t0 = time.perf_counter()
        batch = next(it)
        waits.append(time.perf_counter() - t0)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        m = trainer.train_step(batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        tokens.append(int(m["n_tokens"]))
        losses.append(float(m["loss_sum"]) / tokens[-1])
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    profiled = profile_train_steps(trainer, [next(it) for _ in range(PROFILED_STEPS)])
    it.close()
    check(all(math.isfinite(x) for x in losses), f"train: non-finite loss in {losses}")
    first, last = float(np.mean(losses[:10])), float(np.mean(losses[-10:]))
    ms = statistics.median(step_ms[2:])
    b, s = cfg.train.batch_size, cfg.signal.chunk_len
    tok_s = float(np.mean(tokens)) / (ms / 1e3)
    print(f"train f32 b{b}: {LEARN_STEPS} steps, loss per token first 10 {first:.4f} "
          f"last 10 {last:.4f} (step 1 {losses[0]:.4f}, step {LEARN_STEPS} "
          f"{losses[-1]:.4f}); median step {ms:.2f} ms (CUDA events, steps 3-"
          f"{LEARN_STEPS}), {b / ms * 1e3:.1f} chunks/s, {b * s / ms:.1f} "
          f"ksamples/s, {tok_s:.0f} target tokens/s; peak memory {peak:.0f} MiB; host "
          f"wait for data median {statistics.median(waits) * 1e3:.2f} ms, mean "
          f"{float(np.mean(waits[1:])) * 1e3:.2f} ms per step")
    check(last < first, f"train: loss did not fall ({first} -> {last})")

    bf_cfg = train_config(32, "bfloat16")
    bf = quiet_trainer(bf_cfg, params_to(init_model(PRNGKey(0),
                                                    bf_cfg.model), dev))
    bf_it = synthetic_batches(bf_cfg, seed=1)
    bf_losses, bf_ms = [], []
    for _ in range(BF16_STEPS):
        batch = next(bf_it)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        m = bf.train_step(batch)
        end.record()
        end.synchronize()
        bf_ms.append(start.elapsed_time(end))
        bf_losses.append(float(m["loss_sum"]) / int(m["n_tokens"]))
    check(all(math.isfinite(x) for x in bf_losses), f"train bf16: losses {bf_losses}")
    print(f"train bf16 b{b}: {BF16_STEPS} steps, losses finite ({bf_losses[0]:.4f} -> "
          f"{bf_losses[-1]:.4f}), median step {statistics.median(bf_ms[2:]):.2f} ms")
    return {**profiled, "step_ms": ms,
                     "bf16_step_ms": statistics.median(bf_ms[2:]),
                     "chunks_per_s": b / ms * 1e3, "ksamples_per_s": b * s / ms,
                     "tokens_per_s": tok_s, "host_wait_ms": float(np.mean(waits[1:])) * 1e3,
                     "peak_mib": peak, "loss_first10": first, "loss_last10": last}


def train_validation(params, dev, reset, counts) -> dict:
    """(c) synthetic_valid_batches (4 of 32) through the eval step on
    `params` (those of (a)'s trainer, which start from the flagship and
    read the encoder's memory) with use_pallas (K5 in every encoder
    layer) and without: K5 launches 6 x 4 and 0, xent_sum within rtol
    1e-4, n_correct within 0.1% of the tokens.  Returns the kernel run's
    launches."""
    from nanodecoder_tpu_torch.train.data import synthetic_valid_batches
    from nanodecoder_tpu_torch.train.trainer import batch_to_device, make_eval_step

    cfg = train_config(32)
    plain = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                               use_pallas=False))
    valid = [batch_to_device(b, dev) for b in synthetic_valid_batches(cfg, n_batches=4)]
    out = {}
    for name, c in (("K5", cfg), ("plain", plain)):
        step = make_eval_step(c)
        for b in valid:  # warm up, then time the 4 batches
            step(params, b)
        reset()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        ms = [step(params, b) for b in valid]
        end.record()
        end.synchronize()
        out[name] = ({k: sum(int(m[k]) if k.startswith("n_") else float(m[k])
                             for m in ms) for k in ms[0]},
                     start.elapsed_time(end), counts())
    (mk, ms_k, ck), (mp, ms_p, cp) = out["K5"], out["plain"]
    layers = cfg.model.enc_layers
    print(f"validation 4 x b{cfg.train.batch_size}, (a)'s params: with K5 {ms_k:.2f} ms, "
          f"plain {ms_p:.2f} ms; xent_sum {mk['xent_sum']:.4f} vs {mp['xent_sum']:.4f} "
          f"({mp['xent_sum'] / mp['n_tokens']:.4f} a token), n_correct {mk['n_correct']} "
          f"vs {mp['n_correct']} of {mk['n_tokens']} tokens; "
          f"K5 launches {ck['K5']} and {cp['K5']}")
    check(ck["K5"] == layers * 4 and cp["K5"] == 0,
          f"validation: K5 launched {ck['K5']} / {cp['K5']} times, expected {layers * 4} / 0")
    check(all(n == 0 for k, n in ck.items() if k != "K5"), f"validation launches {ck}")
    check(mk["n_tokens"] == mp["n_tokens"], "validation: token counts differ")
    check(abs(mk["xent_sum"] - mp["xent_sum"]) <= 1e-4 * abs(mp["xent_sum"]),
          "validation: xent_sum differs beyond rtol 1e-4")
    check(abs(mk["n_correct"] - mp["n_correct"]) <= 1e-3 * mk["n_tokens"],
          "validation: n_correct differs beyond 0.1% of the tokens")
    return {"valid_ms_k5": ms_k, "valid_ms_plain": ms_p, "launches": ck}


def train_checkpoint_serve(card, batches, dev, tmp: str, phase4: dict) -> float:
    """(d) Save (a)'s trainer, restore it into a fresh trainer, one more
    step on each (equal within 1e-6, dropout 0, deterministic cuDNN); then
    the restored params served by Translator (bf16, int6 wire) on the
    first 20 reads of phase 4 (mean identity >= 0.90).  Returns the
    identity."""
    from nanodecoder_tpu_torch.models.model import init_model, params_to
    from nanodecoder_tpu_torch.prng import PRNGKey
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager

    ckpt = CheckpointManager(os.path.join(tmp, "ck"), card.config)
    ckpt.save(card.step, card.state)
    fresh = quiet_trainer(card.config, params_to(init_model(
        PRNGKey(1), card.config.model), dev))
    fresh.state = ckpt.restore(device=dev)
    restored = max_param_diff(fresh.params, card.params)
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        card.train_step(batches[2])
        fresh.train_step(batches[2])
    finally:
        torch.backends.cudnn.deterministic = deterministic
    diff = max_param_diff(fresh.params, card.params)
    print(f"checkpoint: saved and restored step {ckpt.latest_step()} (max |restored - "
          f"saved| {restored:.1e}); one more step on each, max |resumed - "
          f"uninterrupted| {diff:.3e}")
    check(restored == 0.0 and diff <= 1e-6, f"checkpoint: resumed run differs by {diff}")
    from nanodecoder_tpu_torch.decode.translator import Translator

    serve = load_config("bfloat16", "int6", 640)
    tr = Translator(ckpt.restore(device=dev).params, serve)
    idents, _samples, _wall, _seqs = call_reads(tr, simulated_reads(20))
    mean_id = float(np.mean(idents))
    print(f"served from the checkpoint (bf16/int6/b640): 20 reads, mean identity "
          f"{mean_id:.4f} (the flagship's on the same reads, phase 4: "
          f"{float(np.mean(phase4['idents'][:20])):.4f})")
    check(mean_id >= 0.90, f"served from the checkpoint: mean identity {mean_id} < 0.90")
    return mean_id


def train_clis(tmp: str, root: str) -> None:
    """(e) cli.preprocess --synthetic 320, cli.train --data for 5 steps,
    then --resume to 8, then cli.evaluate on the checkpoint directory:
    each exits 0, steps 5 and 8 are saved, 2 reads are evaluated."""
    cfg = train_config(32)
    cfg_path = os.path.join(tmp, "train_config.json")
    with open(cfg_path, "w") as f:
        f.write(cfg.to_json())
    shards, ck = os.path.join(tmp, "shards"), os.path.join(tmp, "cli_ck")
    runs = [("preprocess", ["--out", shards, "--config", cfg_path, "--synthetic", "320",
                            "--shard-size", "160"]),
            ("train", ["--ckpt-dir", ck, "--config", cfg_path, "--data", shards,
                       "--steps", "5", "--report-every", "1"]),
            ("train", ["--ckpt-dir", ck, "--config", cfg_path, "--data", shards,
                       "--steps", "8", "--resume", "--report-every", "1"]),
            ("evaluate", ["--ckpt", ck, "--simulate", "2", "--read-bases", "1000",
                          "--json"])]
    walls = []
    for cli, args in runs:
        t0 = time.perf_counter()
        res = subprocess.run([sys.executable, "-m", f"nanodecoder_tpu_torch.cli.{cli}",
                              *args], cwd=root, capture_output=True, text=True,
                             timeout=600)
        walls.append(time.perf_counter() - t0)
        check(res.returncode == 0, f"cli.{cli} exit {res.returncode}: {res.stderr[-2000:]}")
    steps = sorted(int(n) for n in os.listdir(ck) if n.isdigit())
    summary = json.loads(res.stdout.strip().splitlines()[-1])
    print(f"CLIs: preprocess (320 examples, 2 shards), train 5 steps, resume to 8, evaluate "
          f"the checkpoint directory (2 reads, identity {summary['mean_identity']:.4f} after "
          f"8 steps from init): exit 0, checkpoints {steps}; process walls "
          + ", ".join(f"{w:.1f} s" for w in walls))
    check(steps == [5, 8], f"train CLI: checkpoint steps {steps}, expected [5, 8]")
    check(summary["n_reads"] == 2, f"evaluate CLI on the checkpoint: {summary}")


def phase_train(dev, reset, counts, phase4: dict, root: str) -> tuple[dict, dict, dict]:
    """Phase 13: training at the flagship's full width (a)-(e).  Returns
    (the training path's launches (a)-(c), the serving launches of (d),
    the numbers)."""
    print("train: flagship width, committed train section, overrides "
          + ", ".join(f"{k} {v}" for k, v in TRAIN_OVERRIDES.items())
          + f"; use_pallas true; parity batch {PARITY_BATCH} dropout 0 adam constant lr "
          f"{PARITY_LR:.0e}, then {DROPOUT_PARITY_STEPS} at dropout 0.1; learning batch "
          f"32 {LEARN_STEPS} f32 steps + {BF16_STEPS} bf16 steps at dropout "
          f"{train_config(32).model.dropout}")
    from nanodecoder_tpu_torch.utils.profiling import counters

    tmp = tempfile.mkdtemp(prefix="chip_smoke_train_")
    try:
        reset()
        graphs0 = counters()
        card, batches = train_parity(dev)
        train_parity(dev, label="train parity, dropout 0.1", dropout=0.1,
                     steps=DROPOUT_PARITY_STEPS)
        numbers = train_learning(dev)
        # The training steps launch no kernel but R1, once a dropout draw
        # of a step that is not replayed.
        stepped = counts()
        graphs = {k: counters().get(f"train.graph_{k}", 0) - graphs0.get(f"train.graph_{k}", 0)
                  for k in ("captures", "replays")}
        steps = DROPOUT_PARITY_STEPS + LEARN_STEPS + PROFILED_STEPS + BF16_STEPS
        want = train_draws(train_config(32).model) * (
            steps - graphs["replays"] + graphs["captures"])
        print(f"training steps: {graphs['captures']} graphs captured, {graphs['replays']} "
              f"replays; R1 launched {stepped['R1']} times ({want} expected: "
              f"{train_draws(train_config(32).model)} dropout draws a step not replayed)")
        check(graphs == {"captures": 2, "replays": LEARN_STEPS + PROFILED_STEPS + BF16_STEPS - 2},
              f"training steps: graphs {graphs}, expected (b)'s two trainers to capture at "
              "their second step and replay every later one")
        check(stepped["R1"] == want and all(n == 0 for k, n in stepped.items() if k != "R1"),
              f"training steps launched {stepped}, expected R1 {want} and nothing else")
        numbers.update(train_validation(card.params, dev, reset, counts))
        launches = {k: n + stepped[k] for k, n in numbers.pop("launches").items()}
        reset()
        numbers["served_identity"] = train_checkpoint_serve(card, batches, dev, tmp,
                                                            phase4)
        serving = counts()
        check(serving["K1"] > 0 and serving["K2"] > 0 and serving["K5"] == 0,
              f"served from the checkpoint: launches {serving}")
        train_clis(tmp, root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, serving, numbers


# Phase 14: the recurrent family at the RNN flagship's widths (the
# committed config with a biLSTM encoder and the input-feed RNN decoder,
# "general" Luong attention) and the two hybrids, with random params.
RNN_MODEL = {"encoder_type": "lstm", "decoder_type": "rnn"}
RNN_SEED, RNN_TRAIN_STEPS, RNN_CELL_SCALE = 14, 10, 3.0


def rnn_config(compute_dtype: str, h2d: str, model=None, batch: int = 640, **decode):
    """The RNN flagship (or a hybrid, with `model`'s overrides) with these
    serving settings, kernel route.  The card-vs-CPU runs take batches of
    32 chunks (a golden read has at most 25): the CPU would otherwise run
    the biLSTM over 640 rows a read, mostly padding."""
    return load_config(compute_dtype, h2d, batch, model={**RNN_MODEL, **(model or {})},
                       **decode)


def rnn_flat(cfg) -> dict:
    """Phase 14's random flat params at cfg's shapes."""
    from nanodecoder_tpu_torch.profile_serving import random_params

    return random_params(cfg.model, RNN_SEED, rnn_cell_scale=RNN_CELL_SCALE)


def golden_signals():
    """[(read id, signal)] of the three golden reads' simulated signals."""
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    spec = SimSpec()
    levels = spec.level_table()
    return [(f"golden_{seed}", simulate_read(np.random.default_rng(seed), n, spec, levels)[1])
            for seed, n in GOLDEN_READS]


def call_read_chunks(tr, sig):
    """Basecall one read as Translator.basecall_read does (trim stitch),
    keeping the chunks' tokens: (sequence, qualities, tokens (N, T),
    token lengths (N,))."""
    from nanodecoder_tpu_torch.decode.finish import stitch_read
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal

    sc = tr.config.signal
    cb = chunk_signal(normalize_signal(sig, sc.normalization, sc.mad_scale, sc.clip_sigma),
                      sc.chunk_len, sc.chunk_overlap, sc.min_chunk_fill)
    tokens, lengths, lps, _scores, pos = tr.decode_chunk_batch(cb.chunks, cb.lengths)
    parts = [(tokens[i], int(lengths[i]), lps[i], pos[i]) for i in range(cb.n_chunks)]
    seq, qual = stitch_read(parts, cb.starts, cb.lengths, sc.chunk_len, sc.chunk_overlap,
                            "trim", tr.vocab)
    return seq, qual, tokens, lengths


def rnn_greedy_parity(params, cfg, label: str, reads) -> None:
    """Greedy basecalls of `reads` on the card and on the CPU from the same
    params: identity of the two at least 0.99 on each read; the share of
    chunks with equal tokens and the chunks ended by EOS printed."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    card, cpu = Translator(params, cfg), Translator(params, cfg, device="cpu")
    tmax = cfg.model.max_decode_len
    bases = 0
    for rid, sig in reads:
        seq, qual, tok, lens = call_read_chunks(card, sig)
        ref, _q, rtok, rlens = call_read_chunks(cpu, sig)
        ident = read_identity(seq, ref)
        same = [bool(a == b and (t[:a] == r[:b]).all())
                for t, a, r, b in zip(tok, lens, rtok, rlens)]
        print(f"{label}: {rid} card vs CPU identity {ident:.4f} ({len(seq)} / {len(ref)} "
              f"bases), chunks with equal tokens {sum(same)}/{len(same)}, ended by EOS "
              f"{int((lens < tmax).sum())}/{len(lens)}")
        check(bool(np.isfinite(qual).all()) and len(qual) == len(seq),
              f"{label}: {rid} bad qualities")
        check(ident >= 0.99, f"{label}: {rid} identity {ident} below 0.99")
        bases += len(seq)
    # Two empty calls would agree vacuously.
    check(bases > 0, f"{label}: no read called a base")


def rnn_serving(params, cfg, record: dict) -> dict:
    """(b) bf16, int6 wire, batch 640, greedy: the first 20 reads of phase 4
    through Translator (every read a finite score; ksamples/s), then one
    full 640-chunk batch timed apart, encode and decode (CUDA-synchronized
    host clock, after one warm-up batch).  Fills `record` with the reads'
    sequences; returns the numbers."""
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.io.signal import convert_h2d

    tr = Translator(params, cfg)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    calls = [tr.basecall_read(RawRead(f"sim{i}", sig, "sim"), stitch_method="attn")
             for i, (_truth, sig) in enumerate(simulated_reads(20))]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    samples = sum(bc.n_samples for bc in calls)
    check(all(math.isfinite(bc.mean_qscore) and bool(np.isfinite(bc.qualities).all())
              for bc in calls), "rnn serving: a read without a finite score")
    record["seqs"] = [bc.sequence for bc in calls]
    sc, bsz = cfg.signal, cfg.decode.effective_batch_chunks()
    chunks, lengths = batch_of_chunks(sc, bsz, 60)
    wire = convert_h2d(chunks.astype(np.float32), tr._h2d, sc.clip_sigma)
    times = []
    with torch.inference_mode():
        for _ in range(2):  # a warm-up batch, then the timed one
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mem, mlen = tr._encode(wire, lengths)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            res = greedy_decode(tr.params, cfg.model, mem, mlen)
            torch.cuda.synchronize()
            times.append(((t1 - t0) * 1e3, (time.perf_counter() - t1) * 1e3, res.steps))
    enc_ms, dec_ms, steps = times[-1]
    m = cfg.model
    t_enc = -(-sc.chunk_len // m.time_downsample)
    cell_steps = t_enc * m.enc_layers * 2
    print(f"rnn serving bf16/int6/b{bsz}: 20 reads, {tr.batches} batches, "
          f"{samples / wall / 1e3:.1f} ksamples/s wall ({wall:.2f} s); one full batch of "
          f"{bsz} chunks: encode {enc_ms:.1f} ms ({cell_steps} sequential LSTM cell steps, "
          f"{t_enc} x {m.enc_layers} layers x 2 directions, run as {t_enc * m.enc_layers} "
          f"steps of both directions; {enc_ms / (t_enc * m.enc_layers) * 1e3:.0f} us a "
          f"step), decode {dec_ms:.1f} ms for {steps} steps "
          f"({dec_ms / max(steps, 1):.3f} ms a step), chunks ended by EOS "
          f"{int((res.lengths < m.max_decode_len).sum())}/{bsz}")
    check(bool(torch.isfinite(res.scores).all()), "rnn serving: a non-finite chunk score")
    return {"rnn_serve_ksamples_per_s": samples / wall / 1e3, "rnn_encode_ms": enc_ms,
            "rnn_decode_ms": dec_ms, "rnn_decode_steps": steps,
            "rnn_encoder_cell_steps": cell_steps}


def rnn_train(dev) -> dict:
    """(d) phase 13 (a)'s parity on (lstm, rnn) from random params (two Adam
    steps, constant lr 4e-5, batch 8, dropout 0, f32 without TF32, each
    step from the card's state, the same gates), then RNN_TRAIN_STEPS
    steps from init_model at batch 32 with the committed train section
    (losses finite; median step ms by CUDA events, peak memory)."""
    from nanodecoder_tpu_torch.models.model import init_model, params_to
    from nanodecoder_tpu_torch.prng import PRNGKey
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    cfg = train_config(PARITY_BATCH, dropout=0.0, model=RNN_MODEL)
    train_parity(dev, RNN_MODEL, rnn_flat(cfg), "rnn train parity")
    cfg = train_config(32, model=RNN_MODEL)
    trainer = quiet_trainer(cfg, params_to(init_model(PRNGKey(0),
                                                      cfg.model), dev))
    it = synthetic_batches(cfg, seed=cfg.train.seed)
    losses, step_ms = [], []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    for _ in range(RNN_TRAIN_STEPS):
        batch = next(it)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(
            enable_timing=True)
        start.record()
        m = trainer.train_step(batch)
        end.record()
        end.synchronize()
        step_ms.append(start.elapsed_time(end))
        losses.append(float(m["loss_sum"]) / int(m["n_tokens"]))
    peak = torch.cuda.max_memory_allocated() / 2 ** 20
    ms = statistics.median(step_ms[2:])
    b, s = cfg.train.batch_size, cfg.signal.chunk_len
    print(f"rnn train f32 b{b}: {RNN_TRAIN_STEPS} steps from init_model, loss per token "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; median step {ms:.2f} ms (CUDA events, "
          f"steps 3-{RNN_TRAIN_STEPS}), {b * s / ms:.1f} ksamples/s; peak memory "
          f"{peak:.0f} MiB")
    check(all(math.isfinite(x) for x in losses), f"rnn train: non-finite loss in {losses}")
    return {"rnn_train_step_ms": ms, "rnn_train_peak_mib": peak}


def opennmt_state_dict(cfg, seed: int) -> dict:
    """A synthetic OpenNMT-py state_dict in the reference's names and torch
    layouts for cfg (transformer or biLSTM encoder, transformer decoder
    with dec_kv K/V heads) from a numpy seed: weights N(0, 2 / (fan_in +
    fan_out)), biases N(0, 0.02^2), LN scales 1 + N(0, 0.02^2), the
    generator's weights scaled 3x as random_params does."""
    rng = np.random.default_rng(seed)
    d, dk = cfg.d_model, cfg.d_model // cfg.dec_heads * cfg.dec_kv
    sd = {}

    def put(name, arr):
        sd[name] = torch.from_numpy(np.asarray(arr, np.float32))

    def linear(prefix, n_out, n_in, scale=1.0):
        put(f"{prefix}.weight", rng.standard_normal((n_out, n_in))
            * np.sqrt(2.0 / (n_in + n_out)) * scale)
        put(f"{prefix}.bias", rng.standard_normal(n_out) * 0.02)

    def ln(prefix):
        put(f"{prefix}.weight", 1.0 + rng.standard_normal(d) * 0.02)
        put(f"{prefix}.bias", rng.standard_normal(d) * 0.02)

    def mha(prefix, kv):
        for part, n_out in (("linear_query", d), ("linear_keys", kv),
                            ("linear_values", kv), ("final_linear", d)):
            linear(f"{prefix}.{part}", n_out, d)

    def ffn(prefix, width):
        linear(f"{prefix}.w_1", width, d)
        linear(f"{prefix}.w_2", d, width)
        ln(f"{prefix}.layer_norm")

    in_ch = 1
    for i, (ch, k) in enumerate(zip(cfg.conv_channels, cfg.conv_kernels)):
        put(f"encoder.frontend.convs.{i}.weight", rng.standard_normal((ch, in_ch, k))
            * np.sqrt(2.0 / (in_ch * k + ch)))
        put(f"encoder.frontend.convs.{i}.bias", np.zeros(ch))
        in_ch = ch
    linear("encoder.frontend.proj", d, in_ch)
    ln("encoder.frontend.ln")
    for i in range(cfg.enc_layers):
        if cfg.encoder_type == "lstm":
            h = cfg.lstm_hidden
            for direction in ("fwd", "bwd"):
                p = f"encoder.rnn.{i}.{direction}"
                put(f"{p}.weight_ih_l0", rng.standard_normal((4 * h, d))
                    * np.sqrt(2.0 / (d + 4 * h)))
                put(f"{p}.weight_hh_l0", rng.standard_normal((4 * h, h))
                    * np.sqrt(2.0 / (h + 4 * h)))
                put(f"{p}.bias_ih_l0", rng.standard_normal(4 * h) * 0.02)
                put(f"{p}.bias_hh_l0", rng.standard_normal(4 * h) * 0.02)
            linear(f"encoder.rnn.{i}.proj", d, 2 * h)
        else:
            mha(f"encoder.transformer.{i}.self_attn", d)
            ln(f"encoder.transformer.{i}.layer_norm")
            ffn(f"encoder.transformer.{i}.feed_forward", cfg.enc_ffn_dim)
    ln("encoder.layer_norm")
    for i in range(cfg.dec_layers):
        p = f"decoder.transformer_layers.{i}"
        mha(f"{p}.self_attn", dk)
        mha(f"{p}.context_attn", dk)
        ln(f"{p}.layer_norm_1")
        ln(f"{p}.layer_norm_2")
        ffn(f"{p}.feed_forward", cfg.dec_ffn_dim)
    ln("decoder.layer_norm")
    put("decoder.embeddings.weight", rng.standard_normal((cfg.vocab_size, d)) / np.sqrt(d))
    linear("generator", cfg.vocab_size, d, scale=3.0)
    return sd


def rnn_import(dev, reads) -> None:
    """(e) A synthetic OpenNMT state_dict for the biLSTM encoder + the
    flagship's transformer decoder (MQA) saved as a reference-shaped .pt
    ({'model', 'generator' as 0.weight / 0.bias}), loaded by
    load_torch_checkpoint onto the card and onto the CPU: greedy on the
    golden reads, card vs CPU (0.99)."""
    from nanodecoder_tpu_torch.models.importer import load_torch_checkpoint

    cfg = rnn_config("float32", "float32", model={"decoder_type": "transformer"}, batch=32)
    sd = opennmt_state_dict(cfg.model, RNN_SEED)
    gen = {"0.weight": sd.pop("generator.weight"), "0.bias": sd.pop("generator.bias")}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_import_")
    try:
        path = os.path.join(tmp, "reference.pt")
        torch.save({"model": sd, "generator": gen, "opt": None}, path)
        params = load_torch_checkpoint(path, cfg.model, device=dev)
        cpu = load_torch_checkpoint(path, cfg.model, device="cpu")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(max_param_diff(params, cpu) == 0.0, "rnn import: card and CPU imports differ")
    check(next(iter(params["generator"].values())).device.type == "cuda",
          "rnn import: params not on the card")
    rnn_greedy_parity(params, cfg, "rnn import (lstm, transformer) f32", reads)


def rnn_engine(params, cfg, record: dict) -> None:
    """(f) The streaming engine with (b)'s params and config at 256-chunk
    batches, greedy, on the first 20 reads of phase 4 written as signal
    files: every read back once, mean identity to (b)'s Translator calls
    (attn stitch) at least 0.99."""
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode,
                                                              batch_chunks_engine=256))
    fmt, _found = signal_file_format()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_rnn_engine_")
    try:
        reads = simulated_reads(20)
        files = write_signal_files(tmp, [(f"sim{i}", sig) for i, (_t, sig) in
                                         enumerate(reads)], fmt)
        with (npz_ingest() if fmt == "npz" else contextlib.nullcontext()):
            t0 = time.perf_counter()
            seqs, meter, timer, _engine = engine_call(params, cfg, files, "rnn engine")
            wall = time.perf_counter() - t0
    finally:
        stop_ingest_processes()
        shutil.rmtree(tmp, ignore_errors=True)
    check(sorted(seqs) == sorted(f"sim{i}" for i in range(20)),
          f"rnn engine: {len(seqs)} reads back of 20")
    idents = [read_identity(seqs[f"sim{i}"], ref) for i, ref in enumerate(record["seqs"])]
    print(f"rnn engine bf16/int6/b256 greedy ({fmt}): 20 reads back once, identity to "
          f"(b)'s Translator calls mean {np.mean(idents):.4f} (min {min(idents):.4f}), "
          f"{meter.n_samples / wall / 1e3:.1f} ksamples/s ({wall:.2f} s with the ingest "
          f"pool's start); {stage_line(timer)}")
    check(float(np.mean(idents)) >= 0.99, f"rnn engine: identity {np.mean(idents)} < 0.99")


def phase_rnn(dev, reset, counts, expect) -> tuple[dict, dict]:
    """Phase 14 (a)-(f): the recurrent family on the card against the
    port's own CPU run, with random params (RNN_SEED) at the RNN
    flagship's widths.  Returns (launches by path, numbers)."""
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    t0 = time.perf_counter()
    reads = golden_signals()
    paths, numbers = {}, {}
    beam = {"mode": "beam", "beam_size": 5, "batch_chunks_beam": 8}
    cfg = rnn_config("float32", "float32", batch=32)
    params = params_from_numpy(rnn_flat(cfg), cfg.model, dev)
    print(f"rnn: (lstm, rnn) at the flagship's widths (d {cfg.model.d_model}, lstm_hidden "
          f"{cfg.model.lstm_hidden}, {cfg.model.enc_layers} + {cfg.model.dec_layers} "
          f"layers, {cfg.model.rnn_attention} attention), random params seed {RNN_SEED}")
    reset()  # (a) and (b): the rnn path
    rnn_greedy_parity(params, cfg, "rnn f32 greedy", reads)
    _pb, psteps, _ = phase_beam_parity(params, rnn_config("float32", "float32", **beam),
                                       label="rnn beam f32/K5")
    for score in ("dot", "mlp"):
        scfg = rnn_config("float32", "float32", model={"rnn_attention": score}, batch=32)
        rnn_greedy_parity(params_from_numpy(rnn_flat(scfg), scfg.model, dev), scfg,
                          f"rnn {score} attention f32 greedy", reads[:1])
    serve = rnn_config("bfloat16", "int6")
    served = {}
    numbers.update(rnn_serving(params, serve, served))
    _bb, bsteps = phase_beam_serving(params, rnn_config(
        "bfloat16", "int6", **{**beam, "batch_chunks_beam": 256}), label="rnn beam")
    paths["rnn"] = counts()
    expect("rnn", paths["rnn"], K1=0, K2=0, K3=psteps + bsteps, K4a=0, K4b=0, K5=0)
    check(psteps + bsteps > 0, "rnn: no beam step ran")
    print(f"[phase 14] (a)-(b) {time.perf_counter() - t0:.1f} s")

    reset()  # (c): the hybrids
    for model, label in (({"encoder_type": "transformer"}, "transformer + rnn lean"),
                         ({"decoder_type": "transformer"}, "lstm + transformer lean MQA")):
        hcfg = rnn_config("float32", "float32", model=model, batch=32)
        hp = params_from_numpy(rnn_flat(hcfg), hcfg.model, dev)
        rnn_greedy_parity(hp, hcfg, f"rnn hybrid {label} f32 greedy", reads)
        phase_beam_parity(hp, rnn_config("float32", "float32", model=model, **beam),
                          label=f"rnn hybrid {label} beam f32/K5")
    paths["rnn_hybrid"] = counts()
    expect("rnn_hybrid", paths["rnn_hybrid"], K4a=0, K4b=0, K5=0)
    check(all(paths["rnn_hybrid"][k] > 0 for k in ("K1", "K2", "K3")),
          f"rnn_hybrid path: launches {paths['rnn_hybrid']}")
    print(f"[phase 14] (c) {time.perf_counter() - t0:.1f} s")

    reset()  # (d): training launches no kernel
    numbers.update(rnn_train(dev))
    paths["rnn_train"] = counts()
    check(all(n == 0 for n in paths["rnn_train"].values()),
          f"rnn training launched {paths['rnn_train']}")
    print(f"[phase 14] (d) {time.perf_counter() - t0:.1f} s")

    reset()  # (e): the importer
    rnn_import(dev, reads)
    paths["rnn_import"] = counts()
    expect("rnn_import", paths["rnn_import"], K1=0, K3=0, K4a=0, K4b=0, K5=0)
    check(paths["rnn_import"]["K2"] > 0, "rnn_import path: K2 not launched")
    print(f"[phase 14] (e) {time.perf_counter() - t0:.1f} s")

    reset()  # (f): the engine
    rnn_engine(params, serve, served)
    paths["rnn_engine"] = counts()
    check(all(n == 0 for n in paths["rnn_engine"].values()),
          f"rnn engine launched {paths['rnn_engine']}")
    numbers["rnn_phase_s"] = time.perf_counter() - t0
    print(f"[phase 14] rnn: {numbers['rnn_phase_s']:.1f} s")
    return paths, numbers


# Phase 15: the decode modes on the MQA flagship (kernel route).
SAMPLE_SEEDS = (15, 16)
COVERAGE_BETA = 0.2
# Served identity floors under the coverage penalty.  "wu" at beta 0.2
# counts -log of every encoder frame's attention mass under 1, and a
# 2048-sample chunk has 256 frames against about 60 tokens: it pays
# hypotheses for length, and its calls read about 0.025 under greedy's
# (0.8953 on these 20 reads on an H100, against 0.9200).  The JAX package
# calls these reads so too: scripts/coverage_witness.py holds the port to
# it on them at f32 (its readings are in PERF.md section 2).
COVERAGE_MIN_IDENTITY = {"wu": 0.85, "summary": 0.90}


SAMPLE_LEAD = 1e-5  # a winning draw's lead above which card and CPU must agree


@contextlib.contextmanager
def sample_draws(store: list):
    """While active, record every draw of the sampler (on the CPU: a
    record on the card would add R1 launches): (its key, the lead of the
    winning noisy score over the runner-up in each row, the drawn
    tokens)."""
    from nanodecoder_tpu_torch import prng

    real = prng.categorical

    def categorical(key, logits, row0=0):
        out = real(key, logits, row0=row0)
        noisy = logits + prng.gumbel(key, logits.shape, device=logits.device,
                                     offset=row0 * logits.shape[-1])
        top2 = torch.topk(noisy, 2, dim=-1).values
        store.append((tuple(int(w) for w in key), (top2[:, 0] - top2[:, 1]).cpu().numpy(),
                      out.cpu().numpy()))
        return out
    prng.categorical = categorical
    try:
        yield
    finally:
        prng.categorical = real


def least_live_lead(draws: list, batch_keys) -> float:
    """The least lead of a winning draw over the rows still live (no EOS
    drawn before) in every step of the batches keyed by batch_keys (step t
    of batch b draws with fold_in(batch_keys[b], t))."""
    from nanodecoder_tpu_torch import prng
    from nanodecoder_tpu_torch.vocab import EOS_ID

    index = {tuple(int(w) for w in prng.fold_in(k, t)): (b, t)
             for b, k in enumerate(batch_keys) for t in range(256)}
    live, least = {}, math.inf
    for key, lead, chosen in draws:
        if key not in index:
            continue
        b, t = index[key]
        if t == 0:
            live[b] = np.ones(len(lead), bool)
        if live[b].any():
            least = min(least, float(lead[live[b]].min()))
        live[b] &= chosen != EOS_ID
    return least


class ModeRuns:
    """The launches of one decode mode's runs: each run starts from counts
    of 0 and adds what it launched, so the references run between them
    (greedy, the physical reorder, the CPU) count nowhere.  A run is
    fn(made): it appends what it ran on the card (a Translator, or any
    object with `batches` and `decode_steps`) to `made`."""

    def __init__(self, reset, counts):
        self.reset, self.counts = reset, counts
        self.launches = {name: 0 for name in counts()}
        self.batches = self.steps = 0

    def __call__(self, fn):
        self.reset()
        made = []
        out = fn(made)
        for name, n in self.counts().items():
            self.launches[name] += n
        self.batches += sum(x.batches for x in made)
        self.steps += sum(x.decode_steps for x in made)
        return out


def card_translator(made, params, cfg):
    from nanodecoder_tpu_torch.decode.translator import Translator

    tr = Translator(params, cfg)
    made.append(tr)
    return tr


def timed_batch(tr, chunks, lengths):
    """One decode_chunk_batch after a warm-up one: (outputs, ms per decode
    step, decode steps), on a CUDA-synchronized host clock."""
    tr.decode_chunk_batch(chunks, lengths)
    steps0 = tr.decode_steps
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = tr.decode_chunk_batch(chunks, lengths)
    torch.cuda.synchronize()
    steps = tr.decode_steps - steps0
    return out, (time.perf_counter() - t0) * 1e3 / max(steps, 1), steps


def same_calls(a, b) -> bool:
    """Equal tokens and token lengths of two decode_chunk_batch outputs."""
    return bool(np.array_equal(a[0], b[0]) and np.array_equal(a[1], b[1]))


def modes_sample(params, run, phase4: dict, numbers: dict) -> None:
    """Phase 15 (a)-(d): sample mode."""
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    reads = golden_signals()

    def golden_calls(made, cfg):
        tr = card_translator(made, params, cfg)
        return [call_read_chunks(tr, sig) for _rid, sig in reads]

    # (a) topk 1 keeps the argmax alone: the card's greedy call.
    want = golden_calls([], load_config("float32", "float32", 640))
    got = run(lambda made: golden_calls(made, load_config(
        "float32", "float32", 640, mode="sample", sampling_topk=1,
        sampling_seed=SAMPLE_SEEDS[0])))
    for (rid, _s), w, g in zip(reads, want, got):
        check(np.array_equal(w[2], g[2]) and np.array_equal(w[3], g[3]),
              f"sample topk 1: {rid} tokens differ from the greedy call")
    print("sample f32 topk 1: the 3 golden reads' tokens equal the card's greedy call")

    # (b) One sampling_seed on the card (R1 draws the noise) and on the CPU
    # (the plain version): the same threefry noise, so the tokens are equal
    # wherever every winning draw of a read leads by more than SAMPLE_LEAD.
    from nanodecoder_tpu_torch import prng

    rich = load_config("float32", "float32", 32, mode="sample", temperature=1.0,
                       sampling_topk=5, sampling_topp=0.9, sampling_seed=SAMPLE_SEEDS[0])
    card = run(lambda made: golden_calls(made, rich))
    cpu = Translator(params, rich, device="cpu")
    ref, leads = [], []
    for _rid, sig in reads:
        draws, first = [], cpu.sample_batches
        with sample_draws(draws):
            ref.append(call_read_chunks(cpu, sig))
        base = prng.PRNGKey(SAMPLE_SEEDS[0])
        leads.append(least_live_lead(draws, [prng.fold_in(base, b) for b in
                                             range(first, cpu.sample_batches)]))
    idents = [read_identity(c[0], r[0]) for c, r in zip(card, ref)]
    same = [np.array_equal(c[2], r[2]) and np.array_equal(c[3], r[3])
            for c, r in zip(card, ref)]
    print("sample f32 T 1.0 topk 5 topp 0.9, sampling_seed "
          f"{SAMPLE_SEEDS[0]} on each side: card vs CPU identity "
          + ", ".join(f"{x:.4f}" for x in idents)
          + f", tokens equal on {sum(same)}/3 reads; the least lead of a winning draw a "
          "read " + ", ".join(f"{x:.2e}" for x in leads))
    for (rid, _s), ident, eq, lead in zip(reads, idents, same, leads):
        if lead > SAMPLE_LEAD:
            check(eq, f"sample card vs CPU: {rid} tokens differ although every draw "
                  f"leads by {lead:.2e} > {SAMPLE_LEAD}")
        check(ident >= 0.99, f"sample card vs CPU: {rid} identity {ident} below 0.99")

    # (c) Served sample mode on phase 4's first 20 reads.
    sim = simulated_reads(20)

    def served(seed, temperature, n):
        cfg = load_config("bfloat16", "int6", 640, mode="sample", temperature=temperature,
                          sampling_seed=seed)
        return run(lambda made: call_reads(card_translator(made, params, cfg), sim[:n]))
    ids, samples, wall, seqs = served(SAMPLE_SEEDS[0], 0.3, 20)
    g_mean, s_mean = float(np.mean(phase4["idents"][:20])), float(np.mean(ids))
    again = served(SAMPLE_SEEDS[0], 0.3, 5)[3]
    other = served(SAMPLE_SEEDS[1], 0.3, 5)[3]
    hot = float(np.mean(served(SAMPLE_SEEDS[0], 1.0, 10)[0]))
    print(f"served sample bf16/int6/b640 T 0.3: 20 reads, mean identity {s_mean:.4f} "
          f"(min {min(ids):.4f}), greedy on the same reads {g_mean:.4f} (difference "
          f"{s_mean - g_mean:+.4f}), {samples / wall / 1e3:.1f} ksamples/s wall; seed "
          f"{SAMPLE_SEEDS[0]} again: {sum(a == b for a, b in zip(again, seqs))}/5 reads "
          f"equal, seed {SAMPLE_SEEDS[1]}: {sum(a == b for a, b in zip(other, seqs))}/5; "
          f"T 1.0: mean identity {hot:.4f} on the first 10 (not gated)")
    check(s_mean >= g_mean - 0.02, f"served sample: identity {s_mean} more than 0.02 "
          f"under greedy's {g_mean}")
    check(again == seqs[:5], "served sample: the same seed gave other calls")
    check(other != seqs[:5], "served sample: another seed gave the same calls")
    numbers.update(sample_t03_mean_identity=s_mean, sample_t10_mean_identity=hot,
                   greedy_mean_identity_20=g_mean)

    # Decode ms per step on one full 640-chunk batch: greedy, sample, in turns.
    serve = load_config("bfloat16", "int6", 640)
    scfg = load_config("bfloat16", "int6", 640, mode="sample", temperature=1.0,
                       sampling_topk=5, sampling_topp=0.9)
    chunks, lengths = batch_of_chunks(serve.signal, 640, 80)
    times = {"greedy": [], "sample": []}
    for mode in ("greedy", "sample", "sample", "greedy"):
        if mode == "greedy":
            times[mode].append(timed_batch(Translator(params, serve), chunks, lengths)[1:])
        else:
            times[mode].append(run(lambda made: timed_batch(
                card_translator(made, params, scfg), chunks, lengths))[1:])
    print("decode batch bf16/int6, 640 chunks, ms/step (steps): " + "; ".join(
        f"{mode} " + ", ".join(f"{ms:.3f} ({n})" for ms, n in t) for mode, t in times.items()))
    numbers.update(greedy_ms_per_step=float(np.mean([ms for ms, _ in times["greedy"]])),
                   sample_ms_per_step=float(np.mean([ms for ms, _ in times["sample"]])))

    # (d) The engine in sample mode at topk 1 against its greedy calls.
    fmt, _found = signal_file_format()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_modes_engine_")

    def engine_sample(made):
        out = engine_call(params, load_config("bfloat16", "int6", 640, mode="sample",
                                              sampling_topk=1), files, "engine sample")
        made.append(out[3])
        return out
    try:
        files = write_signal_files(tmp, [(f"sim{i}", sig) for i, (_t, sig) in
                                         enumerate(sim)], fmt)
        with (npz_ingest() if fmt == "npz" else contextlib.nullcontext()):
            gcalls = engine_call(params, serve, files, "engine greedy")[0]
            scalls, _m, _t, engine = run(engine_sample)
    finally:
        stop_ingest_processes()
        shutil.rmtree(tmp, ignore_errors=True)
    check(sorted(scalls) == sorted(gcalls) and len(gcalls) == len(sim),
          f"engine sample: {len(scalls)} reads back, greedy {len(gcalls)}")
    e_ids = [read_identity(scalls[r], gcalls[r]) for r in sorted(gcalls)]
    print(f"engine sample topk 1 bf16/int6 ({fmt}): {len(scalls)} reads in "
          f"{engine.batches} batches, identity to the engine's greedy calls mean "
          f"{np.mean(e_ids):.4f} ({sum(x == 1.0 for x in e_ids)} identical)")
    check(float(np.mean(e_ids)) >= 0.99, f"engine sample: identity {np.mean(e_ids)}")


def modes_path(params, run, numbers: dict):
    """Phase 15 (e): beam with the path-indirection reorder flag (run as
    the physical reorder) against beam without it.  Returns the 256 x 5 batch (chunks, lengths) and its
    physical-reorder outputs."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    def cfg(dtype, wire, batch, **kw):
        return load_config(dtype, wire, 640, mode="beam", beam_size=5,
                           batch_chunks_beam=batch, **kw)
    sig = golden_signals()[0][1]
    phys = call_read_chunks(Translator(params, cfg("float32", "float32", 8)), sig)
    path = run(lambda made: call_read_chunks(card_translator(
        made, params, cfg("float32", "float32", 8, path_reorder=True)), sig))
    check(np.array_equal(phys[2], path[2]) and np.array_equal(phys[3], path[3]),
          "path reorder f32: read 101's tokens differ from the physical reorder")
    chunks, lengths = batch_of_chunks(cfg("bfloat16", "int6", 256).signal, 256, 40)
    times = {"physical": [], "path": []}
    outs = {}
    for way in ("physical", "path", "path", "physical"):  # in turns
        if way == "path":
            out, ms, steps = run(lambda made: timed_batch(card_translator(
                made, params, cfg("bfloat16", "int6", 256, path_reorder=True)), chunks,
                lengths))
        else:
            out, ms, steps = timed_batch(Translator(params, cfg("bfloat16", "int6", 256)),
                                         chunks, lengths)
        times[way].append(ms)
        outs[way] = out
    check(same_calls(outs["path"], outs["physical"]),
          "path reorder bf16 batch: tokens differ from the physical reorder")
    print(f"path reorder beam 5: read 101 f32 ({len(path[0])} bases) and a 256 x 5 "
          f"bf16/int6 batch ({steps} steps): tokens and lengths equal to the physical "
          f"reorder; ms/step physical " + ", ".join(f"{x:.3f}" for x in times["physical"])
          + ", path " + ", ".join(f"{x:.3f}" for x in times["path"]))
    numbers.update(physical_ms_per_step=float(np.mean(times["physical"])),
                   path_ms_per_step=float(np.mean(times["path"])))
    return chunks, lengths, outs["physical"]


def modes_coverage(params, run, phase4: dict, numbers: dict, batch) -> None:
    """Phase 15 (f): the coverage penalty, "wu" and "summary", beam 5."""
    from types import SimpleNamespace

    chunks, lengths, plain = batch

    def cfg(dtype, wire, batch, kind):
        return load_config(dtype, wire, 640, mode="beam", beam_size=5,
                           batch_chunks_beam=batch, coverage_penalty=kind,
                           beta=COVERAGE_BETA)

    def parity(made, kind):
        b, steps, _seq = phase_beam_parity(
            params, cfg("float32", "float32", 8, kind),
            label=f"coverage {kind} beta {COVERAGE_BETA} beam f32/K5")
        made.append(SimpleNamespace(batches=b, decode_steps=steps))
    for kind in ("wu", "summary"):
        run(lambda made: parity(made, kind))
        out, ms, steps = run(lambda made: timed_batch(card_translator(
            made, params, cfg("bfloat16", "int6", 256, kind)), chunks, lengths))
        check(out[0].shape[0] == 256 and bool((out[1] > 0).all()),
              f"coverage {kind} batch: missing or empty hypotheses")
        n_diff = int((out[3] != plain[3]).sum())
        print(f"coverage {kind} beta {COVERAGE_BETA} batch bf16/int6: 256 chunks x K5, "
              f"{steps} steps, {ms:.3f} ms/step (the kernel route at beta 0: "
              f"{numbers['physical_ms_per_step']:.3f}); best scores that differ from "
              f"beta 0: {n_diff}/256, chunks whose tokens differ: "
              f"{int((out[0] != plain[0]).any(axis=1).sum())}/256, mean best length "
              f"{out[1].mean():.2f} tokens (beta 0: {plain[1].mean():.2f})")
        check(n_diff > 0, f"coverage {kind}: no score differs from beta 0")
        numbers[f"coverage_{kind}_ms_per_step"] = ms
        ids = run(lambda made: call_reads(card_translator(
            made, params, cfg("bfloat16", "int6", 256, kind)), simulated_reads(20)))[0]
        mean_id = float(np.mean(ids))
        print(f"coverage {kind} served bf16/int6/b256/K5: 20 reads, mean identity "
              f"{mean_id:.4f} (min {min(ids):.4f}), greedy on the same reads "
              f"{np.mean(phase4['idents'][:20]):.4f}")
        check(mean_id >= COVERAGE_MIN_IDENTITY[kind],
              f"coverage {kind} served: mean identity {mean_id} below "
              f"{COVERAGE_MIN_IDENTITY[kind]}")
        numbers[f"coverage_{kind}_mean_identity"] = mean_id


def phase_modes(params, reset, counts, expect, phase4: dict) -> tuple[dict, dict]:
    """Phase 15: sample mode, the path-indirection reorder and the coverage
    penalty on the MQA flagship (ModeRuns counts each mode's launches).
    Returns (launches by path, numbers)."""
    t0 = time.perf_counter()
    enc_layers = load_config("float32", "float32", 640).model.enc_layers
    numbers = {}
    sample = ModeRuns(reset, counts)
    modes_sample(params, sample, phase4, numbers)
    expect("sample", sample.launches, K1=enc_layers * sample.batches, K3=0, K4a=0, K4b=0,
           K5=0, R1=sample.steps)
    check(sample.launches["K2"] >= sample.steps > 0,
          f"sample path: K2 launched {sample.launches['K2']} times for {sample.steps} "
          f"decode steps")
    print(f"[phase 15] (a)-(d) {time.perf_counter() - t0:.1f} s")

    path = ModeRuns(reset, counts)
    batch = modes_path(params, path, numbers)
    expect("path_reorder", path.launches, K1=enc_layers * path.batches, K3=path.steps,
           K4a=0, K4b=0, K5=0)
    check(path.launches["K2"] >= path.steps > 0,
          f"path_reorder path: K2 launched {path.launches['K2']} times")
    print(f"[phase 15] (e) {time.perf_counter() - t0:.1f} s")

    cov = ModeRuns(reset, counts)
    modes_coverage(params, cov, phase4, numbers, batch)
    expect("coverage", cov.launches, K1=enc_layers * cov.batches, K2=0, K3=0, K4a=0,
           K4b=0, K5=0)
    check(cov.steps > 0, "coverage path: no decode step ran")
    numbers["modes_phase_s"] = time.perf_counter() - t0
    print(f"[phase 15] modes: {numbers['modes_phase_s']:.1f} s")
    return {"sample": sample.launches, "path_reorder": path.launches,
            "coverage": cov.launches}, numbers


# Phase 16: the native host tier, data parallelism (one rank under NCCL;
# two ranks sharing the one card under gloo, as subprocesses) and the
# device trace.
DP_WORLD, DP_TIMEOUT_S = 2, 600
DP_GREEDY_BATCH, DP_BEAM_BATCH = 640, 256
# The collectives and dtypes that the ranks probe on CUDA tensors under
# gloo (the mesh plan uses broadcast, all-reduce and all-gather).
DP_PROBE_OPS = ("broadcast", "all_reduce", "all_gather")
DP_PROBE_DTYPES = (torch.float32, torch.float16, torch.bfloat16, torch.float64,
                   torch.int64, torch.int32, torch.int16, torch.uint8)


def kernel_wrappers() -> dict:
    """{kernel id: its wrapper}, each carrying a `launches` count."""
    from nanodecoder_tpu_torch.ops.attention import (decode_attention,
                                                     decode_attention_grouped)
    from nanodecoder_tpu_torch.ops.beam_step import beam_advance, beam_topk
    from nanodecoder_tpu_torch.ops.cache_update import write_cache_block
    from nanodecoder_tpu_torch.ops.encoder_attention import (
        flash_encoder_attention, flash_encoder_attention_nld, flash_encoder_attention_qkv)
    from nanodecoder_tpu_torch.ops.threefry import threefry_draw

    return {"K1": flash_encoder_attention_qkv, "K2": write_cache_block,
            "K3": beam_advance, "K4a": decode_attention,
            "K4b": decode_attention_grouped, "K5": flash_encoder_attention_nld,
            "K6": flash_encoder_attention, "K7": beam_topk, "R1": threefry_draw}


def reset_launches(wrappers: dict) -> None:
    for fn in wrappers.values():
        fn.launches = 0
    for name in ("K4a", "K4b"):
        wrappers[name].scalar_launches = 0


def launch_counts(wrappers: dict) -> dict:
    """Launches by kernel; K4a_scalar, K4b_scalar: the launches of K4a and
    K4b that ran the scalar decode-attention kernel (counted in K4a and
    K4b too)."""
    return {**{name: fn.launches for name, fn in wrappers.items()},
            "K4a_scalar": wrappers["K4a"].scalar_launches,
            "K4b_scalar": wrappers["K4b"].scalar_launches}


def _numpy_identity(pair: tuple[str, str]) -> float:
    """A pool worker's numpy read identity of one logged pair."""
    from nanodecoder_tpu_torch.identity import read_identity_plain

    return read_identity_plain(*pair)


def _numpy_distance(pair: tuple[str, str]) -> int:
    """A pool worker's numpy edit distance of one pair."""
    from nanodecoder_tpu_torch.identity import edit_distance_plain

    return edit_distance_plain(*pair)


def serial_s(fn, pairs) -> list[float]:
    """Seconds of fn(*pair) for each pair, one after another."""
    out = []
    for pair in pairs:
        t0 = time.perf_counter()
        fn(*pair)
        out.append(time.perf_counter() - t0)
    return out


def random_pair(rng) -> tuple[str, str]:
    """Two bases strings of up to 400: unrelated, or the second an edited
    copy of the first (substitutions, insertions, deletions)."""
    a = "".join(rng.choice(list("ACGT"), int(rng.integers(0, 400))))
    if rng.random() < 0.5:
        return a, "".join(rng.choice(list("ACGT"), int(rng.integers(0, 400))))
    b = list(a)
    for _ in range(int(rng.integers(0, len(a) // 5 + 2))):
        p = int(rng.integers(0, len(b) + 1))
        op = int(rng.integers(0, 3))
        if op == 0:
            b.insert(p, "ACGT"[int(rng.integers(4))])
        elif b and p < len(b):
            if op == 1:
                b.pop(p)
            else:
                b[p] = "ACGT"[int(rng.integers(4))]
    return a, "".join(b)


# Logged identity calls timed in numpy, serially, for the estimate of
# what read identity cost before the native tier.
NUMPY_SAMPLE = 10


def host_identity(phase4_calls: tuple[int, int]) -> dict:
    """(a) the native host library is loaded from the build directory;
    (b) its edit distance and overlap scorer equal the numpy versions on
    1000 random pairs, and its read identity equals numpy's on phase 4's
    pairs (numpy's distances and identities in one pool of spawned
    processes, untimed).  Times, each call alone: numpy and native on 3
    of phase 4's 3000-base reads, and numpy on NUMPY_SAMPLE of the logged
    calls (every k-th), whose mean times the number of calls estimates
    the seconds the numpy route would have spent in phases 3-15."""
    import concurrent.futures
    import multiprocessing

    from nanodecoder_tpu_torch import build_cache, identity, native
    from nanodecoder_tpu_torch.io import stitch

    lib = native.load()
    check(lib is not None, "(a) the native host library is not loaded")
    check(os.path.dirname(lib._name) == build_cache.build_dir(),
          f"(a) the native library {lib._name} is not in {build_cache.build_dir()}")
    rng = np.random.default_rng(16)
    pairs = [random_pair(rng) for _ in range(1000)]
    calls = list(IDENTITY.calls)
    lo, hi = phase4_calls
    check(hi > lo, "(b) phase 4 logged no read identity")
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            os.cpu_count() or 1, mp_context=multiprocessing.get_context("spawn")) as pool:
        distances = pool.map(_numpy_distance, pairs, chunksize=25)
        plain = list(pool.map(_numpy_identity, [c[:2] for c in calls[lo:hi]], chunksize=2))
        distances = list(distances)
    pool_s = time.perf_counter() - t0
    for i, ((a, b), d) in enumerate(zip(pairs, distances)):
        k = 1 + i % 150
        check(identity.edit_distance(a, b) == d
              and stitch._best_overlap_len(a, b, k) == stitch._best_overlap_len_plain(a, b, k),
              f"(b) native and numpy differ on pair {i}: {a!r}, {b!r}")
    for j, value in zip(range(lo, hi), plain):
        check(value == calls[j][2], f"(b) read identity of phase 4's call {j - lo}: numpy "
              f"{value} vs native {calls[j][2]}")
    p4 = [c[:2] for c in calls[lo:lo + 3]]
    step = max(1, len(calls) // NUMPY_SAMPLE)
    sample = [c[:2] for c in calls[::step][:NUMPY_SAMPLE]]
    numpy_sample = serial_s(identity.read_identity_plain, sample)
    numbers = {
        "identity_calls": len(calls),
        "identity_native_s": IDENTITY.seconds,
        "identity_numpy_s_estimate": float(np.mean(numpy_sample)) * len(calls),
        "numpy_sample_calls": len(sample),
        "phase4_reads": hi - lo,
        "numpy_check_pool_s": pool_s,
        "phase4_native_ms_per_read": float(np.mean(serial_s(identity.read_identity, p4))) * 1e3,
        "phase4_numpy_ms_per_read": float(np.mean(serial_s(identity.read_identity_plain,
                                                            p4))) * 1e3}
    print(f"(a)-(b) native host library loaded from {lib._name}; edit distance and "
          f"overlap equal to numpy on 1000 random pairs; read identity equal to numpy on "
          f"phase 4's {hi - lo} pairs (numpy's side {pool_s:.1f} s in a pool).  Seconds in read "
          f"identity over the {len(calls)} calls of phases 3-15: native (this run) "
          f"{numbers['identity_native_s']:.3f} s; numpy (the route before the native "
          f"tier) about {numbers['identity_numpy_s_estimate']:.1f} s, the mean of "
          f"{len(sample)} calls timed serially times {len(calls)}.  Per 3000-base read of "
          f"phase 4, serially on 3 reads: native "
          f"{numbers['phase4_native_ms_per_read']:.2f} ms, numpy "
          f"{numbers['phase4_numpy_ms_per_read']:.1f} ms")
    return numbers


def compact_outputs(rows: int, tmax: int, dev) -> tuple:
    """Tensors of the shapes and dtypes of a batch's compact decode outputs
    (Translator._compact_d2h): what the mesh plan gathers a batch."""
    return (torch.zeros(rows, tmax, dtype=torch.int16, device=dev),
            torch.zeros(rows, dtype=torch.int32, device=dev),
            torch.zeros(rows, tmax, dtype=torch.float16, device=dev),
            torch.zeros(rows, dtype=torch.float32, device=dev),
            torch.zeros(rows, tmax, dtype=torch.int16, device=dev))


def host_ms(fn, reps: int = 10) -> float:
    """Mean ms of fn() on the host clock, each run ended by a synchronize
    (collectives: the wait is part of the cost), after one warm-up."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def dp_one_rank(params, reset, counts, dev) -> tuple[dict, dict]:
    """(c) A NCCL group of one rank on the card: the engine with a mesh
    plan on the first 20 reads of phase 12's greedy run (bf16, int6 wire,
    512-chunk batches) gives FASTQ byte-equal to the same engine without
    one; the gather of a batch's outputs timed.  Returns (launches,
    numbers)."""
    import torch.distributed as dist

    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes
    from nanodecoder_tpu_torch.parallel.mesh import make_mesh_plan
    from nanodecoder_tpu_torch.parallel.multihost import (initialize_multihost,
                                                          shutdown_multihost)

    cfg = load_config("bfloat16", "int6", 640)
    fmt, _found = signal_file_format()
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp1_")

    def run(files, plan):
        out = io.StringIO()
        engine = StreamingBasecaller(params, cfg, mesh_plan=plan)
        engine.run(files, out, stitch_method="attn", num_workers=4)
        torch.cuda.synchronize()
        return out.getvalue(), engine

    try:
        files = write_signal_files(tmp, [(f"sim{i}", sig) for i, (_t, sig)
                                         in enumerate(simulated_reads(20))], fmt, per_file=5)
        with (npz_ingest() if fmt == "npz" else contextlib.nullcontext()):
            plain, _engine = run(files, None)
            initialize_multihost(f"file://{tmp}/rendezvous", 1, 0, backend="nccl", device=dev)
            try:
                plan = make_mesh_plan()
                check(plan.n_devices == 1 and dist.get_backend() == "nccl",
                      f"(c) a group of {plan.n_devices} on {dist.get_backend()}")
                reset()
                sharded, engine = run(files, plan)
                launches = counts()
                bsz = cfg.decode.effective_batch_chunks(engine=True)
                gather = host_ms(lambda: plan.gather_rows(
                    compact_outputs(bsz, cfg.model.max_decode_len, dev)))
            finally:
                shutdown_multihost()
    finally:
        stop_ingest_processes()
        shutil.rmtree(tmp, ignore_errors=True)
    calls = parse_fastq(sharded, "(c) engine with a one-rank plan")
    check(sorted(calls) == sorted(f"sim{i}" for i in range(20)),
          f"(c) {len(calls)} reads came back of 20")
    check(sharded == plain, "(c) the engine's FASTQ with a one-rank NCCL plan differs "
          "from the engine's without a plan")
    enc_layers = cfg.model.enc_layers
    check(launches["K1"] == enc_layers * engine.batches
          and launches["K2"] >= engine.decode_steps > 0 and launches["K3"] == 0,
          f"(c) launches {launches} for {engine.batches} batches")
    print(f"(c) one-rank NCCL group: the engine with a mesh plan, 20 reads in "
          f"{engine.batches} batches of {bsz}: FASTQ byte-equal to the engine without a "
          f"plan ({len(sharded)} bytes); gather of a batch's outputs {gather:.3f} ms; "
          f"launches K1 {launches['K1']}, K2 {launches['K2']}, K3 {launches['K3']}")
    return launches, {"nccl1_gather_ms": gather, "nccl1_batches": engine.batches}


def chunk_strings(vocab, tokens, lengths) -> list[str]:
    return [vocab.decode(t[:n]) for t, n in zip(tokens.cpu().numpy().astype(np.int64),
                                                lengths.cpu().numpy())]


def dp_rank_main(argv: list[str]) -> int:
    """One of phase 16's ranks sharing the card (run as
    `python -c "import sys, chip_smoke; sys.exit(chip_smoke.dp_rank_main(sys.argv[1:]))" RANK WORLD DIR DEVICE`,
    with LOCAL_RANK and LOCAL_WORLD_SIZE set): joins the group through a
    file in DIR, runs `dp_rank` on DEVICE and writes its result to
    DIR/rank<R>.json."""
    from nanodecoder_tpu_torch.parallel.multihost import shutdown_multihost

    rank, world, work, dev = int(argv[0]), int(argv[1]), argv[2], torch.device(argv[3])
    sys.path.insert(0, REPO)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        result = dp_rank(rank, world, work, dev)
    except SmokeError as e:
        print(f"rank {rank} FAILED: {e}", file=sys.stderr)
        return 1
    finally:
        shutdown_multihost()
    with open(os.path.join(work, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)
    return 0


def probe_collectives(dev) -> dict:
    """Which of DP_PROBE_OPS gloo takes on CUDA tensors of each dtype
    ("ok" or the error), both ranks in step."""
    import torch.distributed as dist

    world = dist.get_world_size()
    found = {}
    for op in DP_PROBE_OPS:
        for dt in DP_PROBE_DTYPES:
            x = torch.ones(8, dtype=dt, device=dev)
            try:
                if op == "broadcast":
                    dist.broadcast(x, 0)
                elif op == "all_reduce":
                    dist.all_reduce(x)
                else:
                    dist.all_gather([torch.empty_like(x) for _ in range(world)], x)
                torch.cuda.synchronize()
                found[f"{op} {str(dt)[6:]}"] = "ok"
            except (RuntimeError, TypeError, ValueError) as e:
                found[f"{op} {str(dt)[6:]}"] = str(e).splitlines()[0][:80]
            dist.barrier()
    return found


def dp_rank(rank: int, world: int, work: str, dev: torch.device) -> dict:
    """A rank of (d): the MQA flagship (f32, float32 wire, kernel route)
    decoding a greedy batch of 640 chunks and a beam-5 batch of 256 chunks
    sharded over the ranks, then `dp_train`'s data-parallel Adam steps at
    batch 8 (at dropout 0.1, each rank draws its rows of the global masks
    with R1).  Rank 0 also runs each on its own,
    unsharded (one rank's call): every chunk's identity to it >= 0.99 (the
    count of exactly equal chunks reported; cuBLAS tiles the half batch
    otherwise), and each train step from the same state held to phase 13
    (a)'s tolerances.  Also: which collectives gloo takes on CUDA tensors,
    the gather ms of a batch and the gradient all-reduce ms of a step."""
    import torch.distributed as dist

    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.signal import convert_h2d
    from nanodecoder_tpu_torch.parallel.mesh import make_mesh_plan
    from nanodecoder_tpu_torch.parallel.multihost import initialize_multihost
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    initialize_multihost(f"file://{work}/rendezvous", world, rank, device=dev)
    backend = dist.get_backend()
    check(backend == "gloo", f"ranks sharing the card joined a {backend} group")
    out = {"rank": rank, "backend": backend, "collectives": probe_collectives(dev)}
    plan = make_mesh_plan()
    wrappers = kernel_wrappers()
    greedy_cfg = load_config("float32", "float32", DP_GREEDY_BATCH)
    beam_cfg = load_config("float32", "float32", DP_GREEDY_BATCH, mode="beam", beam_size=5,
                           batch_chunks_beam=DP_BEAM_BATCH)
    params = load_params_npz(NPZ, greedy_cfg.model, device=dev)
    batches = {}
    for name, cfg, bsz in (("greedy", greedy_cfg, DP_GREEDY_BATCH),
                           ("beam", beam_cfg, DP_BEAM_BATCH)):
        tr = Translator(params, cfg, device=dev)
        chunks, lengths = batch_of_chunks(cfg.signal, bsz, 60)
        wire = convert_h2d(np.asarray(chunks, np.float32), tr._h2d, cfg.signal.clip_sigma)
        batches[name] = (tr, wire, lengths)
    reset_launches(wrappers)
    sharded, secs = {}, {}
    for name, (tr, wire, lengths) in batches.items():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        sharded[name] = plan.shard_decode_fn(tr.decode_program)(wire, lengths)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
    out["launches"] = launch_counts(wrappers)
    out["decode_steps"] = {name: tr.decode_steps for name, (tr, _w, _l) in batches.items()}
    out["decode_s"] = secs
    enc_layers = greedy_cfg.model.enc_layers
    got = out["launches"]
    check(got["K1"] == 2 * enc_layers and got["K3"] == batches["beam"][0].decode_steps
          and got["K2"] >= sum(out["decode_steps"].values()) > 0,
          f"rank {rank}: launches {got} for the two sharded batches")
    tmax = greedy_cfg.model.max_decode_len
    out["gather_ms"] = host_ms(lambda: plan.gather_rows(
        compact_outputs(DP_GREEDY_BATCH // world, tmax, dev)))
    if rank == 0:
        for name, (tr, wire, lengths) in batches.items():
            ref = tr.decode_program(wire, lengths)
            a = chunk_strings(tr.vocab, sharded[name][0], sharded[name][1])
            b = chunk_strings(tr.vocab, ref[0], ref[1])
            idents = [read_identity(x, y) for x, y in zip(a, b)]
            out[f"{name}_chunks"] = len(a)
            out[f"{name}_equal_chunks"] = sum(x == y for x, y in zip(a, b))
            out[f"{name}_min_identity"] = min(idents)
            check(len(a) == len(b) == len(wire) and min(idents) >= 0.99,
                  f"{name}: sharded vs one rank's call, min chunk identity {min(idents)}")
    out.update(dp_train(rank, plan, dev, wrappers))
    out["launches"]["R1"] += out["dp_train_r1"]
    return out


def dp_train(rank: int, plan, dev, wrappers: dict) -> dict:
    """(d)'s data-parallel Adam steps, phase 13 (a)'s parity steps over the
    ranks: PARITY_STEPS at dropout 0 from the flagship params, then
    DROPOUT_PARITY_STEPS from the flagship params at dropout 0.1, where
    each rank draws its rows of the global masks with R1 (its launches
    counted); on rank 0 each step held to one rank's step from the same
    state and key at (a)'s gates.  (a) holds no second step at dropout
    0.1, and neither does this: at this width that step's gradients part
    card from CPU, and one rank from two, through a ReLU input within
    rounding of 0 (PERF.md, section 7)."""
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import synthetic_batches
    from nanodecoder_tpu_torch.train.trainer import Trainer
    from nanodecoder_tpu_torch.utils.report import ReportManager

    out = {"train_steps": [], "dp_train_r1": 0}
    want = 0
    for dropout, steps in ((0.0, PARITY_STEPS), (0.1, DROPOUT_PARITY_STEPS)):
        cfg = train_config(PARITY_BATCH, dropout=dropout)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, optimizer="adam", lr_schedule="constant", learning_rate=PARITY_LR))
        it = synthetic_batches(cfg, seed=0)
        batches = [next(it) for _ in range(steps)]
        want += steps * len(batches[0]["signal"]) * train_draws(cfg.model)
        dp = Trainer(cfg, load_params_npz(NPZ, cfg.model, device=dev),
                     report=ReportManager(report_every=10 ** 9), mesh_plan=plan)
        ref = quiet_trainer(cfg, load_params_npz(NPZ, cfg.model, device=dev)) \
            if rank == 0 else None
        for i, batch in enumerate(batches):
            if ref is not None:
                ref.state = dp.state
            before = wrappers["R1"].launches
            md = dp.train_step(batch)
            out["dp_train_r1"] += wrappers["R1"].launches - before
            if ref is None:
                continue
            mr = ref.train_step(batch)
            ld, lr_ = float(md["loss_sum"]), float(mr["loss_sum"])
            gd, gr = host_leaves(dp.params, grad=True), host_leaves(ref.params, grad=True)
            pd, pr = host_leaves(dp.params), host_leaves(ref.params)
            every = max(float((pd[k] - pr[k]).abs().max()) for k in pr)
            held, n_ex, n_all = 0.0, 0, 0
            for k, c in gr.items():
                d = (gd[k] - c).abs()
                lo = torch.minimum(gd[k].abs(), c.abs())
                hi = torch.maximum(gd[k].abs(), c.abs())
                exempt = ((lo < 1e-6) & (hi > 0)) | (d > 1e-6 + 1e-4 * c.abs())
                held = max(held, float((pd[k] - pr[k]).abs().masked_fill(exempt, 0).max()))
                n_ex, n_all = n_ex + int(exempt.sum()), n_all + c.numel()
            step = {"dropout": dropout, "loss_sum": ld, "loss_sum_one_rank": lr_,
                    "tokens": int(md["n_tokens"]), "max_param_diff": every,
                    "held_param_diff": held, "exempt_share": n_ex / n_all}
            out["train_steps"].append(step)
            label = f"dp train, dropout {dropout}"
            print(f"{label} step {i + 1}: {step}")
            check(int(md["n_tokens"]) == int(mr["n_tokens"]), f"{label}: token counts")
            check(abs(ld - lr_) <= 1e-4 * abs(lr_), f"{label}: loss {ld} vs {lr_}")
            check(every <= 1e-4 and held <= 1e-5 and n_ex < 0.1 * n_all,
                  f"{label}: params differ by {every}, {held} over the elements held, "
                  f"{n_ex} of {n_all} exempt")
            parity_gradients(i + 1, gd, gr, label)
    check(out["dp_train_r1"] == want > 0, f"dp train, rank {rank}: R1 launched "
          f"{out['dp_train_r1']} times, {want} draws expected")
    out["all_reduce_ms"] = host_ms(lambda: plan.all_reduce_grads(
        dp.optimizer.params.values()), reps=5)
    out["grad_elements"] = sum(p.numel() for p in dp.optimizer.params.values())
    return out


def spawn_ranks(cmd: list[str], root: str, extra_env: dict) -> list[tuple[int, str]]:
    """Start DP_WORLD processes of `cmd` (RANK, WORLD_SIZE, LOCAL_RANK and
    LOCAL_WORLD_SIZE set, rank as the last argument where cmd ends in
    "{rank}"), wait for all (DP_TIMEOUT_S) and return (exit code, output)
    by rank; none is left running."""
    procs = []
    for r in range(DP_WORLD):
        env = {**os.environ, **extra_env, "RANK": str(r), "WORLD_SIZE": str(DP_WORLD),
               "LOCAL_RANK": str(r), "LOCAL_WORLD_SIZE": str(DP_WORLD)}
        procs.append(subprocess.Popen([a.replace("{rank}", str(r)) for a in cmd], cwd=root,
                                      env=env, stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for p in procs:
            text, _ = p.communicate(timeout=DP_TIMEOUT_S)
            outs.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outs


def dp_two_ranks(root: str) -> tuple[dict, dict]:
    """(d) two ranks on the one card (gloo: NCCL refuses two ranks on one
    device): `dp_rank` in each; then the basecall CLI at world 2 on 20
    reads in 4 files (each rank its files, rank 0 merges): every read
    exactly once, no shard left.  Returns (launches by rank, numbers)."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_dp2_")
    try:
        outs = spawn_ranks([sys.executable, "-c", "import sys, chip_smoke; "
                            "sys.exit(chip_smoke.dp_rank_main(sys.argv[1:]))",
                            "{rank}", str(DP_WORLD), tmp, "cuda:0"], root, {})
        for r, (rc, text) in enumerate(outs):
            print("\n".join(f"  rank {r}: {line}" for line in text.splitlines()
                            if "dp train step" in line or "FAILED" in line
                            or "dp train" in line))
            check(rc == 0, f"(d) rank {r} exited {rc}: {text[-3000:]}")
        ranks = []
        for r in range(DP_WORLD):
            with open(os.path.join(tmp, f"rank{r}.json")) as f:
                ranks.append(json.load(f))
        r0 = ranks[0]
        print(f"(d) {DP_WORLD} ranks on one card, {r0['backend']}: collectives on CUDA "
              f"tensors: " + ", ".join(f"{k} {v}" for k, v in r0["collectives"].items()))
        for name in ("greedy", "beam"):
            print(f"(d) sharded {name} batch ({r0[f'{name}_chunks']} chunks, f32): "
                  f"{r0[f'{name}_equal_chunks']} chunks equal to one rank's call, min "
                  f"chunk identity {r0[f'{name}_min_identity']:.4f}; decode "
                  + ", ".join(f"rank {r['rank']} {r['decode_s'][name]:.3f} s / "
                              f"{r['decode_steps'][name]} steps" for r in ranks))
        for r in ranks:
            c = r["launches"]
            print(f"(d) rank {r['rank']} launches: K1 {c['K1']}, K2 {c['K2']}, K3 {c['K3']}, "
                  f"R1 {c['R1']} (its train steps' dropout draws); "
                  f"gather of its {DP_GREEDY_BATCH // DP_WORLD}-row outputs "
                  f"{r['gather_ms']:.3f} ms; gradient all-reduce "
                  f"({r['grad_elements']} f32) {r['all_reduce_ms']:.3f} ms a step")
        cli = dp_cli(tmp, root)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers = {"gloo_gather_ms": [r["gather_ms"] for r in ranks],
               "gloo_all_reduce_ms": [r["all_reduce_ms"] for r in ranks],
               "grad_elements": r0["grad_elements"], "collectives": r0["collectives"],
               "train_steps": r0["train_steps"],
               **{f"{n}_{k}": r0[f"{n}_{k}"] for n in ("greedy", "beam")
                  for k in ("chunks", "equal_chunks", "min_identity")},
               "cli_wall_s": cli}
    return {f"dp_rank{r['rank']}": r["launches"] for r in ranks}, numbers


def dp_cli(tmp: str, root: str) -> float:
    """The basecall CLI at world 2 (gloo, the card shared) on 20 reads in 4
    files: every read exactly once in the merged FASTQ, no shard left.
    Returns its wall seconds."""
    fmt, _found = signal_file_format()
    reads_dir = os.path.join(tmp, "reads")
    os.makedirs(reads_dir)
    write_signal_files(reads_dir, [(f"sim{i}", sig) for i, (_t, sig)
                                   in enumerate(simulated_reads(20))], fmt, per_file=5)
    out = os.path.join(tmp, "cli.fastq")
    args = ["--input", reads_dir, "--output", out, "--ckpt", NPZ, "--workers", "2",
            "--dist-init", f"file://{tmp}/rendezvous_cli"]
    cmd = ([sys.executable, "-m", "nanodecoder_tpu_torch.cli.basecall"] if fmt != "npz"
           else [sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.basecall_cli_npz(sys.argv[1:]))"]) + args
    t0 = time.perf_counter()
    outs = spawn_ranks(cmd, root, {})
    wall = time.perf_counter() - t0
    for r, (rc, text) in enumerate(outs):
        check(rc == 0, f"(d) basecall CLI rank {r} exited {rc}: {text[-3000:]}")
    with open(out) as f:
        calls = parse_fastq(f.read(), "(d) basecall CLI at world 2")
    check(sorted(calls) == sorted(f"sim{i}" for i in range(20)),
          f"(d) basecall CLI at world 2: {len(calls)} reads of 20")
    left = [p for p in os.listdir(tmp) if ".shard" in p]
    check(not left, f"(d) shard files left: {left}")
    print(f"(d) basecall CLI at world {DP_WORLD} ({fmt} files, gloo on one card): 20 reads "
          f"once each in the merged FASTQ, no shard left; wall {wall:.1f} s")
    return wall


def device_trace_check(params) -> dict:
    """(f) utils.profiling.device_trace around one small batch (64 chunks,
    bf16, int6 wire) writes a Chrome trace with device kernels in it."""
    from torch.autograd import DeviceType

    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.signal import convert_h2d
    from nanodecoder_tpu_torch.utils.profiling import device_trace

    cfg = load_config("bfloat16", "int6", 64)
    tr = Translator(params, cfg)
    chunks, lengths = batch_of_chunks(cfg.signal, 64, 5)
    wire = convert_h2d(np.asarray(chunks, np.float32), tr._h2d, cfg.signal.clip_sigma)
    tr.decode_program(wire, lengths)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_trace_")
    try:
        with device_trace(tmp) as prof:
            tr.decode_program(wire, lengths)
            torch.cuda.synchronize()
        traces = [f for f in os.listdir(tmp) if f.endswith(".pt.trace.json")]
        size = sum(os.path.getsize(os.path.join(tmp, f)) for f in traces)
        kernels = sum(e.device_type == DeviceType.CUDA for e in prof.events())
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    check(len(traces) == 1 and size > 0 and kernels > 0,
          f"(f) device_trace wrote {traces} ({size} bytes, {kernels} device kernels)")
    print(f"(f) device_trace: {traces[0]}, {size} bytes, {kernels} device kernels for "
          f"one 64-chunk batch")
    return {"trace_bytes": size, "trace_kernels": kernels}


def phase_host_dp(params, reset, counts, dev, root: str,
                  phase4_calls: tuple[int, int]) -> tuple[dict, dict]:
    """Phase 16: (a)-(b) `host_identity`, (c) `dp_one_rank`, (d)
    `dp_two_ranks`, (e) no child process left, (f) `device_trace_check`.
    Returns (launches by path, numbers)."""
    t0 = time.perf_counter()
    numbers = host_identity(phase4_calls)
    print(f"[phase 16] (a)-(b) {time.perf_counter() - t0:.1f} s")
    nccl, one = dp_one_rank(params, reset, counts, dev)
    numbers.update(one)
    print(f"[phase 16] (c) {time.perf_counter() - t0:.1f} s")
    ranks, two = dp_two_ranks(root)
    numbers.update(two)
    print(f"[phase 16] (d) {time.perf_counter() - t0:.1f} s")
    left = live_children()
    check(not left, f"(e) processes still running after (d): {left}")
    numbers.update(device_trace_check(params))
    numbers["phase16_s"] = time.perf_counter() - t0
    print(f"(e) no child process left; [phase 16] host and data-parallel: "
          f"{numbers['phase16_s']:.1f} s")
    return {"dp_nccl": nccl, **ranks}, numbers


# Phase 17: the JAX package's orbax checkpoint, read without JAX.
ORBAX = os.path.join(REPO, "tests", "golden", "jax_orbax_tiny")
ORBAX_EXPECTED = ORBAX + "_expected.npz"


def tree_hashes(root: str) -> dict[str, str]:
    import hashlib

    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), "rb") as fh:
                out[os.path.relpath(os.path.join(d, f), root)] = \
                    hashlib.sha256(fh.read()).hexdigest()
    return out


def run_clis(runs: list[tuple[str, list[str]]], root: str) -> list[tuple[str, float]]:
    """Start each (command, args) as a process at once, then wait for all:
    [(stdout, wall seconds)], failing on a non-zero exit.  The host's cores
    are shared out among them (OMP_NUM_THREADS)."""
    env = {**os.environ,
           "OMP_NUM_THREADS": str(max(1, (os.cpu_count() or 1) // len(runs)))}
    procs = []
    for i, (cmd, args) in enumerate(runs):
        head = ([sys.executable, "-c", "import sys, chip_smoke; "
                 "sys.exit(chip_smoke.basecall_cli_npz(sys.argv[1:]))"]
                if cmd == "basecall_npz" else
                [sys.executable, "-m", f"nanodecoder_tpu_torch.cli.{cmd}"])
        err = tempfile.TemporaryFile("w+")
        procs.append((cmd, subprocess.Popen([*head, *args], cwd=root, env=env, text=True,
                                            stdout=subprocess.PIPE, stderr=err),
                      err, time.perf_counter()))
    out = []
    for cmd, proc, err, t0 in procs:
        stdout, _ = proc.communicate(timeout=600)
        wall = time.perf_counter() - t0
        err.seek(0)
        check(proc.returncode == 0, f"cli.{cmd} exit {proc.returncode}: {err.read()[-2000:]}")
        err.close()
        out.append((stdout, wall))
    return out


def phase_orbax(dev, reset, counts, root: str) -> tuple[dict, dict]:
    """Phase 17 (see the module docstring); returns (the orbax path's
    launches, numbers)."""
    from nanodecoder_tpu_torch import build_cache
    from nanodecoder_tpu_torch.cli.common import load_params_and_config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.io.ocdbt import OcdbtStore
    from nanodecoder_tpu_torch.native import zstd
    from nanodecoder_tpu_torch.train.checkpoint import (CheckpointManager, load_config,
                                                        params_from_numpy, params_to_numpy,
                                                        read_jax_checkpoint)
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    t_phase = time.perf_counter()
    numbers: dict = {}
    tmp = tempfile.mkdtemp(prefix="orbax_")
    try:
        # (a) the read on the host, bit-equal to the JAX package's restore
        check(zstd.load() is not None, "the native zstd library did not load")
        with np.load(ORBAX_EXPECTED) as e:
            want = {k: e[k] for k in e.files}
        files = sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in
                    os.walk(os.path.join(ORBAX, "3")) for f in fs)
        walls = []
        for _ in range(3):
            t0 = time.perf_counter()
            state = read_jax_checkpoint(ORBAX, device="cpu")
            walls.append(time.perf_counter() - t0)
        arrays = sum(v.nbytes for v in want.values())
        for name, tree in (("params", state.params), ("mu", state.opt_state["mu"]),
                           ("nu", state.opt_state["nu"])):
            got = params_to_numpy(tree)
            for key, w in ((k[len(name) + 1:], v) for k, v in want.items()
                           if k.startswith(name + "/")):
                check(got[key].dtype == w.dtype and got[key].shape == w.shape
                      and got[key].tobytes() == w.tobytes(),
                      f"orbax read: {name}/{key} differs from the JAX package's restore")
        check(int(state.opt_state["count"]) == int(want["count"]) and
              state.step == int(want["step"]) == 3, "orbax read: count or step differs")
        store = OcdbtStore(os.path.join(ORBAX, "3", "default"))
        frames = [store.read(k) for k in store.keys() if not k.endswith("/.zarray")]
        t0 = time.perf_counter()
        for _ in range(10):
            decoded = sum(len(zstd.decompress(f)) for f in frames)
        decode_s = (time.perf_counter() - t0) / 10
        numbers.update(read_s_first=walls[0], read_s_median=statistics.median(walls),
                       files_bytes=files, array_bytes=arrays,
                       read_mb_per_s=files / 1e6 / statistics.median(walls),
                       decode_frames=len(frames), decode_mb_per_s=decoded / 1e6 / decode_s)
        print(f"orbax (a): the fixture read on the host bit-equal to the JAX package's "
              f"restore (params, mu, nu, count, step 3): {files} bytes of files, {arrays} "
              f"bytes of arrays, first read {walls[0]:.4f} s, median of 3 "
              f"{statistics.median(walls):.4f} s ({numbers['read_mb_per_s']:.2f} MB/s of "
              f"files); the zstd decoder alone on its {len(frames)} chunk frames "
              f"{numbers['decode_mb_per_s']:.2f} MB/s decoded")

        # (b) served on the card, kernel route, f32, against the npz export
        export = os.path.join(tmp, "export")
        os.makedirs(export)
        npz = os.path.join(export, "params.npz")
        np.savez(npz, **{k[len("params/"):]: v for k, v in want.items()
                         if k.startswith("params/")})
        shutil.copy(os.path.join(ORBAX, "config.json"), export)
        t0 = time.perf_counter()
        params, config = load_params_and_config(ORBAX, dev)
        numbers["load_to_card_s"] = time.perf_counter() - t0
        npz_params = params_from_numpy({k[len("params/"):]: v for k, v in want.items()
                                        if k.startswith("params/")}, config.model, dev)
        spec = SimSpec()
        rng = np.random.default_rng(7)
        reads = [RawRead(f"tiny{i}", simulate_read(rng, 1500, spec, spec.level_table())[1],
                         "sim") for i in range(4)]
        model = dataclasses.replace(config.model, use_pallas=True, compute_dtype="float32")
        reset()
        for mode, kernels in (("greedy", ("K1", "K2", "K4a")),
                              ("beam", ("K1", "K2", "K3", "K4b"))):
            decode = dataclasses.replace(config.decode, use_pallas=True, batch_chunks=64,
                                         batch_chunks_beam=16, mode=mode, beam_size=5)
            cfg = dataclasses.replace(config, model=model, decode=decode)
            before = counts()
            seqs = [[Translator(p, cfg, device=dev).basecall_read(r, stitch_method="trim").sequence
                     for r in reads] for p in (params, npz_params)]
            c = counts()
            for name in kernels:
                check(c[name] > before[name], f"orbax {mode}: {name} not launched")
            check(seqs[0] == seqs[1], f"orbax {mode}: the orbax params' calls differ from "
                  "the npz export's")
            print(f"orbax (b): {mode} on 4 reads from the orbax directory equal to the npz "
                  f"export's ({sum(map(len, seqs[0]))} bases)")
        launches = counts()

        reads_dir = os.path.join(tmp, "reads")
        os.makedirs(reads_dir)
        write_signal_files(reads_dir, [(r.read_id, r.signal) for r in reads], "npz")
        outs = {k: os.path.join(tmp, f"{k}.fastq") for k in ("orbax", "npz")}
        runs = [("basecall_npz", ["--input", reads_dir, "--output", outs[k], "--ckpt", ck,
                                  "--parity", "--workers", "2"])
                for k, ck in (("orbax", ORBAX), ("npz", npz))]
        runs += [("evaluate", ["--ckpt", ck, "--simulate", "2", "--read-bases", "1000",
                               "--dtype", "float32", "--json"]) for ck in (ORBAX, npz)]
        results = run_clis(runs, root)
        fastq = {k: open(v).read() for k, v in outs.items()}
        calls = parse_fastq(fastq["orbax"], "basecall CLI on the orbax directory")
        check(fastq["orbax"] == fastq["npz"] and len(calls) == len(reads),
              "basecall CLI: the orbax directory's FASTQ differs from the npz export's")
        evals = [json.loads(out.strip().splitlines()[-1]) for out, _ in results[2:]]
        check(evals[0] == evals[1] and evals[0]["n_reads"] == 2,
              f"evaluate CLI: {evals[0]} on the orbax directory, {evals[1]} on the npz")
        print(f"orbax (b): basecall CLI --parity on the orbax directory: FASTQ byte-equal "
              f"to the npz export's ({len(calls)} reads); evaluate CLI equal on both "
              f"(identity {evals[0]['mean_identity']:.4f}); process walls "
              + ", ".join(f"{w:.1f} s" for _, w in results))

        # (c) --resume from a copy of the fixture against a resume from the
        # port-format copy of the same state
        jax_copy, port_copy = os.path.join(tmp, "jax_ck"), os.path.join(tmp, "port_ck")
        shutil.copytree(ORBAX, jax_copy)
        before = tree_hashes(jax_copy)
        CheckpointManager(port_copy, load_config(ORBAX)).save(3, state)
        cfg_path = os.path.join(jax_copy, "config.json")
        results = run_clis([("train", ["--ckpt-dir", ck, "--config", cfg_path, "--steps",
                                       "5", "--resume", "--report-every", "1"])
                            for ck in (jax_copy, port_copy)], root)
        a, b = (params_to_numpy(CheckpointManager(ck, load_config(ORBAX)).restore(
            5, device="cpu").params) for ck in (jax_copy, port_copy))
        diff = max(float(np.abs(a[k] - b[k]).max()) for k in a)
        after = tree_hashes(jax_copy)
        check(diff <= 1e-6, f"train --resume: the orbax copy's params differ from the "
              f"port-format copy's by {diff}")
        check({k: v for k, v in after.items() if not k.startswith("5" + os.sep)} == before,
              "train --resume changed the JAX step's files")
        numbers["resume_max_param_diff"] = diff
        print(f"orbax (c): cli.train --resume 3 -> 5 on the card from the orbax copy and "
              f"from the port-format copy: params within {diff:.3g}; the JAX step's "
              f"{len(before)} files hash as before; process walls "
              + ", ".join(f"{w:.1f} s" for _, w in results))

        # (d) the library failing to build fails the read: no fallback
        saved = (zstd._lib, zstd._error, zstd.COMPILER, os.environ.get(
            build_cache.BUILD_DIR_ENV))
        try:
            zstd._lib, zstd._error, zstd.COMPILER = None, None, "no-such-compiler-g++"
            os.environ[build_cache.BUILD_DIR_ENV] = os.path.join(tmp, "empty_build")
            try:
                load_params_and_config(ORBAX, "cpu")
                raised = ""
            except zstd.ZstdUnavailable as e:
                raised = str(e).splitlines()[0]
        finally:
            zstd._lib, zstd._error, zstd.COMPILER = saved[:3]
            if saved[3] is None:
                os.environ.pop(build_cache.BUILD_DIR_ENV, None)
            else:
                os.environ[build_cache.BUILD_DIR_ENV] = saved[3]
        check(bool(raised), "a zstd library that does not build did not fail the read")
        print(f"orbax (d): with the zstd library unbuildable the read raises: {raised[:120]}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"[phase 17] orbax: {numbers['phase_s']:.1f} s")
    return launches, numbers


# Phase 18: kernel R1 (threefry2x32 draws), which the port adds for the
# XLA op behind jax.random: against JAX's draws committed in
# tests/golden/jax_prng.npz (scripts/make_prng_fixture.py; the card's
# machine has no JAX) and against its plain version, then timed at the
# flagship train step's dropout-mask shapes.
PRNG_FIXTURE = os.path.join(REPO, "tests", "golden", "jax_prng.npz")
PRNG_N = 1 << 24
PRNG_KEEP = 0.9  # dropout 0.1, and the fixture's bernoulli p
# (B, T, width) of the train step's masks: the encoder's (S 256 after the
# strided convs) of the attention output and residuals, and of the FFN's
# hidden layer; the decoder's (T 96) likewise.
PRNG_SHAPES = ((32, 256, 256), (32, 256, 1024), (32, 96, 256), (32, 96, 1024))
R1_OUT_BYTES = {"bits": 4, "uniform": 4, "bernoulli": 1}
R1_KINDS = ("bits", "uniform", "bernoulli")  # the kernel's template argument 0, 1, 2
# R1's bound counts the instructions of the built kernel (its SASS, read with
# the toolkit's cuobjdump) and puts each on the H100 SM's pipe that issues it,
# with the pipe's lanes per SM per clock (the CUDA programming guide's
# throughput table for compute capability 9.0; Nsight Compute's pipe names):
# the ALU (integer add, logic, shifts, compares, selects) 64; the FMA pipe's
# heavy half, the only one that runs integer multiply-adds (IMAD, which nvcc
# also uses for plain adds and moves), 64; the whole FMA pipe (f32 add, mul,
# FMA and IMAD) 128; and every instruction takes an issue slot, four warp
# instructions (128 threads) an SM a clock.  Loads of constants and special
# registers, the store and EXIT count only there.  The bound is the busiest of
# these at the card's SM count and highest SM clock.  CUDA 12.9's build,
# per element: bits 58 ALU, 19 IMAD, 0 f32, 88 issued; uniform 60, 19, 2,
# 93; bernoulli 61, 19, 1, 93: bound by the ALU (61 / 64 clocks an element
# an SM, where the 77 integer operations of the source would take 77 / 64).
SASS_ALU = {"IADD3", "LOP3", "LOP", "SHF", "LEA", "ISETP", "FSETP", "FMNMX", "IMNMX",
            "SEL", "FSEL", "PRMT", "MOV", "PLOP3", "BMSK", "SGXT"}
SASS_IMAD = {"IMAD", "IMUL"}
SASS_F32 = {"FFMA", "FADD", "FMUL"}
SASS_BRANCH = {"BRA", "BRX", "JMP", "JMX", "CALL", "RET", "BSSY", "BSYNC", "BREAK",
               "WARPSYNC"}
PIPE_LANES = {"alu": 64, "imad": 64, "fma": 128, "issue": 128}
NORMAL_ULPS, GUMBEL_ATOL = 4, 2e-6


def r1_sass_counts() -> dict:
    """r1_sass_pipes of the built library's SASS."""
    from nanodecoder_tpu_torch.ops import _build

    cuobjdump = os.path.join(os.path.dirname(_build._nvcc()), "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", _build.library()], capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"cuobjdump failed: {res.stderr.strip()[:500]}")
    return r1_sass_pipes(res.stdout)


def r1_sass_pipes(sass: str) -> dict:
    """Per element, R1's instructions on each pipe (PIPE_LANES) in each
    kind's instance of `sass` (cuobjdump -sass): every instruction up to
    the last EXIT, which each thread that draws runs once (the kernel is
    straight-line: a branch fails the check)."""
    counts = {}
    for name, body in re.findall(r"Function : (\S+)\n(.*?)(?=Function : |\Z)",
                                 sass, re.S):
        m = re.search(r"threefry_kernelILi(\d)E", name)
        if not m:
            continue
        ops = re.findall(r"/\*[0-9a-f]{4}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)", body)
        ops = ops[:len(ops) - ops[::-1].index("EXIT")]
        branches = sorted(set(ops) & SASS_BRANCH)
        check(not branches, f"R1's SASS ({name}) branches ({branches}): its bound "
              "counts a straight-line kernel")
        imad = sum(op in SASS_IMAD for op in ops)
        counts[R1_KINDS[int(m.group(1))]] = {
            "alu": sum(op in SASS_ALU for op in ops), "imad": imad,
            "fma": imad + sum(op in SASS_F32 for op in ops), "issue": len(ops)}
    check(set(counts) == set(R1_KINDS), f"R1's SASS: instances {sorted(counts)}")
    return counts


def sm_clock_hz() -> float:
    """The card's highest SM clock (nvidia-smi clocks.max.sm)."""
    res = subprocess.run(["nvidia-smi", "--query-gpu=clocks.max.sm",
                          "--format=csv,noheader,nounits", "--id=0"],
                         capture_output=True, text=True, timeout=60)
    check(res.returncode == 0, f"nvidia-smi failed: {res.stderr.strip()}")
    return float(res.stdout.split()[0]) * 1e6


def r1_bound(n: int, kind: str, sass: dict, sm_per_s: float) -> tuple[float, str]:
    """The least time of n draws: the output written once against the
    memory rate, the busiest pipe's instructions (r1_sass_counts) against
    its lanes at `sm_per_s` SM clocks a second (SMs x clock)."""
    t_bytes = n * R1_OUT_BYTES[kind] / HBM_BYTES_PER_S * 1e3
    clocks = max(c / PIPE_LANES[pipe] for pipe, c in sass[kind].items())
    t_ops = n * clocks / sm_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def f32_ulps(a: np.ndarray, b: np.ndarray) -> int:
    return int(np.abs(a.astype(np.float32).view(np.int32).astype(np.int64)
                      - b.astype(np.float32).view(np.int32)).max())


def phase_prng(dev) -> dict:
    """Phase 18: (a) R1's bits, uniform (the fixture's glorot range) and
    bernoulli (p 0.9) at 2^24 draws from counter 0 and from the fixture's
    offset past 2^32, each equal to its plain version on the card and its
    head equal to JAX's draws; normal within 4 ulps and gumbel within
    2e-6 of JAX's; (b) bernoulli at each train-step mask shape: the
    kernel's time per call and device-only (CUDA graph), the plain
    version's, torch.rand's for as many floats (a yardstick: another
    function), the bound.  Returns the numbers."""
    from nanodecoder_tpu_torch import prng
    from nanodecoder_tpu_torch.ops.threefry import (threefry_draw, threefry_draw_plain,
                                                    threefry_draw_table)

    with np.load(PRNG_FIXTURE) as f:
        saved = {k: f[k] for k in f.files}
    key, off = saved["key"], int(saved["offset"])
    lim = math.sqrt(6.0 / (256 + 1024))  # the fixture's uniform range
    kinds = {"bits": {}, "uniform": {"lo": -lim, "hi": lim}, "bernoulli": {"p": PRNG_KEEP}}
    worst_ulps, worst_gap = 0, 0.0
    for pre, offset in (("", 0), ("off_", off)):
        for kind, kw in kinds.items():
            got = threefry_draw(key, PRNG_N, kind, offset=offset, device=dev, **kw)
            plain = threefry_draw_plain(key, PRNG_N, kind, offset=offset, device=dev, **kw)
            torch.cuda.synchronize()
            check(torch.equal(got, plain), f"R1 {kind} at offset {offset}: the kernel and "
                  f"its plain version differ in {int((got != plain).sum())} of {PRNG_N}")
            want = saved[pre + kind]
            head = got[:len(want)].cpu().numpy()
            check(np.array_equal(head.view(np.uint32) if kind == "bits" else head, want),
                  f"R1 {kind} at offset {offset}: not JAX's draws")
            del got, plain
        n = len(saved[pre + "normal"])
        ulps = f32_ulps(prng.normal(key, (n,), device=dev, offset=offset).cpu().numpy(),
                        saved[pre + "normal"])
        gap = float(np.abs(prng.gumbel(key, (n,), device=dev, offset=offset).cpu().numpy()
                           - saved[pre + "gumbel"]).max())
        worst_ulps, worst_gap = max(worst_ulps, ulps), max(worst_gap, gap)
    print(f"R1: bits, uniform and bernoulli at 2^24 draws from counter 0 and from "
          f"{off} (past 2^32): equal to the plain version on the card and to JAX's "
          f"draws; normal within {worst_ulps} ulps, gumbel within {worst_gap:.2e} of JAX's")
    check(worst_ulps <= NORMAL_ULPS, f"R1 normal: {worst_ulps} ulps from JAX's")
    check(worst_gap <= GUMBEL_ATOL, f"R1 gumbel: {worst_gap} from JAX's")

    sass = r1_sass_counts()
    sm_per_s = torch.cuda.get_device_properties(dev).multi_processor_count * sm_clock_hz()
    print(f"R1's SASS per element (pipe: instructions): {sass}; "
          f"{sm_per_s / 1e9:.1f} G SM clocks a second")
    shapes = {}
    table = torch.from_numpy(np.asarray(key, np.uint32).reshape(1, 2).view(np.int32)).to(dev)
    for shape in PRNG_SHAPES:
        n = math.prod(shape)

        def draw(n=n):
            return threefry_draw(key, n, "bernoulli", p=PRNG_KEEP, device=dev)

        def draw_table(n=n):
            return threefry_draw_table(table, 0, n, "bernoulli", p=PRNG_KEEP)
        check(torch.equal(draw_table(), draw()),
              f"R1 bernoulli {shape}: the table-keyed kernel differs from the scalar-keyed")
        call_ms = cuda_ms(draw)
        device_ms = graph_ms(draw, n=20)
        table_call_ms = cuda_ms(draw_table)
        table_device_ms = graph_ms(draw_table, n=20)
        plain_ms = cuda_ms(lambda: threefry_draw_plain(key, n, "bernoulli", p=PRNG_KEEP,
                                                       device=dev), reps=5, warmup=1)
        rand_ms = graph_ms(lambda: torch.rand(n, device=dev), n=20)
        bound_ms, by = r1_bound(n, "bernoulli", sass, sm_per_s)
        shapes["x".join(map(str, shape))] = {
            "call_ms": call_ms, "device_ms": device_ms, "plain_ms": plain_ms,
            "torch_rand_ms": rand_ms, "bound_ms": bound_ms, "bound_by": by,
            "bound_share": bound_ms / device_ms, "table_call_ms": table_call_ms,
            "table_device_ms": table_device_ms}
        print(f"R1 bernoulli {shape} ({n} draws): {call_ms:.4f} ms a call, "
              f"{device_ms:.4f} ms device-only, bound {bound_ms:.4f} ms ({by}; share "
              f"{bound_ms / device_ms:.2f}); plain {plain_ms:.3f} ms; torch.rand of "
              f"{n} floats {rand_ms:.4f} ms device-only (a yardstick: another function); "
              f"table-keyed {table_call_ms:.4f} ms a call, {table_device_ms:.4f} ms "
              f"device-only")
    per_step = {name: ms for name, ms in zip(
        ("enc_d", "enc_ffn", "dec_d", "dec_ffn"),
        (v["device_ms"] for v in shapes.values()))}
    model = load_config("float32", "float32", 640).model
    step_ms = (model.enc_layers * (2 * per_step["enc_d"] + per_step["enc_ffn"])
               + model.dec_layers * (3 * per_step["dec_d"] + per_step["dec_ffn"]))
    print(f"R1 in a flagship train step (batch 32, {train_draws(train_config(32).model)} "
          f"draws): {step_ms:.4f} ms device-only")
    return {"shapes": shapes, "train_step_ms": step_ms, "normal_ulps": worst_ulps,
            "gumbel_max_abs": worst_gap, "sass": sass}


def kernel_times(names: list[str]) -> int:
    """--kernels: phase 1 and the named kernels' phase 2 only (K4a in the
    three dtypes, K3, K2 at four widths, K7); one JSON line of their
    numbers.  With --root on an unpacked older tree, the same measurement
    of that tree's kernels."""
    from nanodecoder_tpu_torch.ops import _build

    dev = torch.device("cuda", 0)
    stats = {}
    try:
        phase_card()
        t0 = time.perf_counter()
        _build.load()
        print(f"kernel build or load: {time.perf_counter() - t0:.1f} s")
        rng = np.random.default_rng(0)
        for name in names:
            if name == "K4a":
                stats[name] = {kind: phase_k4(kind, 1, dev, rng)
                               for kind in ("float32", "bfloat16", "int8")}
            elif name == "K3":
                floor_ms = phase_floor() if hasattr(_build.load(), "nd_empty_kernel") \
                    else None
                stats[name] = {"float32": phase_k3(dev, floor_ms)}
            elif name == "K2":
                stats[name] = {f"{str(dt)[6:]}_c{c}": phase_k2(dt, dev, c)
                               for c in (256, 1536) for dt in F32_BF16}
            elif name == "K7":
                stats[name] = {"float32": phase_k7(dev)}
            elif name == "R1":
                stats[name] = phase_prng(dev)
            else:
                raise SmokeError(f"--kernels takes K4a, K3, K2, K7 and R1, not {name}")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1
    print(json.dumps({"kernel_times": stats}))
    return 0


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernels", default="",
                    help="comma-separated K4a, K3, K2, K7, R1: time only these kernels "
                         "and stop")
    ap.add_argument("--root", default=REPO,
                    help="the checkout whose nanodecoder_tpu_torch to import")
    args = ap.parse_args(argv or [])
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    root = os.path.abspath(args.root)
    if not os.path.isdir(os.path.join(root, "nanodecoder_tpu_torch")):
        print("chip_smoke: run it from a checkout of the repository",
              file=sys.stderr)
        return 2
    sys.path.insert(0, root)
    if args.kernels:
        return kernel_times(args.kernels.split(","))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from nanodecoder_tpu_torch import profile_serving
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz, params_from_numpy

    wrappers = kernel_wrappers()

    def reset():
        reset_launches(wrappers)

    def counts():
        return launch_counts(wrappers)

    def expect(path, got, **want):
        for name, n in want.items():
            check(got[name] == n, f"{path} path: {name} launched {got[name]} times, "
                  f"expected {n}")

    dev = torch.device("cuda", 0)
    t_start = time.perf_counter()

    def elapsed(done: str) -> None:
        print(f"[{time.perf_counter() - t_start:.1f} s] {done} done")
    try:
        phase_card()
        phase_build()
        floor_ms = phase_floor()
        rng = np.random.default_rng(0)
        f32, bf16 = torch.float32, torch.bfloat16
        stats = {name: {str(dt)[6:]: phase_enc_attn(name, dt, dev, rng)
                        for dt in (f32, bf16)} for name in ("K1", "K5", "K6")}
        stats["K2"] = {f"{str(dt)[6:]}{'' if c == 256 else f'_c{c}'}":
                       phase_k2(dt, dev, c) for c in (256, 1536) for dt in (f32, bf16)}
        stats["K3"] = {"float32": phase_k3(dev, floor_ms)}
        stats["K7"] = {"float32": phase_k7(dev)}
        for name, group in (("K4a", 1), ("K4b", 5)):
            stats[name] = {kind: phase_k4(kind, group, dev, rng)
                           for kind in ("float32", "bfloat16", "int8")}
        stats["K4a"].update({f"gqa_{kind}_nkv{n_kv}": phase_k4a_gqa(kind, n_kv, dev, rng)
                             for kind in ("float32", "bfloat16") for n_kv in (1, 2)})

        golden_cfg = load_config("float32", "float32", 640)
        serve_cfg = load_config("bfloat16", "int6", 640)
        params = load_params_npz(NPZ, golden_cfg.model, device=dev)
        enc_layers, dec_layers = golden_cfg.model.enc_layers, golden_cfg.model.dec_layers
        paths = {}

        elapsed("phases 1-2")
        reset()  # the greedy path: phases 3-4
        gb, gs = phase_golden(params, golden_cfg)
        phase4 = {}
        n_identity = len(IDENTITY.calls)
        sb, ss, greedy_idents = phase_serving(params, serve_cfg, record=phase4)
        phase4_calls = (n_identity, len(IDENTITY.calls))
        paths["greedy"] = greedy = counts()
        batches, steps = gb + sb, gs + ss
        check(greedy["K2"] >= steps > 0,
              f"K2 launched {greedy['K2']} times for {steps} greedy decode steps")
        expect("greedy", greedy, K1=enc_layers * batches, K3=0, K4a=0, K4b=0, K5=0)

        beam = {"mode": "beam", "beam_size": 5, "batch_chunks_beam": 256}
        parity_beam = {**beam, "batch_chunks_beam": 8}
        elapsed("phases 3-4")
        reset()  # the beam path: phases 5-6
        pb, ps, mqa_beam_seq = phase_beam_parity(
            params, load_config("float32", "float32", 640, **parity_beam))
        bb, bsteps = phase_beam_serving(params, load_config("bfloat16", "int6", 640,
                                                            **beam), greedy_idents)
        paths["beam"] = beamc = counts()
        batches, steps = pb + bb, ps + bsteps
        check(beamc["K2"] >= steps > 0,
              f"K2 launched {beamc['K2']} times for {steps} beam decode steps")
        expect("beam", beamc, K1=enc_layers * batches, K3=steps, K4a=0, K4b=0, K5=0)

        # Phases 7-8: the flagship in MHA form.
        mha = {"dec_kv_heads": 0}
        with np.load(NPZ) as data:
            flat = profile_serving.expand_kv_heads({k: data[k] for k in data.files},
                                   golden_cfg.model.dec_heads)
        mha_params = params_from_numpy(
            flat, load_config("float32", "float32", 640, model=mha).model, device=dev)

        elapsed("phases 5-6")
        reset()  # lean MHA: phase 7
        gb, gs = phase_golden(mha_params, load_config("float32", "float32", 640,
                                                      model=mha), "lean MHA golden f32")
        sb, ss, mha_idents = phase_serving(
            mha_params, load_config("bfloat16", "int6", 640, model=mha), 20,
            "lean MHA bf16/int6/b640")
        ib, isteps, int8_idents = phase_serving(
            mha_params, load_config("bfloat16", "int6", 640,
                                    model={**mha, "cross_cache_int8": True}), 20,
            "lean MHA int8 cross caches bf16/int6/b640")
        gap = float(np.mean(int8_idents)) - float(np.mean(mha_idents))
        print(f"lean MHA: int8 cross caches minus exact, mean identity on the same 20 "
              f"reads {gap:+.4f}; exact MHA minus phase 4 (MQA) "
              f"{float(np.mean(mha_idents)) - float(np.mean(greedy_idents[:20])):+.4f}")
        pb, ps, _ = phase_beam_parity(
            mha_params, load_config("float32", "float32", 640, model=mha, **parity_beam),
            mqa_beam_seq, "lean MHA beam f32/K5")
        bb, bsteps = phase_beam_serving(
            mha_params, load_config("bfloat16", "int6", 640, model=mha, **beam),
            label="lean MHA beam")
        paths["mha"] = mhac = counts()
        greedy_steps, beam_steps = gs + ss + isteps, ps + bsteps
        check(mhac["K2"] >= greedy_steps + beam_steps,
              f"K2 launched {mhac['K2']} times on the lean MHA path")
        expect("mha", mhac, K1=enc_layers * (gb + sb + ib + pb + bb),
               K4a=dec_layers * greedy_steps, K4b=dec_layers * beam_steps, K3=beam_steps,
               K5=0, K4a_scalar=0, K4b_scalar=0)

        elapsed("phase 7")
        reset()  # unfolded MHA: phase 8
        unf = {**mha, "lean_step": False}
        gb, gs = phase_golden(mha_params, load_config("float32", "float32", 640,
                                                      model=unf),
                              "unfolded MHA golden f32")
        sb, ss, _ = phase_serving(mha_params, load_config("bfloat16", "int6", 640,
                                                          model=unf), 20,
                                  "unfolded MHA bf16/int6/b640")
        pb, ps, _ = phase_beam_parity(
            mha_params, load_config("float32", "float32", 640, model=unf, **parity_beam),
            mqa_beam_seq, "unfolded MHA beam f32/K5")
        paths["unfolded"] = unfc = counts()
        expect("unfolded", unfc, K1=0, K2=0, K4a=dec_layers * (gs + ss),
               K4b=dec_layers * ps, K3=ps, K5=enc_layers * (gb + sb + pb), K4a_scalar=0,
               K4b_scalar=0)
        elapsed("phase 8")
        reset()  # phase 9: the flagship by the plain PyTorch route
        gb, gs = phase_golden(params, load_config("float32", "float32", 640, pallas=False),
                              "golden f32 without kernels")
        pb, ps, _ = phase_beam_parity(
            params, load_config("float32", "float32", 640, pallas=False, **parity_beam),
            mqa_beam_seq, "beam f32/K5 without kernels")
        paths["no_pallas"] = plainc = counts()
        check(plainc["K2"] >= gs + ps > 0,
              f"K2 launched {plainc['K2']} times for {gs + ps} decode steps")
        expect("no_pallas", plainc, K1=0, K3=0, K4a=0, K4b=0, K5=0, K6=0, K7=0)

        elapsed("phase 9")
        wide = phase_wide(dev, rng)  # phase 10
        elapsed("phase 10")
        for key, prefixes in (("K1", ("K1/", "K1 ")), ("K2", ("K2 ",)),
                              ("K4a", ("K4a ",)), ("K4b", ("K4b ",))):
            stats[key]["wide"] = {k: v for k, v in wide.items() if k.startswith(prefixes)}
        paths["tiny"] = phase_tiny(dev, reset, counts)  # phase 11
        elapsed("phase 11")
        paths["engine"] = phase_engine(params, reset, counts, phase4, root)  # phase 12
        elapsed("phase 12")
        paths["train"], paths["train_serve"], train_numbers = phase_train(
            dev, reset, counts, phase4, root)  # phase 13
        print("train numbers: " + json.dumps(train_numbers))
        elapsed("phase 13")
        rnn_paths, rnn_numbers = phase_rnn(dev, reset, counts, expect)  # phase 14
        paths.update(rnn_paths)
        print("rnn numbers: " + json.dumps(rnn_numbers))
        elapsed("phase 14")
        mode_paths, mode_numbers = phase_modes(params, reset, counts, expect,
                                               phase4)  # phase 15
        paths.update(mode_paths)
        print("decode mode numbers: " + json.dumps(mode_numbers))
        elapsed("phase 15")
        dp_paths, dp_numbers = phase_host_dp(params, reset, counts, dev, root,
                                             phase4_calls)  # phase 16
        paths.update(dp_paths)
        print("host and data-parallel numbers: " + json.dumps(dp_numbers))
        elapsed("phase 16")
        paths["orbax"], orbax_numbers = phase_orbax(dev, reset, counts, root)  # phase 17
        print("orbax numbers: " + json.dumps(orbax_numbers))
        elapsed("phase 17")
        prng_numbers = phase_prng(dev)  # phase 18
        elapsed("phase 18")
        check(all(c["K6"] == c["K7"] == 0 for c in paths.values()),
              "K6 or K7 launched on a serving path")
        drawers = {"train", "sample", *(f"dp_rank{r}" for r in range(DP_WORLD))}
        drawn = {path for path, c in paths.items() if c["R1"]}
        check(drawn == drawers, f"R1 launched on the paths {sorted(drawn)}: training "
              f"and sample mode ({sorted(drawers)}) draw, and no other")
        for path, c in paths.items():
            print(f"launches, {path} path: {c}")
        left = live_children()
        check(not left, f"processes still running: {left}")
        print(f"chip_smoke: {time.perf_counter() - t_start:.1f} s")
    except SmokeError as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr)
        return 1

    def entry(name, source, replaces, kernel_stats, note=""):
        key = name.split()[0]
        by_path = {path: c[key] for path, c in paths.items()}
        primary = "bfloat16" if "bfloat16" in kernel_stats else "float32"
        out = {"name": name, "route": "cuda", "source": source, "replaces": replaces,
               "launches": sum(by_path.values()), "launches_by_path": by_path,
               **({"scalar_kernel_launches_by_path": {
                   path: c[f"{key}_scalar"] for path, c in paths.items()}}
                  if key in ("K4a", "K4b") else {}),
               **kernel_stats[primary], "dtype": primary,
               **{k: v for k, v in kernel_stats.items() if k != primary}}
        if key in ("K2", "K3", "K7"):
            out["launch_floor_graph_ms"] = floor_ms
        return {**out, "note": note} if note else out

    enc, dec = "nanodecoder_tpu_torch/csrc/encoder_attention.cu", \
        "nanodecoder_tpu_torch/csrc/decode_attention.cu"
    beam_src = "nanodecoder_tpu_torch/csrc/beam_step.cu"
    kernels = [
        entry("K1 flash_encoder_attention_qkv", enc,
              "nanodecoder_tpu/ops/encoder_attention.py:154", stats["K1"]),
        entry("K2 write_cache_block", "nanodecoder_tpu_torch/csrc/cache_update.cu",
              "nanodecoder_tpu/ops/cache_update.py:35", stats["K2"],
              "top-level times at C 256 (MQA); *_c1536 at the MHA self-cache width"),
        entry("K3 beam_advance", beam_src, "nanodecoder_tpu/ops/beam_step.py:68",
              stats["K3"], "one launch per beam decode step"),
        entry("K4a decode_attention", dec, "nanodecoder_tpu/ops/attention.py:62",
              stats["K4a"], "B 640, T 256, D 256, 8 heads; 3 launches per MHA greedy "
              "step; int8: int8 caches, f32 queries; gqa_*: n_kv KV heads, checked "
              "and timed in phase 2 only; wide: phase 10's shapes"),
        entry("K4b decode_attention_grouped", dec, "nanodecoder_tpu/ops/attention.py:201",
              stats["K4b"], "B 256, G 5; 3 launches per MHA beam step"),
        entry("K5 flash_encoder_attention_nld", enc,
              "nanodecoder_tpu/ops/encoder_attention.py:85", stats["K5"],
              "one launch per encoder layer of the unfolded path; on the train path "
              "(phase 13) only in validation, one per encoder layer and batch "
              "(launches_by_path.train)"),
        entry("K6 flash_encoder_attention", enc,
              "nanodecoder_tpu/ops/encoder_attention.py:28", stats["K6"],
              "on no serving path (its only JAX caller is a test); launched only "
              "in phases 2 and 10"),
        entry("K7 beam_topk", beam_src, "nanodecoder_tpu/ops/beam_step.py:37",
              stats["K7"], "on no serving path (its only JAX caller is a test); "
              "launched only in phase 2"),
    ]
    main_shape = prng_numbers["shapes"]["32x256x1024"]
    kernels.append({
        "name": "R1 threefry_draw", "route": "cuda",
        "source": "nanodecoder_tpu_torch/csrc/threefry.cu",
        "replaces": "jax/_src/prng.py:1184 (threefry2x32_p under jax.random, an XLA op: "
                    "no Pallas site)",
        "launches": sum(c["R1"] for c in paths.values()),
        "launches_by_path": {path: c["R1"] for path, c in paths.items()},
        "max_abs_err": 0.0, "ms": main_shape["device_ms"],
        "call_ms": main_shape["call_ms"], "plain_ms": main_shape["plain_ms"],
        "bound_ms": main_shape["bound_ms"], "bound_by": main_shape["bound_by"],
        "library_ms": None, "torch_rand_ms": main_shape["torch_rand_ms"],
        "shapes": prng_numbers["shapes"], "train_step_ms": prng_numbers["train_step_ms"],
        "normal_ulps": prng_numbers["normal_ulps"],
        "gumbel_max_abs": prng_numbers["gumbel_max_abs"],
        "sass_per_element": prng_numbers["sass"],
        "note": "bernoulli (p 0.9) at the (32, 256, 1024) encoder FFN mask; ms device-only; "
                "bits, uniform and masks equal to the plain version and to JAX's (max_abs_err "
                "0); no PyTorch call draws threefry (library_ms null; torch.rand is timed as "
                "a yardstick)"})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
