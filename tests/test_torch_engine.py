"""PyTorch port, the streaming engine and the basecall CLI, each held
against the JAX package on the same fast5 files and the same weights.

Small config: d 64, 2 encoder heads, an MQA decoder of 4 query heads
(the flagship's form), 2 + 2 layers, max_decode_len 48, chunks of 256
samples, batches of 8 chunks; f32 compute; the plain route on both sides
(use_pallas false, as the JAX CLI takes it on the CPU).  The JAX init
has its generator scaled 3x, so chunks end by EOS on both sides of a
stage boundary and some run to the end.  The reads are simulated (seed
5), stored as int16 in multi-read fast5 files as tests/test_engine.py
writes them.

The FASTQ must be byte-equal in ids, sequences and record order, with
qualities within 1 Phred per base (the f32 sums run in another order;
tests/test_torch_golden.py states the same tolerance).
"""

import functools
import io
import os
import subprocess
import sys
from unittest import mock

import h5py
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N_FILES, READS_PER_FILE = 2, 3


def _jcfg(mode: str = "greedy", wire: str = "float32"):
    from nanodecoder_tpu.config import Config, DecodeConfig, ModelConfig, SignalConfig

    model = ModelConfig(vocab_size=8, d_model=64, conv_channels=(16, 32, 64),
                        enc_layers=2, enc_heads=2, enc_ffn_dim=128, dec_layers=2,
                        dec_heads=4, dec_kv_heads=1, dec_ffn_dim=128,
                        max_decode_len=48, staged_decode=True,
                        compute_dtype="float32", use_pallas=False)
    return Config(signal=SignalConfig(chunk_len=256, chunk_overlap=32), model=model,
                  decode=DecodeConfig(max_len=48, batch_chunks=8, batch_chunks_engine=8,
                                      use_pallas=False, mode=mode, beam_size=3,
                                      h2d_dtype=wire))


def _port_cfg(mode: str = "greedy", wire: str = "float32"):
    from nanodecoder_tpu_torch.config import Config

    return Config.from_json(_jcfg(mode, wire).to_json())


@functools.lru_cache(maxsize=None)
def _jparams():
    import jax

    from nanodecoder_tpu.models.model import init_model

    params = init_model(jax.random.PRNGKey(3), _jcfg().model)
    params["generator"]["w"] = params["generator"]["w"] * 3.0
    return params


def _flat() -> dict:
    import jax

    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(_jparams())[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)
        flat[key] = np.asarray(leaf)
    return flat


def _port_engine(mode="greedy", wire="float32", **kw):
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    cfg = _port_cfg(mode, wire)
    return StreamingBasecaller(params_from_numpy(_flat(), cfg.model, device="cpu"), cfg,
                               device="cpu", **kw)


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small model's many tiny ops run fastest on one thread, and far
    faster than on eight when the suite's other workers hold the cores;
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _write_multi_fast5(path, reads):
    with h5py.File(path, "w") as f:
        for rid, sig in reads.items():
            raw = f.create_group(f"read_{rid}/Raw")
            raw.attrs["read_id"] = rid.encode()
            raw.create_dataset("Signal", data=sig.astype(np.int16))


@pytest.fixture(scope="module")
def fast5_files(tmp_path_factory):
    return write_fast5_files(tmp_path_factory.mktemp("fast5"))


def write_fast5_files(root) -> list[str]:
    """The module's reads (seed 5) in N_FILES multi-read fast5 files under
    root; their paths, sorted."""
    from nanodecoder_tpu.train.data import SimSpec, simulate_read

    rng = np.random.default_rng(5)
    spec = SimSpec()
    for fi in range(N_FILES):
        reads = {}
        for ri in range(READS_PER_FILE):
            _truth, sig = simulate_read(rng, int(rng.integers(60, 200)), spec)
            reads[f"r{fi}_{ri}"] = np.rint(sig * 4)
        _write_multi_fast5(str(root / f"f{fi}.fast5"), reads)
    return sorted(str(root / f"f{fi}.fast5") for fi in range(N_FILES))


@functools.lru_cache(maxsize=None)
def _jax_engine(mode: str, wire: str):
    """One JAX engine (compiled once) per mode and wire."""
    from nanodecoder_tpu.decode.engine import StreamingBasecaller

    return StreamingBasecaller(_jparams(), _jcfg(mode, wire))


@functools.lru_cache(maxsize=None)
def _jax_run(mode: str, wire: str, files: tuple, stitch: str = "trim",
             write_format: str = "fastq", skip: tuple = ()) -> str:
    buf = io.StringIO()
    _jax_engine(mode, wire).run(list(files), buf, stitch_method=stitch, num_workers=2,
                                write_format=write_format, skip_read_ids=set(skip))
    return buf.getvalue()


def assert_fastq_close(got: str, ref: str) -> None:
    """Records in the same order with the same ids and sequences; Phred+33
    quality characters within 1 of each other."""
    a, b = got.splitlines(), ref.splitlines()
    assert len(a) == len(b) and len(a) % 4 == 0 and a
    for i in range(0, len(a), 4):
        assert a[i:i + 3] == b[i:i + 3], (a[i], b[i])
        qa = np.frombuffer(a[i + 3].encode(), np.uint8).astype(int)
        qb = np.frombuffer(b[i + 3].encode(), np.uint8).astype(int)
        assert qa.shape == qb.shape and (qa.shape[0] == 0 or np.abs(qa - qb).max() <= 1)


@pytest.mark.parametrize("wire", ["float32", "int6"])
@pytest.mark.parametrize("stitch", ["trim", "attn"])
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_engine_fastq_matches_jax(fast5_files, mode, stitch, wire):
    ref = _jax_run(mode, wire, tuple(fast5_files), stitch)
    engine = _port_engine(mode, wire)
    out = io.StringIO()
    meter = engine.run(fast5_files, out, stitch_method=stitch, num_workers=2)
    assert meter.n_reads == N_FILES * READS_PER_FILE
    assert engine.batches >= 2  # reads packed across batches
    assert_fastq_close(out.getvalue(), ref)
    seqs = out.getvalue().splitlines()[1::4]
    assert all(seqs) and len(set(map(len, seqs))) > 1


def test_engine_chunks_end_on_both_sides_of_a_stage_boundary(fast5_files):
    """The fixture's chunks end by EOS before and after the stage boundary
    at 24 steps (stages of 8, 24 and 48), and some run to the end."""
    from nanodecoder_tpu_torch.decode.greedy import decode_stage_lengths
    from nanodecoder_tpu_torch.io.pipeline import AsyncChunkPipeline

    assert decode_stage_lengths(48) == [8, 24, 48]

    engine = _port_engine()
    pipe = AsyncChunkPipeline(fast5_files, engine.config.signal, 8, num_workers=2,
                              ingest="thread")
    lengths = []
    for pb in pipe.batches():
        lengths.append(engine._decode(pb.chunks, pb.lengths)[0][1][:pb.n_real].numpy())
    lengths = np.concatenate(lengths)
    assert (lengths < 24).any() and ((lengths > 24) & (lengths < 48)).any()
    assert (lengths == 48).any()


def test_engine_without_attn_pos_matches_default(fast5_files):
    a, b = io.StringIO(), io.StringIO()
    _port_engine().run(fast5_files, a, num_workers=2)
    _port_engine(attn_pos=False).run(fast5_files, b, num_workers=2)
    assert a.getvalue() == b.getvalue()


def test_engine_resume_done_log_and_fasta_match_jax(fast5_files):
    """skip_read_ids drops those reads; the done log lists the written
    ids in output order; FASTA as the JAX engine writes it."""
    out, done = io.StringIO(), io.StringIO()
    _port_engine().run(fast5_files, out, skip_read_ids={"r0_1", "r1_0"}, num_workers=2,
                       write_format="fasta", done_log=done)
    text = out.getvalue()
    assert text == _jax_run("greedy", "float32", tuple(fast5_files), "trim", "fasta",
                            ("r0_1", "r1_0"))
    ids = text.splitlines()[0::2]
    assert all(i.startswith(">") for i in ids)
    assert done.getvalue().split() == [i[1:] for i in ids]
    assert len(ids) == N_FILES * READS_PER_FILE - 2
    assert ">r0_1\n" not in text and ">r1_0\n" not in text


def test_engine_stage_timer(fast5_files):
    from nanodecoder_tpu_torch.utils.profiling import StageTimer

    timer = StageTimer()
    engine = _port_engine()
    engine.run(fast5_files, io.StringIO(), num_workers=2, stage_timer=timer)
    summary = timer.summary()
    assert set(summary) == {"ingest-wait", "dispatch", "backpressure-wait", "d2h-wait",
                            "stitch+write", "wall"}
    assert summary["dispatch"]["count"] == engine.batches
    assert summary["wall"]["count"] == 1


def test_engine_spans(fast5_files, monkeypatch):
    """With the span recorder on: every batch has its dispatch, upload,
    encode and decode-step spans; one decode.step a counted step, each
    holding one decode.sync; one ingest.file a file, run in another
    process between its submit and its receipt, their reads the reads
    given; one finish.read a read."""
    import collections
    import time

    from nanodecoder_tpu_torch.io import pipeline
    from nanodecoder_tpu_torch.utils import profiling

    sent = []
    pool_of = pipeline._get_ingest_pool

    class TimedPool:
        def __init__(self, pool):
            self.pool = pool

        def submit(self, fn, *args):
            t = [time.perf_counter_ns(), None]
            fut = self.pool.submit(fn, *args)
            fut.add_done_callback(lambda _f: t.__setitem__(1, time.perf_counter_ns()))
            sent.append(t)
            return fut

    monkeypatch.setattr(pipeline, "_get_ingest_pool", lambda n: TimedPool(pool_of(n)))
    engine = _port_engine()
    profiling.drain()
    profiling.enable()
    try:
        engine.run(fast5_files, io.StringIO(), num_workers=2)
    finally:
        profiling.disable()
    spans = profiling.drain()
    by_name = collections.defaultdict(list)
    for sp in spans:
        by_name[sp.name].append(sp)
    assert engine.batches > 1
    for b in range(engine.batches):
        names = {sp.name for sp in spans if sp.b == b}
        assert {"ingest-wait", "dispatch", "translator.h2d", "model.encode",
                "decode.step", "decode.sync", "stitch+write"} <= names, b
    steps = by_name["decode.step"]
    assert len(steps) == engine.decode_steps
    assert sorted(sp.parent for sp in by_name["decode.sync"]) == sorted(sp.id for sp in steps)
    files = by_name["ingest.file"]
    assert len(files) == len(sent) == N_FILES
    for sp, (t_submit, t_receipt) in zip(files, sent):
        assert sp.pid != os.getpid()
        assert t_submit <= sp.start_ns < sp.end_ns <= t_receipt
    assert sum(sp.reads for sp in files) == N_FILES * READS_PER_FILE
    assert len(by_name["finish.read"]) == N_FILES * READS_PER_FILE
    assert all(sp.pid != os.getpid() for sp in by_name["finish.read"])
    assert len(by_name["wall"]) == 1


def _boom_finish_task(*args, **kwargs):
    raise RuntimeError("boom")


def test_engine_relays_a_finish_task_error(fast5_files):
    """A failure inside the per-read finish task, run in the process pool
    (the patch target is a module-level function, pickled by reference),
    surfaces to the caller."""
    from nanodecoder_tpu_torch.decode import engine as eng

    with mock.patch.object(eng, "_finish_read_task", _boom_finish_task):
        with pytest.raises(RuntimeError, match="boom"):
            _port_engine().run(fast5_files, io.StringIO(), num_workers=2)


def test_engine_relays_a_writer_error(fast5_files):
    class BoomWriter:
        def write(self, s):
            raise RuntimeError("disk full")

    with pytest.raises(RuntimeError, match="disk full"):
        _port_engine().run(fast5_files, BoomWriter(), num_workers=2)


def test_engine_and_cli_default_to_cuda(monkeypatch, tmp_path, fast5_files):
    from nanodecoder_tpu_torch.cli import basecall
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = _port_cfg()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        StreamingBasecaller(params_from_numpy(_flat(), cfg.model, device="cpu"), cfg)
    ckpt = _write_ckpt(tmp_path)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        basecall.main(["--input", fast5_files[0], "--output", str(tmp_path / "o.fq"),
                       "--ckpt", ckpt])


def _write_ckpt(root) -> str:
    """The small model as an npz params export with config.json beside
    it, which both packages' CLIs read."""
    path = os.path.join(str(root), "params.npz")
    np.savez(path, **_flat())
    with open(os.path.join(str(root), "config.json"), "w") as f:
        f.write(_jcfg("greedy", "float32").to_json())
    return path


def _jax_cli(argv, tmp_path) -> None:
    env = {**os.environ, "JAX_PLATFORMS": "cpu",
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache"),
           "PYTHONPATH": REPO}
    res = subprocess.run([sys.executable, "-m", "nanodecoder_tpu.cli.basecall", "--cpu",
                          *argv], cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]


@pytest.mark.parametrize("beam", [0, 3])
def test_basecall_cli_matches_jax_cli(beam, tmp_path, fast5_files):
    """Both CLIs with --cpu --parity on the same files and npz export;
    then the port's --resume after a crash left a truncated trailing
    record: no read twice, every read once."""
    from nanodecoder_tpu_torch.cli import basecall

    ckpt = _write_ckpt(tmp_path)
    src = os.path.dirname(fast5_files[0])
    common = ["--input", src, "--ckpt", ckpt, "--parity", "--workers", "2",
              "--stitch", "attn", "--beam", str(beam)]
    port_out, jax_out = str(tmp_path / "port.fastq"), str(tmp_path / "jax.fastq")
    assert basecall.main(["--cpu", "--output", port_out, "--stage-times", *common]) == 0
    _jax_cli(["--output", jax_out, *common], tmp_path)
    full = open(port_out).read()
    assert_fastq_close(full, open(jax_out).read())

    # A crash mid-write: the last record cut in its sequence line, the
    # done log missing its id.
    lines = full.splitlines(keepends=True)
    with open(port_out, "w") as f:
        f.writelines(lines[:-4])
        f.write(lines[-4] + lines[-3][:5])
    done = open(port_out + ".done").read().split()
    with open(port_out + ".done", "w") as f:
        f.write("\n".join(done[:-2]) + "\n")
    assert basecall.main(["--cpu", "--output", port_out, "--resume", *common]) == 0
    resumed = open(port_out).read()
    assert resumed == full
    ids = resumed.splitlines()[0::4]
    assert len(ids) == len(set(ids)) == N_FILES * READS_PER_FILE
