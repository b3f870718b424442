"""PyTorch port, host I/O: the fast5 and pod5 readers, the svb16/vbz
codec and pod5 container, the FASTX resume scan and shard merge, and the
streaming ingest pipeline, each held against the JAX package's module on
the same inputs (numpy only; no torch device is used)."""

import dataclasses
import os

import h5py
import numpy as np
import pytest

from nanodecoder_tpu.io import fast5 as jf5
from nanodecoder_tpu.io import fastx as jfx
from nanodecoder_tpu.io import pipeline as jpipe
from nanodecoder_tpu.io import pod5 as jp5
from nanodecoder_tpu_torch.io import fast5 as tf5
from nanodecoder_tpu_torch.io import fastx as tfx
from nanodecoder_tpu_torch.io import pipeline as tpipe
from nanodecoder_tpu_torch.io import pod5 as tp5


def _write_single(path, read_id, raw, calibrated):
    with h5py.File(path, "w") as f:
        g = f.create_group("Raw/Reads/Read_7")
        g.attrs["read_id"] = read_id.encode()
        g.create_dataset("Signal", data=raw)
        if calibrated:
            ch = f.create_group("UniqueGlobalKey/channel_id")
            ch.attrs["offset"] = 10.0
            ch.attrs["range"] = 1400.0
            ch.attrs["digitisation"] = 8192.0


def _write_multi(path, raws, calibrated):
    with h5py.File(path, "w") as f:
        for rid, raw in raws.items():
            g = f.create_group(f"read_{rid}")
            raw_grp = g.create_group("Raw")
            raw_grp.attrs["read_id"] = rid.encode()
            raw_grp.create_dataset("Signal", data=raw)
            if calibrated:
                ch = g.create_group("channel_id")
                ch.attrs["offset"] = 5.0
                ch.attrs["range"] = 1000.0
                ch.attrs["digitisation"] = 4096.0


def _assert_reads_equal(got, ref):
    assert len(got) == len(ref) > 0
    for a, b in zip(got, ref):
        assert (a.read_id, a.source_file, a.channel_offset, a.channel_range,
                a.digitisation) == (b.read_id, b.source_file, b.channel_offset,
                                    b.channel_range, b.digitisation)
        assert a.signal.dtype == b.signal.dtype
        assert a.signal.tobytes() == b.signal.tobytes()


@pytest.mark.parametrize("calibrated", [True, False])
@pytest.mark.parametrize("layout", ["single", "multi"])
def test_read_fast5_file_matches_jax(layout, calibrated, tmp_path, rng_np):
    path = str(tmp_path / "x.fast5")
    if layout == "single":
        _write_single(path, "abc123", rng_np.integers(0, 2000, 1234).astype(np.int16),
                      calibrated)
    else:
        _write_multi(path, {f"r{i}": rng_np.integers(0, 2000, 300 + i).astype(np.int16)
                            for i in range(4)}, calibrated)
    _assert_reads_equal(tf5.read_fast5_file(path), jf5.read_fast5_file(path))


def test_list_and_iter_signal_files_match_jax(tmp_path, rng_np):
    (tmp_path / "sub").mkdir()
    for i, name in enumerate(["b.fast5", "sub/a.fast5", "c.h5"]):
        _write_multi(str(tmp_path / name),
                     {f"{i}_{j}": rng_np.integers(0, 900, 200).astype(np.int16)
                      for j in range(2)}, True)
    tp5.write_pod5(str(tmp_path / "d.pod5"), [tp5.Pod5Read("p0", np.arange(50, dtype=np.int16))])
    (tmp_path / "notes.txt").write_text("not a signal file")
    root = str(tmp_path)
    assert tf5.list_signal_files(root) == jf5.list_signal_files(root)
    assert len(tf5.list_signal_files(root)) == 4
    assert tf5.FAST5_EXTS == jf5.FAST5_EXTS
    _assert_reads_equal(list(tf5.iter_fast5_reads(root)), list(jf5.iter_fast5_reads(root)))


_SVB_INPUTS = {
    "random": np.random.default_rng(3).integers(-32768, 32767, 4097).astype(np.int16),
    "walk": np.cumsum(np.random.default_rng(4).integers(-300, 300, 5000)).astype(np.int16),
    "extremes": np.asarray([-32768, 32767, -32768, 32767, 0, 1, -1, 256, -257], np.int16),
    "empty": np.zeros(0, np.int16),
}


@pytest.mark.parametrize("zigzag", [True, False])
@pytest.mark.parametrize("delta", [True, False])
def test_svb16_bitwise_matches_jax(delta, zigzag):
    for name, sig in _SVB_INPUTS.items():
        enc = tp5.svb16_encode(sig, delta=delta, zigzag=zigzag)
        assert enc == jp5.svb16_encode(sig, delta=delta, zigzag=zigzag), name
        dec = tp5.svb16_decode(enc, len(sig), delta=delta, zigzag=zigzag)
        ref = jp5.svb16_decode(enc, len(sig), delta=delta, zigzag=zigzag)
        assert dec.dtype == ref.dtype == np.int16
        assert dec.tobytes() == ref.tobytes() == sig.tobytes(), name


def test_vbz_bitwise_matches_jax():
    for name, sig in _SVB_INPUTS.items():
        blob = tp5.vbz_compress(sig)
        assert blob == jp5.vbz_compress(sig), name
        assert tp5.vbz_decompress(blob, len(sig)).tobytes() == \
            jp5.vbz_decompress(blob, len(sig)).tobytes() == sig.tobytes()


def _pod5_reads(rng, mod, n=3):
    return [mod.Pod5Read(read_id=f"read_{i}",
                         signal=rng.integers(0, 2000, int(rng.integers(100, 4000))
                                             ).astype(np.int16),
                         read_number=i, calibration_offset=float(i),
                         calibration_scale=0.25) for i in range(n)]


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_pod5_across_packages(writer, tmp_path, rng_np):
    """pod5 written by one package, read by the other (signal rows split
    at 1000 samples): equal ids, signals and calibration, and the port's
    RawReads equal to JAX's."""
    path = str(tmp_path / "x.pod5")
    wmod, rmod = (jp5, tp5) if writer == "jax" else (tp5, jp5)
    reads = _pod5_reads(rng_np, wmod)
    wmod.write_pod5(path, reads, chunk_size=1000)
    back = rmod.read_pod5(path)
    assert [r.read_id for r in back] == [r.read_id for r in reads]
    for a, b in zip(reads, back):
        assert a.signal.tobytes() == b.signal.tobytes()
        assert (a.read_number, a.calibration_offset) == (b.read_number,
                                                         b.calibration_offset)
        assert abs(a.calibration_scale - b.calibration_scale) < 1e-7
    _assert_reads_equal(tf5.read_fast5_file(path), jf5.read_fast5_file(path))


def test_pod5_loud_failures_raise(tmp_path):
    sig = np.asarray([0, 5, -300, 7, 40000 - 65536, 2], np.int16)
    stream = tp5.svb16_encode(sig)
    for bad, count in ((stream + b"\0", len(sig)), (stream[:-1], len(sig)),
                       (stream, len(sig) - 1), (stream[:0], len(sig))):
        with pytest.raises(ValueError, match="svb16"):
            tp5.svb16_decode(bad, count)
    path = str(tmp_path / "t.pod5")
    tp5.write_pod5(path, [tp5.Pod5Read("r1", np.arange(100, dtype=np.int16))])
    data = open(path, "rb").read()
    footer_len = int.from_bytes(data[-32:-24], "little", signed=True)
    with open(path, "wb") as f:  # footer offsets now point past the end
        f.write(data[:24] + data[-32 - footer_len:])
    with pytest.raises(ValueError, match="footer entry"):
        tp5.read_pod5(path)
    with open(path, "wb") as f:
        f.write(b"not a pod5 file at all, but long enough to hold a footer")
    with pytest.raises(ValueError, match="signature"):
        tp5.read_pod5(path)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(tp5, "_zstd", None)
        with pytest.raises(RuntimeError, match="zstandard"):
            tp5.vbz_compress(sig)


@pytest.mark.parametrize("fmt", ["fastq", "fasta"])
def test_recover_fastx_output_matches_jax(fmt, tmp_path):
    if fmt == "fastq":
        body = "@r1\nACGT\n+\nIIII\n@r2 extra\nGG\n+\nII\n@r3\nAC"
    else:
        body = ">r1\nACGT\n>r2 extra\nGG\n>r3\nA"
    paths = [str(tmp_path / f"{who}.{fmt}") for who in ("port", "jax")]
    for p in paths:
        with open(p, "w") as f:
            f.write(body)
    ids = tfx.recover_fastx_output(paths[0], fmt)
    assert ids == jfx.recover_fastx_output(paths[1], fmt) == {"r1", "r2"}
    assert open(paths[0]).read() == open(paths[1]).read()
    assert tfx.recover_fastx_output(str(tmp_path / "missing"), fmt) == set()


def test_merge_fastx_shards_matches_jax(tmp_path):
    shards = []
    for i in (2, 0, 1):
        p = tmp_path / f"out.fastq.shard{i:05d}"
        p.write_text(f"@r{i}\nACGT\n+\nIIII\n")
        shards.append(str(p))
    tfx.merge_fastx_shards(shards, str(tmp_path / "port.fastq"))
    jfx.merge_fastx_shards(shards, str(tmp_path / "jax.fastq"))
    merged = (tmp_path / "port.fastq").read_text()
    assert merged == (tmp_path / "jax.fastq").read_text()
    assert merged.splitlines()[0::4] == ["@r0", "@r1", "@r2"]
    tfx.merge_fastx_shards(shards, str(tmp_path / "again.fastq"), delete_shards=True)
    assert not any(os.path.exists(p) for p in shards)


def _signal_files(tmp_path, rng, n_files=3, reads=4):
    files = []
    for fi in range(n_files):
        path = str(tmp_path / f"f{fi}.fast5")
        _write_multi(path, {f"s{fi}_{ri}": (rng.normal(size=int(rng.integers(300, 2500)))
                                             * 300).astype(np.int16)
                            for ri in range(reads)}, True)
        files.append(path)
    return files


def _scfg(mod):
    return mod.SignalConfig(chunk_len=256, chunk_overlap=32)


@pytest.mark.parametrize("wire", ["float32", "int6"])
@pytest.mark.parametrize("ingest", ["process", "thread"])
def test_pipeline_batches_match_jax(ingest, wire, tmp_path, rng_np):
    from nanodecoder_tpu import config as jcfg
    from nanodecoder_tpu_torch import config as tcfg

    files = _signal_files(tmp_path, rng_np)
    got = tpipe.AsyncChunkPipeline(files, _scfg(tcfg), 8, num_workers=2, h2d_dtype=wire,
                                   ingest=ingest)
    ref = jpipe.AsyncChunkPipeline(files, _scfg(jcfg), 8, num_workers=2, h2d_dtype=wire,
                                   ingest=ingest)
    a, b = list(got.batches()), list(ref.batches())
    assert len(a) == len(b) >= 3
    for x, y in zip(a, b):
        assert x.chunks.dtype == y.chunks.dtype and x.chunks.shape == y.chunks.shape
        assert x.chunks.tobytes() == y.chunks.tobytes()
        assert x.lengths.tobytes() == y.lengths.tobytes()
        assert (x.sources, x.n_real) == (y.sources, y.n_real)
    assert a[-1].n_real < 8 and (a[-1].lengths[a[-1].n_real:] == 0).all()
    assert [r.read.read_id for r in got.reads] == [r.read.read_id for r in ref.reads]
    for x, y in zip(got.reads, ref.reads):
        cx, cy = x.chunks, y.chunks
        assert (cx.starts.tobytes(), cx.lengths.tobytes(), cx.total_samples) == \
            (cy.starts.tobytes(), cy.lengths.tobytes(), cy.total_samples)


def test_pipeline_error_propagates(tmp_path):
    from nanodecoder_tpu_torch.config import SignalConfig

    bad = str(tmp_path / "bad.fast5")
    open(bad, "w").write("not hdf5")
    for ingest in ("process", "thread"):
        pipe = tpipe.AsyncChunkPipeline([bad], SignalConfig(), 2, ingest=ingest)
        with pytest.raises(Exception):
            list(pipe.batches())


def test_pipeline_stop_is_clean(tmp_path, rng_np):
    """The consumer abandons the stream with the producer blocked on a
    full queue: stop() unblocks it and its thread exits."""
    from nanodecoder_tpu_torch.config import SignalConfig

    files = _signal_files(tmp_path, rng_np, n_files=6, reads=4)
    pipe = tpipe.AsyncChunkPipeline(files, SignalConfig(chunk_len=256, chunk_overlap=32),
                                    2, num_workers=2, queue_depth=1)
    it = pipe.batches()
    next(it)
    pipe.stop()
    pipe._producer_thread.join(timeout=10.0)
    assert not pipe._producer_thread.is_alive()


def _running_in_session(sid: int) -> list[str]:
    found = []
    for pid in filter(str.isdigit, os.listdir("/proc")):
        try:
            with open(f"/proc/{pid}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[3]) == sid and fields[0] != "Z":
            found.append(pid)
    return found


def test_stop_ingest_processes_leaves_no_process(tmp_path, rng_np):
    """A program that ran process ingest and then called
    stop_ingest_processes has no child left (the forkserver and the
    resource tracker included), and nothing of its session outlives it.
    Run in a process of its own: the stop ends this process's forkserver."""
    import subprocess
    import sys

    files = _signal_files(tmp_path, rng_np, n_files=2, reads=2)
    script = (
        "import os, sys\n"
        "from nanodecoder_tpu_torch.config import SignalConfig\n"
        "from nanodecoder_tpu_torch.io import pipeline\n"
        "pipe = pipeline.AsyncChunkPipeline(sys.argv[1:], SignalConfig(chunk_len=256, "
        "chunk_overlap=32), 2, num_workers=2)\n"
        "assert list(pipe.batches())\n"
        "pipeline.stop_ingest_processes()\n"
        "def fields(pid):\n"
        "    try:\n"
        "        return open(f'/proc/{pid}/stat').read().rsplit(')', 1)[1].split()\n"
        "    except OSError:\n"
        "        return ['Z', '0']\n"
        "left = [p for p in filter(str.isdigit, os.listdir('/proc'))\n"
        "        if fields(p)[1] == str(os.getpid()) and fields(p)[0] != 'Z']\n"
        "print('children', left)\n")
    proc = subprocess.Popen([sys.executable, "-c", script, *files], start_new_session=True,
                            cwd=os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                            stdout=subprocess.PIPE, text=True)
    out, _ = proc.communicate(timeout=120)
    assert proc.returncode == 0
    assert "children []" in out
    assert _running_in_session(proc.pid) == []


def test_pipeline_rejects_unknown_ingest_mode():
    from nanodecoder_tpu_torch.config import SignalConfig

    with pytest.raises(ValueError, match="ingest mode"):
        tpipe.AsyncChunkPipeline([], SignalConfig(), 2, ingest="fork")


def test_stream_chunk_batches_reads_a_directory(tmp_path, rng_np):
    from nanodecoder_tpu_torch.config import SignalConfig

    files = _signal_files(tmp_path, rng_np, n_files=2, reads=2)
    pipe = tpipe.stream_chunk_batches(str(tmp_path), SignalConfig(chunk_len=256,
                                                                  chunk_overlap=32), 4,
                                      num_workers=2)
    n = sum(pb.n_real for pb in pipe.batches())
    assert [r.read.source_file for r in pipe.reads] == sorted(files * 2)
    assert n == sum(r.chunks.n_chunks for r in pipe.reads)


def test_read_chunks_and_packed_batch_fields_match_jax():
    for t, j in ((tpipe.ReadChunks, jpipe.ReadChunks), (tpipe.PackedBatch, jpipe.PackedBatch)):
        assert [f.name for f in dataclasses.fields(t)] == \
            [f.name for f in dataclasses.fields(j)]


def test_utils_match_jax(tmp_path):
    """StageTimer, ThroughputMeter and the inference record carry the JAX
    package's names and arithmetic."""
    import json

    from nanodecoder_tpu.utils.statistics import ThroughputMeter as JMeter
    from nanodecoder_tpu_torch.utils.profiling import StageTimer
    from nanodecoder_tpu_torch.utils.report import ReportManager
    from nanodecoder_tpu_torch.utils.statistics import Statistics, ThroughputMeter

    timer = StageTimer()
    for _ in range(3):
        with timer.stage("dispatch"):
            pass
    s = timer.summary()["dispatch"]
    assert s["count"] == 3 and s["mean_sec"] == pytest.approx(s["total_sec"] / 3)
    meter, ref = ThroughputMeter(), JMeter()
    for m in (meter, ref):
        m.update(4000, 350, 3)
        m.update(1000, 80, 1)
    assert (meter.n_samples, meter.n_bases, meter.n_chunks, meter.n_reads) == \
        (ref.n_samples, ref.n_bases, ref.n_chunks, ref.n_reads) == (5000, 430, 4, 2)
    assert set(meter.rates()) == set(ref.rates())
    stats = Statistics()
    stats.update(12.0, 10, 7)
    assert (stats.accuracy, stats.xent) == (0.7, 1.2)
    path = tmp_path / "m.jsonl"
    rm = ReportManager(metrics_path=str(path))
    rm.report_inference(meter.rates(), {"n_hosts": 1})
    rm.close()
    rec = json.loads(path.read_text())
    assert rec["kind"] == "inference" and rec["n_hosts"] == 1
    assert set(meter.rates()) <= set(rec)
