"""PyTorch port, training data: examples, the batch streams, shards, the
preprocess CLI, and the train CLI end to end on the CPU.

The data functions are numpy copies of the JAX package's: for the same
seed they return the same bytes, which each test checks against the JAX
package.  The train CLI runs as a subprocess with --cpu, resumes, and
feeds the port's evaluate CLI.
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.config import tiny_test_config
from nanodecoder_tpu_torch.prng import PRNGKey
from nanodecoder_tpu_torch.train import data as td
from nanodecoder_tpu_torch.train import shards as ts

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _cfgs(kmer_k=1, **train):
    """(JAX config, port config): the tiny config, k-mer targets of
    kmer_k, these train overrides."""
    from nanodecoder_tpu.config import tiny_test_config as jax_tiny
    from nanodecoder_tpu_torch.vocab import vocab_size_for

    def tweak(cfg):
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, kmer_k=kmer_k,
                                           vocab_size=vocab_size_for(kmer_k)),
            train=dataclasses.replace(cfg.train, **train))

    return tweak(jax_tiny()), tweak(tiny_test_config())


def _assert_batches_equal(got, want):
    assert got.keys() == want.keys()
    for k in want:
        assert got[k].dtype == want[k].dtype and got[k].shape == want[k].shape, k
        assert got[k].tobytes() == want[k].tobytes(), k


def test_pack_targets_matches_jax():
    from nanodecoder_tpu.train.data import pack_targets as jax_pack

    for n in (0, 5, 47):
        ids = np.arange(4, 4 + n, dtype=np.int32) % 8
        for got, want in zip(td.pack_targets(ids, 48), jax_pack(ids, 48)):
            assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    with pytest.raises(ValueError, match="no room for EOS"):
        td.pack_targets(np.zeros(48, np.int32), 48)


@pytest.mark.parametrize("kmer_k", [1, 3])
def test_make_example_byte_equal_to_jax(kmer_k):
    """Forty examples from one generator (short windows included), for
    single-base and 3-mer targets."""
    from nanodecoder_tpu.train.data import SimSpec, make_example

    jcfg, cfg = _cfgs(kmer_k)
    spec = SimSpec()
    levels = spec.level_table()
    ours, ref = np.random.default_rng(11), np.random.default_rng(11)
    lengths = set()
    for _ in range(40):
        got = td.make_example(ours, cfg, td.SimSpec(), levels)
        _assert_batches_equal(got, make_example(ref, jcfg, spec, levels))
        lengths.add(int(got["sig_lengths"]))
    assert len(lengths) > 1  # some short windows


@pytest.mark.parametrize("accum_axis", [True, False])
def test_synthetic_batches_byte_equal_to_jax(accum_axis):
    from nanodecoder_tpu.train.data import synthetic_batches

    jcfg, cfg = _cfgs(accum_steps=2)
    ours = td.synthetic_batches(cfg, seed=3, accum_axis=accum_axis)
    ref = synthetic_batches(jcfg, seed=3, accum_axis=accum_axis)
    for _ in range(3):
        got = next(ours)
        _assert_batches_equal(got, next(ref))
    assert got["signal"].shape == ((2, 4, 256) if accum_axis else (4, 256))


def test_synthetic_valid_batches_byte_equal_to_jax():
    from nanodecoder_tpu.train.data import synthetic_valid_batches

    jcfg, cfg = _cfgs()
    got, want = td.synthetic_valid_batches(cfg, 3), synthetic_valid_batches(jcfg, 3)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)


def test_prefetch_batches_keeps_the_stream_and_ends():
    """prefetch_batches yields the JAX package's prefetched stream in
    order, ends with a finite source, and relays a source's error."""
    from nanodecoder_tpu.train.data import prefetch_batches, synthetic_batches

    jcfg, cfg = _cfgs()
    got = td.prefetch_batches(td.synthetic_batches(cfg, seed=0), depth=2)
    want = prefetch_batches(synthetic_batches(jcfg, seed=0), depth=2)
    for _ in range(4):
        _assert_batches_equal(next(got), next(want))
    got.close()
    finite = [{"x": np.full(2, i)} for i in range(5)]
    assert [int(b["x"][0]) for b in td.prefetch_batches(iter(finite))] == list(range(5))

    def broken():
        yield {"x": np.zeros(1)}
        raise OSError("disk gone")

    it = td.prefetch_batches(broken())
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)


def test_interleave_batches_follow_each_seed_stream():
    """Every batch of interleave_batches is the next batch of the JAX
    package's synthetic_batches stream of one of the seeds, in order per
    seed; a worker's error reaches the consumer."""
    from nanodecoder_tpu.train.data import synthetic_batches

    jcfg, cfg = _cfgs()
    seeds = (5, 6)
    streams = {s: synthetic_batches(jcfg, seed=s) for s in seeds}
    pending = {s: [] for s in seeds}
    it = td.interleave_batches(cfg, seeds)
    for _ in range(6):
        got = next(it)
        for s in seeds:
            while len(pending[s]) < 4:
                pending[s].append(next(streams[s]))
        hits = [s for s in seeds if pending[s][0]["signal"].tobytes() ==
                got["signal"].tobytes()]
        assert len(hits) == 1
        _assert_batches_equal(got, pending[hits[0]].pop(0))
    it.close()
    bad = dataclasses.replace(cfg, signal=dataclasses.replace(cfg.signal,
                                                              normalization="bogus"))
    with pytest.raises(ValueError, match="unknown normalization"):
        next(td.interleave_batches(bad, (1,)))


def test_shards_are_read_alike_by_both_packages(tmp_path):
    """Shards written by either package are byte-equal, and each
    package's shard_batches yields the same batches from them."""
    from nanodecoder_tpu.train import shards as js

    jcfg, cfg = _cfgs(accum_steps=2, batch_size=3)
    exs = [td.make_example(np.random.default_rng(i), cfg, td.SimSpec(),
                           td.SimSpec().level_table()) for i in range(14)]
    (tmp_path / "a").mkdir()
    (tmp_path / "b").mkdir()
    ts.write_shard(str(tmp_path / "a" / "shard_00000.npz"), exs[:8])
    ts.write_shard(str(tmp_path / "a" / "shard_00001.npz"), exs[8:])
    js.write_shard(str(tmp_path / "b" / "shard_00000.npz"), exs[:8])
    js.write_shard(str(tmp_path / "b" / "shard_00001.npz"), exs[8:])
    for name in ("shard_00000.npz", "shard_00001.npz"):
        assert (tmp_path / "a" / name).read_bytes() == (tmp_path / "b" / name).read_bytes()
    assert ts.list_shards(str(tmp_path / "a")) == [
        str(tmp_path / "a" / n) for n in ("shard_00000.npz", "shard_00001.npz")]
    got = list(ts.shard_batches(str(tmp_path / "a"), cfg, shuffle_seed=2, loop=False))
    want = list(js.shard_batches(str(tmp_path / "b"), jcfg, shuffle_seed=2, loop=False))
    assert len(got) == len(want) == 2  # one batch of 6 from each shard
    for g, w in zip(got, want):
        _assert_batches_equal(g, w)
    assert got[0]["signal"].shape == (2, 3, 256)
    with pytest.raises(FileNotFoundError):
        next(ts.shard_batches(str(tmp_path), cfg))


def test_preprocess_synthetic_byte_equal_to_jax(tmp_path):
    """cli.preprocess --synthetic writes the JAX package's shard files and
    config.json byte for byte (two shards of --shard-size)."""
    from nanodecoder_tpu.cli import preprocess as jax_pre
    from nanodecoder_tpu_torch.cli import preprocess

    jcfg, _ = _cfgs()
    cfg_path = tmp_path / "config.json"
    cfg_path.write_text(jcfg.to_json())
    args = ["--config", str(cfg_path), "--synthetic", "30", "--shard-size", "20",
            "--seed", "4"]
    assert preprocess.main(["--out", str(tmp_path / "ours"), *args]) == 0
    assert jax_pre.main(["--out", str(tmp_path / "ref"), *args]) == 0
    names = sorted(os.listdir(tmp_path / "ref"))
    assert names == sorted(os.listdir(tmp_path / "ours")) == [
        "config.json", "shard_00000.npz", "shard_00001.npz"]
    for n in names:
        assert (tmp_path / "ours" / n).read_bytes() == (tmp_path / "ref" / n).read_bytes(), n
    assert preprocess.main(["--out", str(tmp_path / "none")]) == 2


def test_preprocess_labels_byte_equal_to_jax(tmp_path):
    """cli.preprocess --labels on a fast5 file with a label TSV writes the
    JAX package's shards byte for byte."""
    h5py = pytest.importorskip("h5py")
    from nanodecoder_tpu.cli import preprocess as jax_pre
    from nanodecoder_tpu_torch.cli import preprocess

    jcfg, _ = _cfgs()
    rng = np.random.default_rng(8)
    fast5 = tmp_path / "reads.fast5"
    rows = []
    with h5py.File(fast5, "w") as f:
        for i in range(3):
            seq, sig = td.simulate_read(rng, 150 + 40 * i, td.SimSpec())
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}".encode()
            raw.create_dataset("Signal", data=np.rint(sig * 4).astype(np.int16))
            rows.append(f"{fast5}\tr{i}\t{seq}")
    rows.append("malformed line")
    (tmp_path / "labels.tsv").write_text("\n".join(rows) + "\n")
    (tmp_path / "config.json").write_text(jcfg.to_json())
    args = ["--config", str(tmp_path / "config.json"), "--labels",
            str(tmp_path / "labels.tsv")]
    assert preprocess.main(["--out", str(tmp_path / "ours"), *args]) == 0
    assert jax_pre.main(["--out", str(tmp_path / "ref"), *args]) == 0
    got = (tmp_path / "ours" / "shard_00000.npz").read_bytes()
    assert got == (tmp_path / "ref" / "shard_00000.npz").read_bytes()
    with np.load(tmp_path / "ours" / "shard_00000.npz") as d:
        assert d["signal"].shape[0] >= 3


def _run_train(args, timeout=240):
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"
    res = subprocess.run([sys.executable, "-m", "nanodecoder_tpu_torch.cli.train", *args],
                         cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)
    assert res.returncode == 0, res.stderr[-3000:]
    return res


def test_train_cli_trains_resumes_and_serves(tmp_path, capsys):
    """cli.train --cpu on the simulator (validating and saving every 2
    steps) for 3 steps, then --resume on preprocessed shards to step 5;
    the checkpoint directory holds steps 2-5, the metrics file the train
    and valid records, and the evaluate CLI serves the latest step."""
    from nanodecoder_tpu_torch.cli import evaluate, preprocess
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager, load_config

    _, cfg = _cfgs(valid_every=2, save_every=2)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dropout=0.0))
    (tmp_path / "config.json").write_text(cfg.to_json())
    assert preprocess.main(["--out", str(tmp_path / "shards"), "--config",
                            str(tmp_path / "config.json"), "--synthetic", "12"]) == 0
    common = ["--ckpt-dir", str(tmp_path / "ck"), "--config", str(tmp_path / "config.json"),
              "--cpu", "--metrics", str(tmp_path / "m.jsonl"), "--report-every", "1"]
    _run_train([*common, "--steps", "3"])
    mgr = CheckpointManager(str(tmp_path / "ck"), load_config(str(tmp_path / "ck")))
    assert mgr.all_steps() == [2, 3]
    _run_train([*common, "--steps", "5", "--resume", "--data", str(tmp_path / "shards")])
    assert mgr.all_steps() == [2, 3, 4, 5]
    kinds = [json.loads(line)["kind"] for line in open(tmp_path / "m.jsonl")]
    assert kinds.count("train") == 5 and kinds.count("valid") == 1
    assert evaluate.main(["--cpu", "--ckpt", str(tmp_path / "ck"), "--simulate", "1",
                          "--read-bases", "200", "--dtype", "float32", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_reads"] == 1 and 0.0 <= summary["mean_identity"] <= 1.0


def test_train_cli_needs_a_card_without_cpu(tmp_path, monkeypatch):
    from nanodecoder_tpu_torch.cli import train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--ckpt-dir", str(tmp_path / "ck"), "--steps", "1"])
    assert not (tmp_path / "ck").exists()


def test_cli_common_reads_checkpoint_directories(tmp_path):
    """load_params_and_config takes a port checkpoint directory (its
    latest step) and refuses a directory without one; a directory whose
    step is neither the port's nor the JAX package's orbax step holds no
    checkpoint, and the JAX package's orbax directory is served."""
    from nanodecoder_tpu_torch.cli.common import load_params_and_config
    from nanodecoder_tpu_torch.models.model import init_model, named_leaves
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager
    from nanodecoder_tpu_torch.train.trainer import Trainer

    cfg = tiny_test_config()
    trainer = Trainer(cfg, init_model(PRNGKey(0), cfg.model))
    mgr = CheckpointManager(str(tmp_path / "ck"), cfg)
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_params_and_config(str(tmp_path / "ck"), "cpu")
    mgr.save(7, trainer.state)
    params, config = load_params_and_config(str(tmp_path / "ck"), "cpu")
    assert config == cfg
    want = named_leaves(trainer.params)
    for key, t in named_leaves(params).items():
        assert torch.equal(t, want[key].detach()), key
    with pytest.raises(ValueError, match="neither an .npz"):
        load_params_and_config(str(tmp_path), "cpu")
    other = tmp_path / "other"  # config.json and a step directory of no known format
    other.mkdir()
    (other / "config.json").write_text(cfg.to_json())
    (other / "1000").mkdir()
    with pytest.raises(FileNotFoundError, match="no checkpoints"):
        load_params_and_config(str(other), "cpu")
    golden = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                          "jax_orbax_tiny")
    params, config = load_params_and_config(golden, "cpu")
    with np.load(golden + "_expected.npz") as want:
        for key, t in named_leaves(params).items():
            w = want[f"params/{key}"]
            assert np.array_equal(t.numpy(), w.transpose(2, 1, 0) if w.ndim == 3 else w), key


def test_basecall_cli_serves_a_checkpoint_directory(tmp_path):
    """cli.basecall --ckpt <checkpoint directory of the port's trainer>
    basecalls a fast5 file, one FASTQ record a read."""
    h5py = pytest.importorskip("h5py")
    from nanodecoder_tpu_torch.models.model import init_model
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager
    from nanodecoder_tpu_torch.train.trainer import Trainer

    cfg = tiny_test_config()
    trainer = Trainer(cfg, init_model(PRNGKey(0), cfg.model))
    CheckpointManager(str(tmp_path / "ck"), cfg).save(1, trainer.state)
    rng = np.random.default_rng(3)
    with h5py.File(tmp_path / "reads.fast5", "w") as f:
        for i in range(2):
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}".encode()
            sig = td.simulate_read(rng, 120, td.SimSpec())[1]
            raw.create_dataset("Signal", data=np.rint(sig * 4).astype(np.int16))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["OMP_NUM_THREADS"] = "1"  # the tiny model; the suite's workers hold the cores
    res = subprocess.run([sys.executable, "-m", "nanodecoder_tpu_torch.cli.basecall",
                          "--cpu", "--ckpt", str(tmp_path / "ck"), "--input",
                          str(tmp_path / "reads.fast5"), "--output", str(tmp_path / "o.fq"),
                          "--workers", "1"], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=240)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = (tmp_path / "o.fq").read_text().splitlines()
    assert len(lines) == 8 and {lines[0], lines[4]} == {"@r0", "@r1"}
