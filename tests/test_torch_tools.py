"""PyTorch port, the tools and the package surface: the TensorBoard sink of
the reports and the train CLI's --tensorboard, the device trace, the
kernels' build directory (its environment override, the read-only
fallback, the rebuild when the compiler flags change), the multi-process
helpers in one process, the package re-exports (every name the JAX
package's `__init__` files export), and profile_serving's model forms
(argument parsing and model build at a tiny config; profiling itself
needs the card).
"""

import ast
import dataclasses
import json
import os
import sys

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.prng import PRNGKey

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """As the port's other test modules: one torch thread while the suite's
    other workers hold the cores; restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _events(path) -> list[str]:
    return [f for f in os.listdir(path) if "tfevents" in f]


def test_report_manager_tensorboard(tmp_path):
    """The TensorBoard sink writes event files beside the JSONL metrics."""
    pytest.importorskip("torch.utils.tensorboard")
    from nanodecoder_tpu_torch.utils.report import ReportManager
    from nanodecoder_tpu_torch.utils.statistics import Statistics

    rm = ReportManager(report_every=1, metrics_path=str(tmp_path / "m.jsonl"),
                       tensorboard_dir=str(tmp_path / "tb"))
    st = Statistics()
    st.update(loss=10.0, n_tokens=20, n_correct=5)
    rm.report_training(1, st, lr=0.1)
    rm.report_validation(1, st)
    rm.close()
    assert _events(tmp_path / "tb"), "no event file written"
    assert (tmp_path / "m.jsonl").read_text().count('"kind": "train"') == 1
    from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

    acc = EventAccumulator(str(tmp_path / "tb"))
    acc.Reload()
    tags = set(acc.Tags()["scalars"])
    assert {"train/xent", "train/lr", "valid/accuracy"} <= tags
    assert acc.Scalars("train/lr")[0].value == pytest.approx(0.1)


def test_report_manager_without_tensorboard(tmp_path, monkeypatch, caplog):
    """Where torch.utils.tensorboard does not import: one warning, no sink,
    the JSONL metrics as before."""
    import logging

    from nanodecoder_tpu_torch.utils.report import ReportManager
    from nanodecoder_tpu_torch.utils.statistics import Statistics

    monkeypatch.setitem(sys.modules, "torch.utils.tensorboard", None)
    package_log = logging.getLogger("nanodecoder_tpu_torch")
    package_log.addHandler(caplog.handler)
    try:
        rm = ReportManager(report_every=1, metrics_path=str(tmp_path / "m.jsonl"),
                           tensorboard_dir=str(tmp_path / "tb"))
    finally:
        package_log.removeHandler(caplog.handler)
    st = Statistics()
    st.update(loss=1.0, n_tokens=2, n_correct=1)
    rm.report_training(1, st, lr=0.1)
    rm.close()
    assert any("tensorboard requested but unavailable" in r.getMessage()
               for r in caplog.records)
    assert not (tmp_path / "tb").exists()
    assert (tmp_path / "m.jsonl").read_text().count('"kind": "train"') == 1


def test_train_cli_tensorboard(tmp_path):
    """cli.train --tensorboard: event files with the train scalars."""
    pytest.importorskip("torch.utils.tensorboard")
    from nanodecoder_tpu_torch.cli import train
    from nanodecoder_tpu_torch.config import tiny_test_config

    cfg = tiny_test_config()
    (tmp_path / "config.json").write_text(cfg.to_json())
    assert train.main(["--cpu", "--ckpt-dir", str(tmp_path / "ck"), "--config",
                       str(tmp_path / "config.json"), "--steps", "2", "--report-every", "1",
                       "--tensorboard", str(tmp_path / "tb")]) == 0
    assert _events(tmp_path / "tb")


def test_device_trace(tmp_path):
    """device_trace writes one Chrome trace of the block (CPU activity
    here); None is a no-op."""
    from nanodecoder_tpu_torch.utils.profiling import device_trace

    x = torch.randn(64, 64)
    with device_trace(str(tmp_path / "trace")) as prof:
        y = x @ x
    traces = [f for f in os.listdir(tmp_path / "trace") if f.endswith(".pt.trace.json")]
    assert len(traces) == 1 and prof is not None
    trace = json.load(open(tmp_path / "trace" / traces[0]))
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
    with device_trace(None) as off:
        y = y + 1
    assert off is None


def test_build_dir_override_and_read_only_fallback(tmp_path, monkeypatch):
    from nanodecoder_tpu_torch import build_cache
    from nanodecoder_tpu_torch.ops import _build

    monkeypatch.setenv(build_cache.BUILD_DIR_ENV, str(tmp_path / "kernels"))
    assert build_cache.build_dir() == str(tmp_path / "kernels")
    assert (tmp_path / "kernels").is_dir()
    assert _build.library() == str(tmp_path / "kernels" / _build.LIBRARY_NAME)
    (tmp_path / "file").write_text("")
    monkeypatch.setenv(build_cache.BUILD_DIR_ENV, str(tmp_path / "file" / "sub"))
    fallback = build_cache.build_dir()  # cannot be made: under a file
    assert fallback.startswith(os.path.realpath(__import__("tempfile").gettempdir())) \
        or fallback.startswith(__import__("tempfile").gettempdir())
    assert os.path.isdir(fallback) and os.access(fallback, os.W_OK)
    monkeypatch.delenv(build_cache.BUILD_DIR_ENV)
    assert build_cache.build_dir() == os.path.join(REPO, "nanodecoder_tpu_torch", "_build")


def test_build_stale_on_sources_and_flags(tmp_path):
    """A library is stale when missing, older than a source, or built by
    another command (its stamp); `install` moves it into place whole, the
    stamp after it."""
    from nanodecoder_tpu_torch import build_cache

    src = tmp_path / "a.cu"
    src.write_text("x")
    lib = str(tmp_path / "lib.so")
    cmd = ["nvcc", "-O3"]
    assert build_cache.stale(lib, [str(src)], cmd)
    tmp = lib + ".1.tmp"
    open(tmp, "w").write("so")
    build_cache.install(tmp, lib, cmd)
    assert not os.path.exists(tmp)
    assert sorted(os.listdir(tmp_path)) == ["a.cu", "lib.so", "lib.so.stamp"]
    assert not build_cache.stale(lib, [str(src)], cmd)
    assert build_cache.stale(lib, [str(src)], ["nvcc", "-O2"])  # flags changed
    os.utime(src, (os.path.getmtime(lib) + 10,) * 2)
    assert build_cache.stale(lib, [str(src)], cmd)  # a source is newer


def test_multihost_helpers_in_one_process(tmp_path):
    """One process: no group, rank 0 of 1, the barrier a no-op; the shard
    merge concatenates in rank order and deletes the shards and their done
    logs."""
    import torch.distributed as dist

    from nanodecoder_tpu_torch.parallel import multihost

    assert multihost.initialize_multihost() == (0, 1)
    assert not (dist.is_available() and dist.is_initialized())
    multihost.barrier()
    out = str(tmp_path / "out.fastq")
    for rank in (1, 0):
        with open(multihost.host_shard_path(out, rank), "w") as f:
            f.write(f"@r{rank}\nACGT\n+\nIIII\n")
        open(multihost.host_shard_path(out, rank) + ".done", "w").write(f"r{rank}\n")
    multihost.merge_host_shards(out, process_count=2, process_index=1)  # not rank 0
    assert not os.path.exists(out)
    multihost.merge_host_shards(out, process_count=2)
    assert open(out).read() == "@r0\nACGT\n+\nIIII\n@r1\nACGT\n+\nIIII\n"
    assert os.listdir(tmp_path) == ["out.fastq"]
    with pytest.raises(ValueError, match="rank 5 outside"):
        multihost.initialize_multihost("localhost:1", 2, 5, backend="gloo")


def _jax_exports(path: str) -> set[str]:
    """The public names a JAX package `__init__` file exports: its imports
    from the package and, for a module with code, its public functions."""
    tree = ast.parse(open(path).read())
    names = set()
    for node in tree.body:
        if isinstance(node, ast.ImportFrom) and (node.module or "").startswith(
                "nanodecoder_tpu"):
            names |= {a.asname or a.name for a in node.names}
        elif isinstance(node, ast.FunctionDef) and not node.name.startswith("_"):
            names.add(node.name)
        elif isinstance(node, ast.Assign):
            names |= {t.id for t in node.targets if isinstance(t, ast.Name)
                      and t.id == "__version__"}
    return names


@pytest.mark.parametrize("package", ["", "decode", "models", "train", "io", "utils", "ops",
                                     "parallel", "native"])
def test_package_reexports(package):
    """Every name the JAX package's `__init__` exports imports from the
    port's counterpart (e.g. `from nanodecoder_tpu_torch.decode import
    beam_decode`)."""
    import importlib

    rel = os.path.join(package, "__init__.py") if package else "__init__.py"
    names = _jax_exports(os.path.join(REPO, "nanodecoder_tpu", rel))
    assert names, rel
    port = importlib.import_module("nanodecoder_tpu_torch" + (f".{package}" if package else ""))
    missing = sorted(n for n in names if not hasattr(port, n))
    assert not missing, missing


def test_decode_attention_reference_matches_jax(rng_np):
    """The one re-exported name the port did not have: K4a's plain version
    without the position, against the JAX package's reference (f32, MHA
    and MQA caches)."""
    import jax.numpy as jnp

    from nanodecoder_tpu.ops.attention import decode_attention_reference as jref
    from nanodecoder_tpu_torch.ops import decode_attention_reference

    b, t, h, dh = 3, 10, 4, 8
    q = rng_np.normal(size=(b, h * dh)).astype(np.float32)
    lens = np.array([10, 4, 1], np.int32)
    for n_kv in (h, 1):
        k = rng_np.normal(size=(b, t, n_kv * dh)).astype(np.float32)
        v = rng_np.normal(size=(b, t, n_kv * dh)).astype(np.float32)
        got = decode_attention_reference(torch.from_numpy(q), torch.from_numpy(k),
                                         torch.from_numpy(v), torch.from_numpy(lens), h)
        want = jref(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jnp.asarray(lens), h)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-6)


def _tiny_mqa_ckpt(tmp_path):
    from nanodecoder_tpu_torch.config import tiny_test_config
    from nanodecoder_tpu_torch.models.model import init_model
    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, dec_kv_heads=1))
    np.savez(tmp_path / "params.npz", **params_to_numpy(
        init_model(PRNGKey(0), cfg.model)))
    (tmp_path / "config.json").write_text(cfg.to_json())
    return str(tmp_path / "params.npz"), cfg


@pytest.mark.parametrize("form", [None, "lean-mha", "unfolded", "rnn"])
def test_profile_serving_forms(tmp_path, form):
    """profile_serving's --ckpt and --form build each form as chip_smoke.py
    phases 7, 8 and 14 do; the MHA forms compute the MQA model's function
    (tokens equal on a small batch), the RNN form has the recurrent
    family's shapes.  Without a card, main() exits 2."""
    from nanodecoder_tpu_torch import profile_serving
    from nanodecoder_tpu_torch.io.signal import convert_h2d

    ckpt, cfg = _tiny_mqa_ckpt(tmp_path)
    argv = ["--ckpt", ckpt, "--dtype", "float32", "--h2d", "float32", "--batch", "4",
            "--trace", str(tmp_path / "trace")] + (["--form", form] if form else [])
    args = profile_serving.build_argparser().parse_args(argv)
    assert args.trace == str(tmp_path / "trace")
    tr = profile_serving.build(args, device="cpu")
    m = tr.config.model
    assert m.use_pallas and tr.config.decode.use_pallas
    assert (m.dec_kv_heads, m.lean_step) == {None: (1, cfg.model.lean_step),
                                             "lean-mha": (0, True), "unfolded": (0, False),
                                             "rnn": (1, cfg.model.lean_step)}[form]
    assert (m.encoder_type, m.decoder_type) == (("lstm", "rnn") if form == "rnn" else
                                                ("transformer", "transformer"))
    rng = np.random.default_rng(0)
    chunks = rng.normal(size=(4, cfg.signal.chunk_len)).astype(np.float32)
    wire = convert_h2d(chunks, tr._h2d, cfg.signal.clip_sigma)
    lengths = np.full(4, cfg.signal.chunk_len, np.int32)
    tokens = tr.decode_program(wire, lengths)[0]
    if form in ("lean-mha", "unfolded"):
        args.form = None
        same = profile_serving.build(args, device="cpu").decode_program(wire, lengths)[0]
        assert torch.equal(tokens, same)
    if torch.cuda.is_available():
        return
    assert profile_serving.main(argv) == 2
