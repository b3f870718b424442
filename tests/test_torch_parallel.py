"""PyTorch port, data parallelism over torch.distributed and the
multi-process helpers, held against the JAX package and against the port
on one process.

The port's counterparts of tests/test_parallel.py, of
tests/test_engine.py::TestStreamingEngineMesh and of
tests/test_multihost.py.  Every case starts from the JAX package's params
and inputs: this process makes them (JAX inits, JAX's synthetic training
batches, seeded numpy signals and fast5 reads) and saves them; two ranks
run as subprocesses in a gloo group (rendezvous through a file under the
test's tmp_path, never a fixed TCP port) on the CPU, each computes every
case with a MeshPlan over the group from those files, and rank 0 saves
the results.  Each test holds them to the JAX package's single-device
result on the same inputs and to the same port function run in this
process without a plan.

Tolerances, as the JAX tests on the CPU: tokens and lengths equal; train
params atol 1e-5 / rtol 1e-4 after one SGD step (SGD as the JAX test:
Adam's g / sqrt(v) turns summation-order noise of a near-zero gradient
into a step of about lr).  The train cases run with guided attention off
and at 0.3: the second holds the local/global batch weighting of the
guided-attention mean, without which the summed gradient of that term is
world times too large.  A third train case runs at dropout 0.1: each
rank draws its rows of the global micro-batch's masks, so the step is
one process's (and the JAX package's on the same key chain).  Sample
mode is held to one process here (each rank draws its rows' noise at
their place in the batch); test_torch_decode_modes.py holds it to JAX.
The engine's FASTQ is byte-equal to one process's and
within one quality character of the JAX engine's
(`test_torch_engine.assert_fastq_close`).
"""

import dataclasses
import functools
import glob
import io
import json
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.config import Config, tiny_test_config
from nanodecoder_tpu_torch.parallel.mesh import make_mesh_plan
from nanodecoder_tpu_torch.parallel.multihost import host_shard_path, partition_files_for_host

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TESTS = os.path.dirname(os.path.abspath(__file__))
WORLD = 2
RANK_TIMEOUT_S = 240
# A rank that waits in a collective for a rank that left would sit there
# for gloo's 30 minutes: the stop test's ranks must be done long before.
STOP_TIMEOUT_S = 90


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's many small ops run fastest on one thread, and far
    faster than on eight when the suite's other workers hold the cores;
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


# --- the JAX package's params and inputs, made here and saved for the ranks


def _flat(params) -> dict:
    """JAX params -> the flat save_params_npz arrays."""
    import jax

    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _jax_tiny():
    from nanodecoder_tpu.config import tiny_test_config as jax_tiny

    return jax_tiny()


def _jax_serving_cfg():
    sys.path.insert(0, REPO)
    import __graft_entry__ as graft

    return graft._tiny_flagship_config()


@functools.lru_cache(maxsize=None)
def _jax_params(name: str):
    """The JAX package's init (key 0) of the tiny config ("tiny") or of the
    tiny flagship serving config ("serving")."""
    import jax
    from nanodecoder_tpu.models.model import init_model

    cfg = _jax_tiny() if name == "tiny" else _jax_serving_cfg()
    return init_model(jax.random.PRNGKey(0), cfg.model)


def _train_cfg(ga: float, base=None, dropout: float = 0.0):
    """The DP step's config over `base` (the port's tiny config, or the JAX
    package's): batch 8, SGD at lr 0.1, dropout 0 unless given."""
    cfg = base or tiny_test_config()
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, dropout=dropout),
        train=dataclasses.replace(cfg.train, batch_size=8, accum_steps=1, optimizer="sgd",
                                  lr_schedule="constant", learning_rate=0.1,
                                  guided_attention_weight=ga))


def _save_inputs(path) -> None:
    """Params, batches, configs and reads for every case, into `path`."""
    import test_torch_engine as eng
    from nanodecoder_tpu.train.data import synthetic_batches, synthetic_valid_batches

    for name in ("tiny", "serving"):
        np.savez(path / f"{name}.npz", **_flat(_jax_params(name)))
    (path / "serving.json").write_text(_jax_serving_cfg().to_json())
    jcfg = _train_cfg(0.0, _jax_tiny())
    np.savez(path / "train_batch.npz", **next(synthetic_batches(jcfg, seed=3)))
    np.savez(path / "valid.npz", **{f"{i}/{k}": v for i, b in enumerate(
        synthetic_valid_batches(jcfg, n_batches=2)) for k, v in b.items()})
    # The engine: test_torch_engine.py's config, params and reads.
    np.savez(path / "engine.npz", **eng._flat())
    for mode in ("greedy", "beam"):
        (path / f"engine_{mode}.json").write_text(eng._jcfg(mode).to_json())
    (path / "fast5").mkdir()
    eng.write_fast5_files(path / "fast5")


def _params(work: str, name: str, cfg):
    """Port params from the JAX params saved as `name`.npz."""
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    with np.load(os.path.join(work, f"{name}.npz")) as flat:
        return params_from_numpy(dict(flat), cfg.model, device="cpu")


@torch.inference_mode()
def _serving_params(work: str, cfg):
    from nanodecoder_tpu_torch.models.model import prepare_serving_params

    return prepare_serving_params(_params(work, "tiny", cfg), cfg.model)


def _signal(cfg, b: int = 16, seed: int = 7):
    rng = np.random.default_rng(seed)
    signal = rng.normal(size=(b, cfg.signal.chunk_len)).astype(np.float32)
    return signal, np.full((b,), cfg.signal.chunk_len, np.int32)


def _train_batch(work: str) -> dict:
    with np.load(os.path.join(work, "train_batch.npz")) as data:
        return dict(data)


def _valid_batches(work: str) -> list[dict]:
    with np.load(os.path.join(work, "valid.npz")) as data:
        n = 1 + max(int(k.split("/")[0]) for k in data.files)
        return [{k.split("/")[1]: data[k] for k in data.files if k.startswith(f"{i}/")}
                for i in range(n)]


def _engine_cfg(work: str, mode: str) -> Config:
    return Config.from_json(open(os.path.join(work, f"engine_{mode}.json")).read())


def _engine_files(work: str) -> list[str]:
    return sorted(glob.glob(os.path.join(work, "fast5", "*.fast5")))


def _run(plan, program, *args):
    fn = program if plan is None else plan.shard_decode_fn(program)
    return [t.numpy() for t in fn(*args)]


# --- the cases: each runs on one process (plan None) or sharded -----------


def case_greedy(plan, work):
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.models.model import encode

    cfg = tiny_test_config()
    params = _serving_params(work, cfg)

    @torch.inference_mode()
    def program(signal, lengths, rows=slice(None)):
        memory, mem_len = encode(params, cfg.model, torch.from_numpy(signal[rows]),
                                 torch.from_numpy(lengths[rows]))
        r = greedy_decode(params, cfg.model, memory, mem_len)
        return r.tokens, r.lengths

    tokens, lengths = _run(plan, program, *_signal(cfg))
    return {"greedy/tokens": tokens, "greedy/lengths": lengths}


def _beam_decode_cfg(cfg):
    return dataclasses.replace(cfg.decode, mode="beam", beam_size=3, length_penalty="avg")


def case_beam(plan, work):
    from nanodecoder_tpu_torch.decode.beam import beam_decode
    from nanodecoder_tpu_torch.models.model import encode

    cfg = tiny_test_config()
    dcfg = _beam_decode_cfg(cfg)
    params = _serving_params(work, cfg)

    @torch.inference_mode()
    def program(signal, lengths, rows=slice(None)):
        memory, mem_len = encode(params, cfg.model, torch.from_numpy(signal[rows]),
                                 torch.from_numpy(lengths[rows]))
        r = beam_decode(params, cfg.model, dcfg, memory, mem_len)
        return r.tokens[:, 0], r.lengths[:, 0], r.token_log_probs[:, 0]

    tokens, lengths, lps = _run(plan, program, *_signal(cfg))
    return {"beam/tokens": tokens, "beam/lengths": lengths, "beam/lps": lps}


def _serving_wire(cfg):
    from nanodecoder_tpu_torch.io.signal import convert_h2d

    raw, lengths = _signal(cfg)
    clip = cfg.signal.clip_sigma
    h2d = cfg.decode.resolve_h2d(cfg.model.compute_dtype)
    return convert_h2d(np.clip(raw, -clip, clip), h2d, clip), lengths


def case_serving(plan, work):
    """The served program (`Translator.decode_program`: wire unpack, lean
    encode, staged greedy / beam, compact outputs) at the tiny flagship
    config, greedy, beam 3 and sample."""
    from nanodecoder_tpu_torch.decode.translator import Translator

    out = {}
    cfg = Config.from_json(open(os.path.join(work, "serving.json")).read())
    params = _params(work, "serving", cfg)
    wire, lengths = _serving_wire(cfg)
    for mode in ("greedy", "beam", "sample"):
        mcfg = dataclasses.replace(cfg, decode=dataclasses.replace(
            cfg.decode, mode=mode, beam_size=3, temperature=1.0, sampling_topk=5,
            sampling_seed=5))
        tr = Translator(params, mcfg, device="cpu")
        for name, arr in zip(("tokens", "lengths", "lps", "scores", "pos"),
                             _run(plan, tr.decode_program, wire, lengths)):
            out[f"serving/{mode}_{name}"] = arr
    return out


def case_train(plan, work):
    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy
    from nanodecoder_tpu_torch.train.trainer import Trainer
    from nanodecoder_tpu_torch.utils.statistics import Statistics

    out = {}
    for ga, dropout in ((0.0, 0.0), (0.3, 0.0), (0.0, 0.1)):
        cfg = _train_cfg(ga, dropout=dropout)
        trainer = Trainer(cfg, _params(work, "tiny", cfg), mesh_plan=plan)
        metrics = trainer.train_step(_train_batch(work))
        tag = f"drop{dropout}" if dropout else f"ga{ga}"
        out.update({f"{tag}_{k}": v.numpy() for k, v in metrics.items()})
        out.update({f"{tag}/{k}": v for k, v in params_to_numpy(trainer.params).items()})
        if ga == 0.0 and not dropout:
            vstats = trainer.validate(_valid_batches(work), 1)
            assert isinstance(vstats, Statistics)
            out["valid"] = np.array([vstats.loss, vstats.n_tokens, vstats.n_correct])
    return out


def case_engine(plan, work):
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller

    out = {}
    for mode in ("greedy", "beam"):
        cfg = _engine_cfg(work, mode)
        text = io.StringIO()
        StreamingBasecaller(_params(work, "engine", cfg), cfg, device="cpu",
                            mesh_plan=plan).run(_engine_files(work), text, num_workers=2)
        out[f"engine_{mode}"] = np.array(text.getvalue())
    return out


CASES = (case_greedy, case_beam, case_serving, case_train, case_engine)


def _rank_main(rank: int, work: str) -> None:
    """One rank: join the gloo group, run every case with a plan, and (rank
    0) save the results."""
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes
    from nanodecoder_tpu_torch.parallel.multihost import initialize_multihost, shutdown_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{work}/rendezvous", WORLD, rank, backend="gloo")
    try:
        plan = make_mesh_plan()
        rows = plan.row_slice(16)
        try:
            plan.row_slice(3)
            odd = "no error"
        except ValueError as e:
            odd = str(e)
        results = {"n_devices": np.array(plan.n_devices),
                   f"rows_{rank}": np.array([rows.start, rows.stop]), f"odd_{rank}": odd}
        for case in CASES:
            results.update(case(plan, work))
        np.savez(os.path.join(work, f"dp{rank}.npz"), **results)
    finally:
        shutdown_multihost()
        stop_ingest_processes()


class _BrokenOutput(io.StringIO):
    """A FASTQ sink whose every write fails, as on a full disk."""

    def write(self, text):
        raise OSError("no space left on device")


def _stop_cfg(work: str) -> Config:
    """The engine's greedy config at 2-chunk batches: many batches, so that
    rank 0's first write fails while most of the stream is still ahead."""
    cfg = _engine_cfg(work, "greedy")
    return dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode,
                                                               batch_chunks_engine=2))


def _stop_rank_main(rank: int, work: str) -> None:
    """One rank of the engine whose writer (rank 0's) fails: every rank
    must leave the run after the same gather and raise; each saves what
    it raised and the batches it ran."""
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes
    from nanodecoder_tpu_torch.parallel.multihost import initialize_multihost, shutdown_multihost

    torch.set_num_threads(1)
    initialize_multihost(f"file://{work}/rendezvous_stop", WORLD, rank, backend="gloo")
    try:
        cfg = _stop_cfg(work)
        engine = StreamingBasecaller(_params(work, "engine", cfg), cfg, device="cpu",
                                     mesh_plan=make_mesh_plan())
        try:
            engine.run(_engine_files(work), _BrokenOutput(), num_workers=1)
            raised = "nothing"
        except Exception as e:  # noqa: BLE001 - the test reads what was raised
            raised = f"{type(e).__name__}: {e}"
        with open(os.path.join(work, f"stop{rank}.json"), "w") as f:
            json.dump({"raised": raised, "batches": engine.batches}, f)
    finally:
        shutdown_multihost()
        stop_ingest_processes()


def _spawn_ranks(work: str, code: str, env=None,
                 timeout: float = RANK_TIMEOUT_S) -> list[tuple[int, str]]:
    procs = [subprocess.Popen([sys.executable, "-c", code, str(r), work], cwd=REPO,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True) for r in range(WORLD)]
    outs = []
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            outs.append((p.wait(timeout=max(deadline - time.monotonic(), 0.1)),
                         p.stdout.read()))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            p.stdout.close()
    return outs


def _rank_code(main: str) -> str:
    return ("import sys; sys.path.insert(0, %r); import test_torch_parallel as t; "
            "t.%s(int(sys.argv[1]), sys.argv[2])" % (TESTS, main))


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    path = tmp_path_factory.mktemp("dp")
    _save_inputs(path)
    return str(path)


@pytest.fixture(scope="module")
def dp(work):
    outs = _spawn_ranks(work, _rank_code("_rank_main"))
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log}"
    results = {}
    for rank in reversed(range(WORLD)):  # rank 0's results last: they stand
        with np.load(os.path.join(work, f"dp{rank}.npz")) as data:
            results.update({k: data[k] for k in data.files})
    return results


@functools.lru_cache(maxsize=None)
def _single(case, work):
    """The case run in this process without a plan (once per module)."""
    return case(None, work)


# --- the JAX package on one device, on the same params and inputs ------------


@functools.lru_cache(maxsize=None)
def _jax_decode():
    """JAX greedy and beam (3, "avg") of the tiny config, as
    tests/test_parallel.py's programs, on the served (folded) params."""
    import jax
    import jax.numpy as jnp
    from nanodecoder_tpu.decode.beam import beam_decode
    from nanodecoder_tpu.decode.greedy import greedy_decode
    from nanodecoder_tpu.models.model import encode, prepare_serving_params

    jcfg = _jax_tiny()
    mcfg, dcfg = jcfg.model, _beam_decode_cfg(jcfg)
    params = prepare_serving_params(_jax_params("tiny"), mcfg)
    signal, lengths = (jnp.asarray(x) for x in _signal(jcfg))

    def greedy(p, s, n):
        r = greedy_decode(p, mcfg, *encode(p, mcfg, s, n))
        return r.tokens, r.lengths

    def beam(p, s, n):
        r = beam_decode(p, mcfg, dcfg, *encode(p, mcfg, s, n))
        return r.tokens[:, 0], r.lengths[:, 0], r.token_log_probs[:, 0]

    g, b = jax.jit(greedy)(params, signal, lengths), jax.jit(beam)(params, signal, lengths)
    return {k: np.asarray(v) for k, v in (
        ("greedy/tokens", g[0]), ("greedy/lengths", g[1]), ("beam/tokens", b[0]),
        ("beam/lengths", b[1]), ("beam/lps", b[2]))}


@functools.lru_cache(maxsize=None)
def _jax_serving():
    """JAX greedy and beam (3) of the tiny flagship serving config from its
    int6 wire, as test_parallel.py's serving test: {mode: (tokens,
    lengths)} of the best hypothesis a row."""
    import jax
    import jax.numpy as jnp
    from nanodecoder_tpu.decode.beam import beam_decode
    from nanodecoder_tpu.decode.greedy import greedy_decode
    from nanodecoder_tpu.io.signal import wire_to_f32
    from nanodecoder_tpu.models.model import encode, prepare_serving_params

    config = _jax_serving_cfg()
    mcfg = config.model
    h2d = config.decode.resolve_h2d(mcfg.compute_dtype)
    clip, chunk_len = config.signal.clip_sigma, config.signal.chunk_len
    params = prepare_serving_params(_jax_params("serving"), mcfg)
    dcfg = dataclasses.replace(config.decode, mode="beam", beam_size=3)

    def memory(p, s, n):
        return encode(p, mcfg, wire_to_f32(s, h2d, clip, chunk_len), n)

    def greedy(p, s, n):
        r = greedy_decode(p, mcfg, *memory(p, s, n))
        return r.tokens, r.lengths

    def beam(p, s, n):
        r = beam_decode(p, mcfg, dcfg, *memory(p, s, n))
        return r.tokens[:, 0], r.lengths[:, 0]

    wire, lengths = (jnp.asarray(x) for x in _serving_wire(config))
    return {mode: [np.asarray(x) for x in jax.jit(fn)(params, wire, lengths)]
            for mode, fn in (("greedy", greedy), ("beam", beam))}


@functools.lru_cache(maxsize=None)
def _jax_train(ga: float, work: str, dropout: float = 0.0):
    """One JAX SGD step (as tests/test_parallel.py's) from the same params
    on the same batch, keyed as the JAX trainer keys its first step
    (split(PRNGKey(train.seed))[1]): (flat params after it, its metrics,
    the params)."""
    import jax
    import jax.numpy as jnp
    from nanodecoder_tpu.train.optim import build_optimizer
    from nanodecoder_tpu.train.trainer import TrainState, make_train_step

    jcfg = _train_cfg(ga, _jax_tiny(), dropout)
    params = _jax_params("tiny")
    optimizer, _ = build_optimizer(jcfg.train, jcfg.model.d_model)
    state = TrainState(params, optimizer.init(params), jnp.zeros((), jnp.int32))
    step_key = jax.random.split(jax.random.PRNGKey(jcfg.train.seed))[1]
    state, metrics = jax.jit(make_train_step(jcfg, optimizer))(
        state, _train_batch(work), step_key)
    return _flat(state.params), {k: np.asarray(v) for k, v in metrics.items()}, state.params


@functools.lru_cache(maxsize=None)
def _jax_valid(work: str) -> np.ndarray:
    """JAX's eval step summed over the validation batches, on its params
    after the guided-attention-0 step: [xent_sum, n_tokens, n_correct]."""
    import jax
    from nanodecoder_tpu.train.trainer import make_eval_step

    eval_step = jax.jit(make_eval_step(_train_cfg(0.0, _jax_tiny())))
    params = _jax_train(0.0, work)[2]
    total = np.zeros(3)
    for batch in _valid_batches(work):
        m = eval_step(params, batch)
        total += [float(m["xent_sum"]), int(m["n_tokens"]), int(m["n_correct"])]
    return total


def test_mesh_shape(dp):
    from nanodecoder_tpu_torch.config import MeshConfig

    assert int(dp["n_devices"]) == WORLD
    assert [list(dp[f"rows_{r}"]) for r in range(WORLD)] == [[0, 8], [8, 16]]
    assert all("does not shard" in str(dp[f"odd_{r}"]) for r in range(WORLD))
    plan = make_mesh_plan()  # no process group here: one device
    assert plan.n_devices == 1 and plan.data_axis == "data" and plan.rank == 0
    assert plan.row_slice(3) == slice(0, 3)
    with pytest.raises(ValueError, match="num_devices"):
        make_mesh_plan(MeshConfig(num_devices=4))


def test_sharded_decode_matches_single_device(dp, work):
    """Greedy over two ranks: tokens and lengths equal to the JAX package's
    single device and to one process."""
    ref, single = _jax_decode(), _single(case_greedy, work)
    for key in ("greedy/tokens", "greedy/lengths"):
        np.testing.assert_array_equal(dp[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(dp[key], single[key], err_msg=key)
    assert len(np.unique(dp["greedy/tokens"])) > 2  # not one token repeated


def test_sharded_beam_decode_matches_single_device(dp, work):
    """Beam 3 over two ranks (a row's beams on its rank): best tokens and
    lengths equal to JAX's single device and to one process, token
    log-probs within 1e-5."""
    ref, single = _jax_decode(), _single(case_beam, work)
    for key in ("beam/tokens", "beam/lengths"):
        np.testing.assert_array_equal(dp[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(dp[key], single[key], err_msg=key)
    np.testing.assert_allclose(dp["beam/lps"], ref["beam/lps"], atol=1e-5)
    np.testing.assert_allclose(dp["beam/lps"], single["beam/lps"], atol=1e-5)


@pytest.mark.parametrize("ga", [0.0, 0.3])
def test_dp_train_step_matches_single_device(dp, work, ga):
    """One DP SGD step over two ranks from the JAX package's params on its
    batch: params within atol 1e-5 / rtol 1e-4 of JAX's single-device step
    (JAX's test_parallel tolerances) and of one process's; token counts
    equal, the loss sum within rtol 1e-5."""
    ref, ref_metrics, _ = _jax_train(ga, work)
    single = _single(case_train, work)
    tag = f"ga{ga}"
    for other in (ref_metrics, {k[len(tag) + 1:]: v for k, v in single.items()
                                if k.startswith(tag + "_")}):
        assert int(dp[f"{tag}_n_tokens"]) == int(other["n_tokens"])
        assert int(dp[f"{tag}_n_correct"]) == int(other["n_correct"])
        np.testing.assert_allclose(dp[f"{tag}_loss_sum"], other["loss_sum"], rtol=1e-5)
    assert sorted(k[len(tag) + 1:] for k in single if k.startswith(tag + "/")) == sorted(ref)
    assert len(ref) > 20
    for key in ref:
        got = dp[f"{tag}/{key}"]
        np.testing.assert_allclose(got, ref[key], atol=1e-5, rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(got, single[f"{tag}/{key}"], atol=1e-5, rtol=1e-4,
                                   err_msg=key)
    # The step moved the params: a comparison of two no-ops would pass.
    start = _flat(_jax_params("tiny"))
    assert max(float(np.abs(ref[k] - v).max()) for k, v in start.items()) > 1e-3


def test_dp_train_step_with_dropout_matches_single_device(dp, work):
    """One DP SGD step over two ranks at dropout 0.1: each rank draws its
    rows of the global masks, so params are within atol 1e-5 / rtol 1e-4
    of one process's step and of the JAX package's single-device step on
    its trainer's first step key, token counts equal, the loss sum within
    rtol 1e-5; and the step differs from the dropout-free one."""
    ref, ref_metrics, _ = _jax_train(0.0, work, 0.1)
    single = _single(case_train, work)
    tag = "drop0.1"
    for other in (ref_metrics, {k[len(tag) + 1:]: v for k, v in single.items()
                                if k.startswith(tag + "_")}):
        assert int(dp[f"{tag}_n_tokens"]) == int(other["n_tokens"])
        assert int(dp[f"{tag}_n_correct"]) == int(other["n_correct"])
        np.testing.assert_allclose(dp[f"{tag}_loss_sum"], other["loss_sum"], rtol=1e-5)
    for key in ref:
        got = dp[f"{tag}/{key}"]
        np.testing.assert_allclose(got, ref[key], atol=1e-5, rtol=1e-4, err_msg=key)
        np.testing.assert_allclose(got, single[f"{tag}/{key}"], atol=1e-5, rtol=1e-4,
                                   err_msg=key)
    assert abs(float(dp[f"{tag}_loss_sum"]) - float(dp["ga0.0_loss_sum"])) > 1e-3


def test_dp_eval_step_sums_metrics(dp, work):
    """Validation over two ranks after the step: the cross-entropy sum,
    tokens and correct tokens equal JAX's eval step summed over the same
    batches (counts exact, the sum rtol 1e-5) and one process's."""
    ref, single = _jax_valid(work), _single(case_train, work)
    assert dp["valid"][1:].tolist() == ref[1:].tolist()
    np.testing.assert_allclose(dp["valid"][0], ref[0], rtol=1e-5)
    np.testing.assert_allclose(dp["valid"], single["valid"], rtol=1e-6)


def test_partition_files_disjoint_and_complete():
    files = [f"f{i:03d}.fast5" for i in range(23)]
    parts = [partition_files_for_host(files, process_index=i, process_count=4)
             for i in range(4)]
    assert sorted(f for p in parts for f in p) == sorted(files)
    flat = [f for p in parts for f in p]
    assert len(set(flat)) == len(flat)  # disjoint
    assert partition_files_for_host(files) == files  # one process


def test_host_shard_path():
    assert host_shard_path("/x/out.fastq", 3) == "/x/out.fastq.shard00003"
    assert host_shard_path("/x/out.fastq") == "/x/out.fastq.shard00000"


@pytest.mark.parametrize("mode", ["greedy", "beam", "sample"])
def test_sharded_serving_config_matches_single_device(dp, work, mode):
    """The served program over two ranks: equal to one process (sample
    mode too: each rank draws its rows' noise at their place in the
    batch); greedy and beam tokens and lengths equal to the JAX package's
    single device."""
    single = _single(case_serving, work)
    key = f"serving/{mode}_"
    for name in ("tokens", "lengths", "pos"):
        np.testing.assert_array_equal(dp[key + name], single[key + name])
    np.testing.assert_allclose(dp[key + "lps"].astype(np.float32),
                               single[key + "lps"].astype(np.float32), atol=1e-3)
    assert (single[key + "lengths"] > 0).any()
    if mode == "sample":
        return
    ref_tokens, ref_lengths = _jax_serving()[mode]
    np.testing.assert_array_equal(dp[key + "lengths"], ref_lengths)
    for row, n in enumerate(ref_lengths):
        np.testing.assert_array_equal(dp[key + "tokens"][row, :n], ref_tokens[row, :n],
                                      err_msg=f"row {row}")


@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_mesh_engine_matches_single_device(dp, work, mode):
    """The streaming engine over two ranks (rank 0 writes): FASTQ
    byte-equal to one process's, and to the JAX engine's on the same
    reads and params (qualities within one character)."""
    import test_torch_engine as eng

    single = _single(case_engine, work)
    got, want = str(dp[f"engine_{mode}"]), str(single[f"engine_{mode}"])
    assert got == want
    eng.assert_fastq_close(got, eng._jax_run(mode, "float32", tuple(_engine_files(work))))
    assert got.count("\n@") + got.startswith("@") == eng.N_FILES * eng.READS_PER_FILE


def test_mesh_engine_stops_every_rank_when_rank0_fails(work):
    """Rank 0's writer fails on its first record: both ranks leave after
    the same gather (the stop flag rides in it), well before the stream
    ends, and raise (rank 0 its error), instead of one rank waiting in a
    collective for gloo's 30 minutes."""
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller

    cfg = _stop_cfg(work)
    whole = StreamingBasecaller(_params(work, "engine", cfg), cfg, device="cpu")
    whole.run(_engine_files(work), io.StringIO(), num_workers=1)
    t0 = time.monotonic()
    outs = _spawn_ranks(work, _rank_code("_stop_rank_main"), timeout=STOP_TIMEOUT_S)
    for rank, (rc, log) in enumerate(outs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log}"
    assert time.monotonic() - t0 < STOP_TIMEOUT_S
    runs = [json.load(open(os.path.join(work, f"stop{r}.json"))) for r in range(WORLD)]
    assert runs[0]["raised"] == "OSError: no space left on device"
    assert runs[1]["raised"].startswith("RuntimeError: a rank of the mesh stopped")
    assert runs[0]["batches"] == runs[1]["batches"] < whole.batches


def test_two_process_shard_merge(tmp_path):
    """The basecall CLI on two ranks (gloo, --cpu): each rank basecalls its
    files into a shard, rank 0 merges; every read exactly once, no shard
    left."""
    import test_torch_engine as eng

    cfg = tiny_test_config()
    np.savez(tmp_path / "params.npz", **_flat(_jax_params("tiny")))
    with open(tmp_path / "config.json", "w") as f:
        f.write(cfg.to_json())
    reads_dir = tmp_path / "reads"
    reads_dir.mkdir()
    rng = np.random.default_rng(0)
    ids = []
    for fi in range(4):
        reads = {f"r{fi}_{j}": rng.normal(0, 300, size=rng.integers(300, 900))
                 for j in range(2 if fi < 2 else 1)}
        ids += list(reads)
        eng._write_multi_fast5(str(reads_dir / f"f{fi}.fast5"), reads)
    out = tmp_path / "out.fastq"
    code = ("import os, sys; os.environ['RANK'] = sys.argv[1]; "
            "from nanodecoder_tpu_torch.cli import basecall; "
            "from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes\n"
            "try:\n"
            "    rc = basecall.main(['--cpu', '--input', %r, '--output', %r, '--ckpt', %r,"
            " '--workers', '1', '--dist-init', 'file://' + sys.argv[2] + '/rdzv'])\n"
            "finally:\n"
            "    stop_ingest_processes()\n"
            "sys.exit(rc)" % (str(reads_dir), str(out), str(tmp_path / "params.npz")))
    env = {**os.environ, "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1"}
    for rank, (rc, log) in enumerate(_spawn_ranks(str(tmp_path), code, env)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log}"
    lines = out.read_text().splitlines()
    got = [lines[i][1:] for i in range(0, len(lines), 4)]
    assert sorted(got) == sorted(ids)
    assert not [p for p in os.listdir(tmp_path) if ".shard" in p]


def test_two_process_train_cli(tmp_path):
    """The train CLI on two ranks (gloo, --cpu): rank 0 alone writes the
    checkpoints, whose params after two SGD steps equal one process's
    (atol 1e-5 / rtol 1e-4, guided attention on, dropout 0)."""
    from nanodecoder_tpu_torch.cli import train
    from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager, load_config

    cfg = _train_cfg(0.3)
    cfg = dataclasses.replace(cfg, train=dataclasses.replace(cfg.train, batch_size=4,
                                                             save_every=1))
    (tmp_path / "config.json").write_text(cfg.to_json())
    args = ["--cpu", "--config", str(tmp_path / "config.json"), "--steps", "2",
            "--report-every", "1"]
    assert train.main([*args, "--ckpt-dir", str(tmp_path / "one")]) == 0
    code = ("import os, sys; os.environ['RANK'] = sys.argv[1]; "
            "from nanodecoder_tpu_torch.cli import train; "
            "sys.exit(train.main(%r + ['--ckpt-dir', sys.argv[2] + '/dp', "
            "'--metrics', sys.argv[2] + '/m.jsonl', '--dist-init', "
            "'file://' + sys.argv[2] + '/rdzv']))" % args)
    env = {**os.environ, "WORLD_SIZE": str(WORLD), "OMP_NUM_THREADS": "1"}
    for rank, (rc, log) in enumerate(_spawn_ranks(str(tmp_path), code, env)):
        assert rc == 0, f"rank {rank} exited {rc}:\n{log}"
    one = CheckpointManager(str(tmp_path / "one"), load_config(str(tmp_path / "one")))
    dp = CheckpointManager(str(tmp_path / "dp"), load_config(str(tmp_path / "dp")))
    assert one.all_steps() == dp.all_steps() == [1, 2]
    with np.load(tmp_path / "one" / "2" / "params.npz") as a, \
            np.load(tmp_path / "dp" / "2" / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for key in a.files:
            np.testing.assert_allclose(b[key], a[key], atol=1e-5, rtol=1e-4, err_msg=key)
    assert open(tmp_path / "m.jsonl").read().count('"kind": "train"') == 2  # rank 0 only
    # Interleaved simulator streams have no fixed order: refused on two ranks.
    refuse = code.replace("'--dist-init'", "'--data-workers', '2', '--dist-init'")
    for rank, (rc, log) in enumerate(_spawn_ranks(str(tmp_path / "dp"), refuse, env)):
        assert rc == 2, f"rank {rank} exited {rc}:\n{log}"
