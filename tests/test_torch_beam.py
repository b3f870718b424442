"""PyTorch port, beam search: penalties, kernels K3 and K7 (plain
versions on the CPU), the beam-grouped decode step and state reorder,
`beam_decode`, the Translator in beam mode and the evaluate CLI, each
held against the JAX package on the same inputs (f32, CPU).

The JAX side runs its beam kernels in interpret mode (the decode config
sets use_pallas, as the JAX package's own tests do), so both sides pick
candidates by the same iterated extraction, repeated indices included.
Model cases use the small MQA config of test_torch_models.py (vocab 8,
EOS 2, stages of 8, 24 and 48 rows)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_torch_models import (SMALL, _port_config, _port_served, _small_memory,
                               _small_params, _t)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
CONFIG = os.path.join(REPO, "bench_results", "config.json")
EOS = 2
NEG_INF = -1.0e9


# --- penalties --------------------------------------------------------------


@pytest.mark.parametrize("kind", ["none", "wu", "avg"])
def test_length_penalty_bitwise_matches_jax(kind):
    """Bitwise (tolerance 0): the value divides scores inside K3.  The
    JAX side is compiled over traced lengths, as its beam loop runs it."""
    from nanodecoder_tpu.decode.penalties import length_penalty as jlp
    from nanodecoder_tpu_torch.decode.penalties import length_penalty

    lengths = np.arange(1, 97, dtype=np.int32)
    ref = np.asarray(jax.jit(lambda n: jlp(n, kind, 0.6))(jnp.asarray(lengths)))
    got = np.array([length_penalty(int(n), kind, 0.6).numpy() for n in lengths])
    assert got.dtype == np.float32
    assert got.tobytes() == ref.tobytes()
    assert length_penalty(torch.from_numpy(lengths), kind, 0.6).numpy().tobytes() \
        == ref.tobytes()


@pytest.mark.parametrize("kind", ["wu", "summary", "none"])
def test_coverage_penalty_matches_jax(kind, rng_np):
    """allclose 1e-6: f32 log and sums in another order."""
    from nanodecoder_tpu.decode.penalties import coverage_penalty as jcov
    from nanodecoder_tpu_torch.decode.penalties import coverage_penalty

    a = rng_np.uniform(0.0, 2.0, size=(3, 5, 40)).astype(np.float32)
    ref = np.asarray(jcov(jnp.asarray(a), kind, 0.4))
    got = coverage_penalty(_t(a), kind, 0.4).numpy()
    assert got.shape == (3, 5)
    np.testing.assert_allclose(got, ref, atol=1e-6, rtol=1e-6)


# --- kernels K3 and K7 (plain versions on the CPU) ---------------------------

SHAPES = [(3, 5, 8), (2, 3, 8), (1, 1, 8), (2, 5, 344)]


def _beam_inputs(rng, b, k, v, case):
    """alive (B, K), log-probs (B, K, V), finished (B, K), all f32.
    "random": EOS made likely in some rows, part of the finished set
    filled.  "step0": the first step (alive [0, -1e9, ...], nothing
    finished) -- beams 1.. give -1e9 + lp == -1e9 exactly, and the
    finished set returns slot 0 K times.  "below": every candidate under
    -1e9 (alive -2e9), so the best one comes back with value -1e9.
    "few": as step0 with all but 6 of beam 0's log-probs -inf, so fewer
    than 2K candidates lie above -1e9 beside exact -1e9 ties (at V 8 <
    2K).  "neg_inf": random with -inf log-probs, a whole beam in row 0."""
    logits = rng.normal(size=(b, k, v)).astype(np.float32) * 2
    logits[0, :, EOS] += 3.0
    lp = np.asarray(torch.log_softmax(_t(logits), dim=-1))
    if case in ("step0", "few", "below"):
        alive = np.full((b, k), -2e9 if case == "below" else NEG_INF, np.float32)
        if case != "below":
            alive[:, 0] = 0.0
        fin = np.full((b, k), NEG_INF, np.float32)
        if case == "few":
            lp = lp.copy()
            lp[:, 0, 6:] = -np.inf
    else:
        alive = np.sort(-rng.exponential(3.0, size=(b, k)).astype(np.float32),
                        axis=1)[:, ::-1].copy()
        fin = np.full((b, k), NEG_INF, np.float32)
        fin[:, : k // 2] = -rng.exponential(1.0, size=(b, k // 2))
        if case == "neg_inf":
            lp = lp.copy()
            lp[:, :, 1::3] = -np.inf
            lp[0, k - 1] = -np.inf
    return alive, lp, fin


CASES = ["random", "step0", "below", "few", "neg_inf"]


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k,v", SHAPES)
def test_beam_advance_plain_matches_jax_interpret(b, k, v, case, rng_np):
    """All five outputs bitwise equal (tolerance 0)."""
    from nanodecoder_tpu.ops.beam_step import beam_advance as jadvance
    from nanodecoder_tpu_torch.decode.penalties import length_penalty
    from nanodecoder_tpu_torch.ops import beam_step

    alive, lp, fin = _beam_inputs(rng_np, b, k, v, case)
    pen = float(length_penalty(7, "wu", 0.6))
    ref = jadvance(jnp.asarray(alive), jnp.asarray(lp), jnp.asarray(fin),
                   jnp.float32(pen), k, v, EOS, interpret=True)
    before = beam_step.beam_advance.launches
    got = beam_step.beam_advance(_t(alive), _t(lp), _t(fin), pen, k, v, EOS)
    assert beam_step.beam_advance.launches == before  # the CPU runs the plain version
    for name, g, r in zip(("top_ids", "alive_s", "alive_sel", "fin_s", "fin_sel"),
                          got, ref):
        r = np.asarray(r)
        assert g.dtype == (torch.int32 if r.dtype == np.int32 else torch.float32)
        assert g.numpy().tobytes() == r.tobytes(), name
    if case == "step0":
        # Repeated indices, which torch.topk / lax.top_k would not return.
        if k > 1:
            assert any(len(set(row)) < k for row in got[4].numpy().tolist())
        if v < 2 * k:
            assert len(set(got[0].numpy()[0].tolist())) < 2 * k
    elif case == "below":
        # The best slot, then the same slot again at -1e9.
        top_i = got[0].numpy()
        assert (top_i == top_i[:, :1]).all()
    elif case == "few" and 2 * k > 6:
        # Six picks above -1e9, then slot 0 (the lowest at or above it).
        assert (got[0].numpy()[:, 6:] == 0).all()


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("b,k,v", SHAPES)
def test_beam_topk_plain_matches_jax_interpret(b, k, v, case, rng_np):
    """Scores and ids bitwise equal (tolerance 0)."""
    from nanodecoder_tpu.ops.beam_step import beam_topk as jtopk
    from nanodecoder_tpu_torch.ops import beam_step

    alive, lp, _fin = _beam_inputs(rng_np, b, k, v, case)
    n_out = 2 * k
    rs, ri = jtopk(jnp.asarray(alive), jnp.asarray(lp), n_out, interpret=True)
    s, i = beam_step.beam_topk(_t(alive), _t(lp), n_out)
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    assert i.numpy().tobytes() == np.asarray(ri).tobytes()


@jax.jit
def _jax_advance_top_k(alive, lp, fin, pen):
    """The JAX package's advance when use_pallas is false (decode/beam.py,
    the lax.top_k branch without coverage), pen traced as in its loop."""
    b, k, v = lp.shape
    top_scores, top_ids = jax.lax.top_k((alive[:, :, None] + lp).reshape(b, k * v),
                                        2 * k)
    is_eos = (top_ids % v).astype(jnp.int32) == EOS
    alive_s, alive_sel = jax.lax.top_k(jnp.where(is_eos, NEG_INF, top_scores), k)
    fin_cand = jnp.where(is_eos, top_scores / pen - jnp.zeros((b, 2 * k), jnp.float32),
                         NEG_INF)
    fin_s, fin_sel = jax.lax.top_k(jnp.concatenate([fin, fin_cand], axis=1), k)
    return top_ids, alive_s, alive_sel, fin_s, fin_sel


@pytest.mark.parametrize("case", CASES + ["ties"])
@pytest.mark.parametrize("b,k,v", SHAPES)
def test_advance_top_k_matches_jax(b, k, v, case, rng_np):
    """The advance of use_pallas false against JAX's lax.top_k branch:
    all five outputs bitwise equal, ties to the lowest index."""
    from nanodecoder_tpu_torch.decode.beam import advance_top_k
    from nanodecoder_tpu_torch.decode.penalties import length_penalty

    if case == "ties":
        alive, lp, fin = (np.zeros(s, np.float32) for s in ((b, k), (b, k, v), (b, k)))
    else:
        alive, lp, fin = _beam_inputs(rng_np, b, k, v, case)
    pen = length_penalty(7, "wu", 0.6)
    ref = _jax_advance_top_k(jnp.asarray(alive), jnp.asarray(lp), jnp.asarray(fin),
                             jnp.asarray(pen.numpy()))
    got = advance_top_k(_t(alive), _t(lp), _t(fin), float(pen), k, v, EOS)
    for name, g, r in zip(("top_ids", "alive_s", "alive_sel", "fin_s", "fin_sel"),
                          got, ref):
        r = np.asarray(r)
        assert g.numpy().astype(r.dtype).tobytes() == r.tobytes(), name
    if case == "ties":
        np.testing.assert_array_equal(got[0].numpy(), np.tile(np.arange(2 * k), (b, 1)))


def test_evaluate_pallas_flag(monkeypatch, small_ckpt):
    """--pallas / --no-pallas set model.use_pallas and decode.use_pallas;
    without either, the kernel route on the card and the plain one with
    --cpu (the card's default checked with the device lookup and the
    params load stubbed)."""
    from nanodecoder_tpu_torch import device as device_mod
    from nanodecoder_tpu_torch.cli import common, evaluate
    from nanodecoder_tpu_torch.decode import translator

    ap = evaluate.build_argparser()
    assert ap.parse_args([]).pallas is None
    assert ap.parse_args(["--pallas"]).pallas is True
    assert ap.parse_args(["--no-pallas"]).pallas is False
    seen = []

    class Stop(Exception):
        pass

    def fake_translator(params, config, device):
        seen.append((config.model.use_pallas, config.decode.use_pallas, device.type))
        raise Stop

    monkeypatch.setattr(translator, "Translator", fake_translator)
    base = ["--ckpt", small_ckpt, "--simulate", "1"]
    runs = [["--cpu"], ["--cpu", "--pallas"], ["--cpu", "--no-pallas"], [], ["--no-pallas"]]
    for i, extra in enumerate(runs):
        if i == 3:  # the card: its device, the params left on the CPU
            load = common.load_params_and_config
            monkeypatch.setattr(device_mod, "resolve_device",
                                lambda d: torch.device("cuda"))
            monkeypatch.setattr(common, "load_params_and_config",
                                lambda path, _dev: load(path, "cpu"))
        with pytest.raises(Stop):
            evaluate.main(base + extra)
    assert seen == [(False, False, "cpu"), (True, True, "cpu"), (False, False, "cpu"),
                    (True, True, "cuda"), (False, False, "cuda")]


def test_beam_topk_all_ties_lowest_index():
    from nanodecoder_tpu.ops.beam_step import beam_topk as jtopk
    from nanodecoder_tpu_torch.ops.beam_step import beam_topk

    s, i = beam_topk(torch.zeros(1, 2), torch.zeros(1, 2, 4), 3)
    np.testing.assert_array_equal(i.numpy()[0], [0, 1, 2])
    rs, ri = jtopk(jnp.zeros((1, 2)), jnp.zeros((1, 2, 4)), 3, interpret=True)
    assert i.numpy().tobytes() == np.asarray(ri).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()


def test_beam_kernel_wrappers_reject_bad_inputs():
    from nanodecoder_tpu_torch.ops.beam_step import beam_advance, beam_topk

    a, lp, f = torch.zeros(2, 3), torch.zeros(2, 3, 8), torch.zeros(2, 3)
    with pytest.raises(ValueError):
        beam_advance(a, lp, f, 1.0, 3, 7, EOS)                   # v disagrees
    with pytest.raises(ValueError):
        beam_advance(torch.zeros(2, 4), lp, f, 1.0, 3, 8, EOS)   # alive shape
    with pytest.raises(ValueError):
        beam_advance(a, lp, f, 1.0, 3, 8, 8)                     # eos outside V
    with pytest.raises(TypeError):
        beam_advance(a, lp.double(), f, 1.0, 3, 8, EOS)
    with pytest.raises(ValueError):
        beam_advance(a.to("meta"), lp.to("meta"), f.to("meta"), 1.0, 3, 8, EOS)
    with pytest.raises(ValueError):
        beam_topk(a, torch.zeros(2, 3), 4)                       # log_probs not 3-D
    with pytest.raises(ValueError):
        beam_topk(a, lp, 0)
    with pytest.raises(TypeError):
        beam_topk(a.half(), lp, 4)


# --- decoder state and step --------------------------------------------------


def test_reorder_decode_state_beam_matches_jax(rng_np):
    """Bitwise; the gathered caches are fresh tensors (no alias of the
    old ones, which the next step writes in place)."""
    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu.models.model import reorder_decode_state_beam as jreorder
    from nanodecoder_tpu_torch.models.model import (init_decode_state,
                                                    reorder_decode_state_beam)

    _sig, _lens, mem, mlen = _small_memory(rng_np, b=4)
    served, cfg = _port_served()
    state = init_decode_state(served, cfg.model, _t(mem), _t(mlen), beam_k=3)
    jstate = jinit(_small_params(), SMALL.model, jnp.asarray(mem), jnp.asarray(mlen),
                   beam_k=3)
    assert state["self_kv"].shape == jstate["self_kv"].shape == (12, 48, 128)
    assert state["layers"][0]["cross_k"].shape == (4, 32, 1, 16)
    kv = rng_np.normal(size=state["self_kv"].shape).astype(np.float32)
    stage = rng_np.normal(size=state["self_kv_stage"].shape).astype(np.float32)
    state.update(self_kv=_t(kv), self_kv_stage=_t(stage))
    jstate.update(self_kv=jnp.asarray(kv), self_kv_stage=jnp.asarray(stage))
    origin = rng_np.integers(0, 3, size=(4, 3)).astype(np.int32)
    out = reorder_decode_state_beam(state, _t(origin))
    ref = jreorder(jstate, jnp.asarray(origin))
    for key in ("self_kv", "self_kv_stage"):
        assert out[key].numpy().tobytes() == np.asarray(ref[key]).tobytes(), key
        assert out[key].data_ptr() != state[key].data_ptr()
        assert out[key].is_contiguous()
    assert out["layers"] is state["layers"]


def test_beam_grouped_decode_step_matches_jax(rng_np):
    """Decode steps over B * 3 rows (the grouped cross attention):
    log-probs allclose 1e-5 (f32, another sum order), positions equal."""
    from nanodecoder_tpu.models.model import decode_step as jstep
    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.models.model import decode_step, init_decode_state

    _sig, _lens, mem, mlen = _small_memory(rng_np, b=4)
    jparams = jprep(_small_params(), SMALL.model)
    jstate = jinit(jparams, SMALL.model, jnp.asarray(mem), jnp.asarray(mlen), beam_k=3)
    step_j = jax.jit(jstep, static_argnums=1)
    served, cfg = _port_served()
    state = init_decode_state(served, cfg.model, _t(mem), _t(mlen), beam_k=3)
    tokens = np.full((12,), 1, np.int32)  # BOS
    with torch.inference_mode():
        for t in range(12):
            rlp, rpos, jstate = step_j(jparams, SMALL.model, jnp.asarray(tokens), jstate)
            lp, pos, state = decode_step(served, cfg.model, _t(tokens).long(), state)
            np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), atol=1e-5,
                                       rtol=1e-5, err_msg=f"step {t}")
            np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos),
                                          err_msg=f"step {t}")
            tokens = rng_np.integers(3, 8, size=12).astype(np.int32)


# --- beam_decode --------------------------------------------------------------


@pytest.fixture(scope="module")
def small_bank():
    _sig, _lens, mem, mlen = _small_memory(np.random.default_rng(1234), b=6)
    return mem, mlen


@pytest.mark.parametrize("k,penalty,min_len", [
    (1, "none", 0), (1, "wu", 0), (1, "avg", 0),
    (3, "none", 0), (3, "wu", 0), (3, "avg", 0),
    (5, "none", 0), (5, "wu", 0), (5, "avg", 0),
    (3, "none", 6),
])
def test_beam_decode_matches_jax(k, penalty, min_len, small_bank):
    """All K hypotheses: tokens, lengths, finished flags and positions
    equal; scores and token log-probs allclose 1e-5 (f32 decode steps
    summed in another order).  The bank has a short row and a length-0
    padding row."""
    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.decode.beam import beam_decode

    mem, mlen = small_bank
    jd = dataclasses.replace(SMALL.decode, mode="beam", beam_size=k,
                             length_penalty=penalty, min_len=min_len, use_pallas=True)
    ref = jax.jit(jbeam, static_argnums=(1, 2))(
        jprep(_small_params(), SMALL.model), SMALL.model, jd, jnp.asarray(mem),
        jnp.asarray(mlen))
    served, cfg = _port_served()
    res = beam_decode(served, cfg.model, _port_config(
        dataclasses.replace(SMALL, decode=jd)).decode, _t(mem), _t(mlen))
    for name in ("tokens", "lengths", "finished", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("scores", "token_log_probs"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    lengths = res.lengths.numpy()
    assert res.tokens.shape == (6, k, 48) and res.steps >= lengths[:, 0].max()
    if min_len:
        assert (lengths[res.finished.numpy()] > min_len).all()
    if penalty == "avg" and k == 3:
        # The case is meaningful: hypotheses end at different steps, some
        # after a stage boundary, and the decode runs into the last stage.
        assert len(set(lengths.ravel().tolist())) > 3 and lengths.max() > 24
        assert res.steps > 24


# --- Translator, flagship, and the evaluate CLI --------------------------------


def _flagship_beam(cfg):
    return dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
        decode=dataclasses.replace(cfg.decode, mode="beam", beam_size=5,
                                   h2d_dtype="float32", batch_chunks_beam=5,
                                   n_best=2))


def test_flagship_beam_translator_matches_jax():
    """Golden read 101 (900 bases, 4 chunks), beam 5, f32: the sequence
    equal, the qualities allclose 1e-3 (f16 log-probs on the host), and
    decode_nbest's two best token rows equal."""
    from nanodecoder_tpu.config import Config as JConfig
    from nanodecoder_tpu.decode.translator import Translator as JTranslator
    from nanodecoder_tpu.io.fast5 import RawRead as JRead
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.train.checkpoint import load_params_npz as jload
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    text = open(CONFIG).read()
    cfg = _flagship_beam(Config.from_json(text))
    jcfg = _flagship_beam(JConfig.from_json(text))
    spec = SimSpec()
    _truth, sig = simulate_read(np.random.default_rng(101), 900, spec, spec.level_table())
    tr = Translator(load_params_npz(NPZ, cfg.model, device="cpu"), cfg, device="cpu")
    jtr = JTranslator(jload(NPZ, init_model(jax.random.PRNGKey(0), jcfg.model)), jcfg)
    got = tr.basecall_read(RawRead("golden_101", sig, "sim"))
    ref = jtr.basecall_read(JRead("golden_101", sig, "sim"))
    assert got.n_chunks == 4 and tr.batches == 1 and tr.decode_steps > 0
    assert got.sequence == ref.sequence and len(got.sequence) > 800
    np.testing.assert_allclose(got.qualities, ref.qualities, atol=1e-3, rtol=1e-3)

    scfg = cfg.signal
    cb = chunk_signal(normalize_signal(sig, scfg.normalization, scfg.mad_scale,
                                       scfg.clip_sigma),
                      scfg.chunk_len, scfg.chunk_overlap, scfg.min_chunk_fill)
    tok, tl, sc = tr.decode_nbest(cb.chunks, cb.lengths)
    rtok, rtl, rsc = jtr.decode_nbest(cb.chunks, cb.lengths)
    assert tok.shape == (4, 2, 96)
    np.testing.assert_array_equal(tok, rtok)
    np.testing.assert_array_equal(tl, rtl)
    np.testing.assert_allclose(sc, rsc, atol=1e-5, rtol=1e-5)


@pytest.fixture(scope="module")
def small_ckpt(tmp_path_factory):
    """The small config's params as an npz export with config.json beside it."""
    from nanodecoder_tpu.train.checkpoint import save_params_npz

    d = tmp_path_factory.mktemp("ckpt")
    cfg = dataclasses.replace(SMALL, decode=dataclasses.replace(
        SMALL.decode, batch_chunks_beam=4))
    (d / "config.json").write_text(cfg.to_json())
    save_params_npz(str(d / "params.npz"), _small_params())
    return str(d / "params.npz")


def test_evaluate_cli_beam_matches_jax(small_ckpt, capsys, monkeypatch):
    """The JSON summaries of both CLIs are equal (identity from the same
    basecalls)."""
    from nanodecoder_tpu.cli import evaluate as jeval
    from nanodecoder_tpu.utils import cache
    from nanodecoder_tpu_torch.cli import evaluate

    argv = ["--ckpt", small_ckpt, "--cpu", "--beam", "3", "--dtype", "float32",
            "--h2d", "float32", "--simulate", "2", "--read-bases", "300", "--json"]
    assert evaluate.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(cache, "setup_compilation_cache", lambda *a: "")
    assert jeval.main(argv) == 0
    ref = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got == ref
    assert got["n_reads"] == 2 and got["mean_length_ratio"] > 0


# --- contracts --------------------------------------------------------------


@pytest.mark.parametrize("what", ["int8_cross", "ckpt_dir"])
def test_unported_options_raise(what, small_ckpt, tmp_path, capsys, monkeypatch):
    """Both options once refused are ported, and the CLI's JSON summary
    with each equals the JAX CLI's: --int8-cross (the small MQA model reads
    its int8 cross caches through the dequantize fallback), and a JAX
    orbax checkpoint directory (the committed tiny fixture, read without
    JAX).  A directory without config.json still raises."""
    from nanodecoder_tpu.cli import evaluate as jeval
    from nanodecoder_tpu.utils import cache

    from nanodecoder_tpu_torch.cli import evaluate

    if what == "int8_cross":
        ckpt, extra = small_ckpt, ["--int8-cross"]
    else:
        with pytest.raises(ValueError, match="no config.json"):
            evaluate.main(["--ckpt", str(tmp_path), "--cpu", "--simulate", "1"])
        ckpt, extra = os.path.join(os.path.dirname(os.path.abspath(__file__)), "golden",
                                   "jax_orbax_tiny"), []
    argv = ["--ckpt", ckpt, "--cpu", "--simulate", "1", "--read-bases", "200",
            "--dtype", "float32", "--json", *extra]
    assert evaluate.main(argv) == 0
    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    monkeypatch.setattr(cache, "setup_compilation_cache", lambda *a: "")
    assert jeval.main(argv) == 0
    assert got == json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert got["n_reads"] == 1 and got["mean_length_ratio"] > 0
