"""PyTorch port, the decode modes: sample mode (`decode/sampling.py`),
the beam coverage penalty with `decode_step(return_attn=True)`, and the
path-indirection beam reorder flag (run as the physical reorder), through `beam_decode`, `Translator`, the
streaming engine and the basecall CLI, held against the JAX package on
the same seeded inputs and params (f32, CPU).

Decoders: the small lean MQA config of test_torch_models.py, the lean
and unfolded MHA configs of test_torch_mha.py (their kernels' plain
versions here, JAX's in interpret mode), and the tiny biLSTM + RNN
decoder of test_torch_rnn.py; each with its generator (and RNN cells)
scaled up, so rows end by EOS at different steps.

The port draws jax.random's noise itself (`nanodecoder_tpu_torch.prng`:
the same threefry bits, Gumbel values within about 1e-6 of JAX's), keyed
as the JAX package keys it: sample_decode with a key, Translator and the
engine from a sampling_seed.  Every sampling parity test checks that the
winning draw of each live row leads the runner-up by more than 1e-5, so
an exact-token match is not luck at a near-tie.
"""

import dataclasses
import functools
import io
import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import test_torch_mha as mha
from nanodecoder_tpu_torch import prng
import test_torch_models as small
import test_torch_rnn as rnn

EOS = 2
MARGIN = 1e-6
LEAD = 1e-5  # a winning draw's least lead where tokens must equal JAX's
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FLAGSHIP_NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
FLAGSHIP_CONFIG = os.path.join(REPO, "bench_results", "config.json")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The small models' many tiny ops run fastest on one thread, and far
    faster than on eight when the suite's other workers hold the cores;
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def fast5_files(tmp_path_factory):
    """test_torch_engine.py's reads in fast5 files (that module needs h5py,
    which the card's machine lacks: imported only where used)."""
    from test_torch_engine import write_fast5_files

    return write_fast5_files(tmp_path_factory.mktemp("fast5"))


def _t(x):
    return torch.from_numpy(np.array(x))


# --- decoders: (JAX served params, JAX config, port served params, port
# config, JAX memory bank, its lengths) ----------------------------------


@functools.lru_cache(maxsize=None)
def _decoder(name: str):
    from nanodecoder_tpu.models.model import encode, prepare_serving_params

    if name == "lean_mqa":
        jcfg = small.SMALL
        jserved = prepare_serving_params(small._small_params(), jcfg.model)
        sig, lens = mha._chunks()
        mem, mlen = jax.jit(encode, static_argnums=1)(jserved, jcfg.model,
                                                      jnp.asarray(sig), jnp.asarray(lens))
        served, cfg = small._port_served()
        return jserved, jcfg, served, cfg, np.asarray(mem), np.asarray(mlen)
    if name in ("lean_mha", "unfolded_mha"):
        variant = name.split("_")[0]
        jcfg = mha._jcfg(variant)
        _sig, _lens, mem, mlen = mha._jax_bank(variant)
        served, cfg = mha._port_served(variant)
        jserved = prepare_serving_params(mha._jparams(jcfg.model.dec_kv_heads), jcfg.model)
        return jserved, jcfg, served, cfg, mem, mlen
    assert name == "rnn"
    jcfg = rnn._jcfg("lstm", "rnn")
    jparams = rnn._jparams("lstm", "rnn")
    sig, lens = rnn._chunks()
    jserved = prepare_serving_params(jparams, jcfg.model)
    mem, mlen = jax.jit(encode, static_argnums=1)(jserved, jcfg.model, jnp.asarray(sig),
                                                  jnp.asarray(lens))
    from nanodecoder_tpu_torch.models.model import prepare_serving_params as tprep

    cfg = rnn._port_cfg(jcfg)
    served = tprep(rnn._pparams(jparams, jcfg), cfg.model)
    return jserved, jcfg, served, cfg, np.asarray(mem), np.asarray(mlen)


def _port_decode(cfg, **kw):
    return dataclasses.replace(cfg.decode, **kw)


# --- restrict_log_probs ------------------------------------------------------


def _nucleus_boundary(lp: np.ndarray, topp: float) -> np.ndarray:
    """(B, V) bool: entries whose mass-before in the descending order lies
    within MARGIN of topp, where the two cumsums may fall either side."""
    order = np.argsort(-lp, axis=1, kind="stable")
    probs = np.exp(np.take_along_axis(lp.astype(np.float64), order, axis=1))
    before = np.cumsum(probs, axis=1) - probs
    near = np.abs(before - topp) < MARGIN
    out = np.zeros_like(near)
    np.put_along_axis(out, order, near, axis=1)
    return out


@pytest.mark.parametrize("case", ["topk", "topp", "both", "ties"])
def test_restrict_log_probs_matches_jax(case, rng_np):
    """The kept set equal (the nucleus but for entries whose mass-before
    lies within 1e-6 of p, which the test counts as exempt), the
    renormalized log-probs within 1e-6.  "ties": the k-th value repeated,
    and every tied entry kept."""
    from nanodecoder_tpu.decode.sampling import restrict_log_probs as jrestrict
    from nanodecoder_tpu_torch.decode.sampling import restrict_log_probs

    b, v = 32, 344
    logits = rng_np.normal(size=(b, v)).astype(np.float32) * 2.5
    if case == "ties":
        top = np.sort(logits[:, 3:], axis=1)[:, ::-1]
        logits[:, :3] = top[:, 4:5]  # three more copies of the 5th largest
    lp = np.asarray(torch.log_softmax(_t(logits), dim=-1))
    topk, topp = {"topk": (5, 0.0), "topp": (0, 0.9), "both": (20, 0.8),
                  "ties": (5, 0.0)}[case]
    ref = np.asarray(jrestrict(jnp.asarray(lp), topk, topp))
    got = restrict_log_probs(_t(lp), topk, topp).numpy()
    exempt = _nucleus_boundary(lp, topp) if topp else np.zeros(lp.shape, bool)
    kept_ref, kept = ref > -1e8, got > -1e8
    assert (kept_ref == kept)[~exempt].all()
    rows = ~(exempt.any(axis=1))
    assert rows.sum() >= b - 2
    np.testing.assert_allclose(got[rows], ref[rows], atol=1e-6, rtol=1e-6)
    n_kept = kept.sum(axis=1)
    if case == "topk":
        assert (n_kept == topk).all()
    elif case == "ties":
        assert (n_kept == topk + 3).all()
    else:
        assert (n_kept > 1).all() and (n_kept < v).all()


# --- decode_step(return_attn=True) ----------------------------------------------


@pytest.mark.parametrize("name", ["lean_forced_unfolded", "unfolded_mha", "rnn"])
def test_decode_step_return_attn_matches_jax(name):
    """Four steps of fixed tokens: attn_mean within rtol/atol 1e-6,
    log-probs within 1e-5, attention positions equal.  The lean config
    runs unfolded over per-layer caches (init with lean_step false), as
    the coverage beam does."""
    from nanodecoder_tpu.models.model import decode_step as jstep
    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu_torch.models.model import decode_step, init_decode_state

    jserved, jcfg, served, cfg, mem, mlen = _decoder(
        "lean_mqa" if name == "lean_forced_unfolded" else name)
    jm, m = jcfg.model, cfg.model
    init_j, init_t = jm, m
    if name == "lean_forced_unfolded":
        assert m.lean_step
        init_j = dataclasses.replace(jm, lean_step=False)
        init_t = dataclasses.replace(m, lean_step=False)
    jstate = jinit(jserved, init_j, jnp.asarray(mem), jnp.asarray(mlen))
    state = init_decode_state(served, init_t, _t(mem), _t(mlen))
    rng = np.random.default_rng(7)
    for step in range(4):
        tok = rng.integers(3, m.vocab_size, size=mem.shape[0]).astype(np.int32)
        jlp, jpos, jmean, jstate = jstep(jserved, jm, jnp.asarray(tok), jstate,
                                         return_attn=True)
        lp, pos, mean, state = decode_step(served, m, _t(tok).long(), state,
                                           return_attn=True)
        assert mean.dtype == torch.float32 and mean.shape == (mem.shape[0], mem.shape[1])
        np.testing.assert_allclose(mean.numpy(), np.asarray(jmean), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=1e-5)
        np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
        # Rows with memory sum their attention to 1.
        live = mlen > 0
        np.testing.assert_allclose(mean.numpy()[live].sum(axis=1), 1.0, atol=1e-5)


# --- sample_decode through the Gumbel seam --------------------------------------

SETTINGS = {  # temperature, topk, topp, min_len
    "ancestral": (1.0, 0, 0.0, 0),
    "t0.7_k3_min2": (0.7, 3, 0.0, 2),
    "p0.9": (1.0, 0, 0.9, 0),
    "t0.7_k3_p0.9_min2": (0.7, 3, 0.9, 2),
}
SAMPLE_CASES = ([("lean_mqa", s) for s in SETTINGS]
                + [(d, s) for d in ("lean_mha", "unfolded_mha", "rnn")
                   for s in ("ancestral", "t0.7_k3_p0.9_min2")])


def _recording_draws(monkeypatch):
    """Record every draw of the port's sampler: (its key, the lead of the
    winning noisy score over the runner-up in each row, the drawn
    tokens)."""
    calls = []
    real = prng.categorical

    def record(key, logits, row0=0):
        out = real(key, logits, row0=row0)
        noisy = logits + prng.gumbel(key, logits.shape, device=logits.device,
                                     offset=row0 * logits.shape[-1])
        top2 = torch.topk(noisy, 2, dim=-1).values
        calls.append((tuple(int(w) for w in key), (top2[:, 0] - top2[:, 1]).numpy(),
                      out.numpy()))
        return out
    monkeypatch.setattr(prng, "categorical", record)
    return calls


def _least_lead(calls, batch_keys) -> float:
    """The least lead of a winning draw over the rows still live (no EOS
    drawn before) at every step of the batches keyed by batch_keys (step
    t of batch b draws with fold_in(batch_keys[b], t))."""
    index = {tuple(int(w) for w in prng.fold_in(k, t)): (b, t)
             for b, k in enumerate(batch_keys) for t in range(64)}
    live, least = {}, np.inf
    for key, lead, chosen in calls:
        b, t = index[key]
        if t == 0:
            live[b] = np.ones(len(lead), bool)
        if live[b].any():
            least = min(least, float(lead[live[b]].min()))
        live[b] &= chosen != EOS
    return least


def _sampling_keys(seed: int, n: int) -> list:
    return [prng.fold_in(prng.PRNGKey(seed), b) for b in range(n)]


@pytest.mark.parametrize("name,setting", SAMPLE_CASES)
def test_sample_decode_matches_jax(name, setting, monkeypatch):
    """One key on both sides, the port drawing its own noise: tokens,
    lengths and positions equal, log-probs and scores within 1e-5."""
    from nanodecoder_tpu.decode.sampling import sample_decode as jsample
    from nanodecoder_tpu_torch.decode.sampling import sample_decode

    temp, topk, topp, min_len = SETTINGS[setting]
    jserved, jcfg, served, cfg, mem, mlen = _decoder(name)
    kw = dict(mode="sample", temperature=temp, sampling_topk=topk, sampling_topp=topp,
              min_len=min_len)
    jd = dataclasses.replace(jcfg.decode, **kw)
    key = jax.random.PRNGKey(11)
    ref = jax.jit(jsample, static_argnums=(1, 2))(jserved, jcfg.model, jd,
                                                   jnp.asarray(mem), jnp.asarray(mlen), key)
    draws = _recording_draws(monkeypatch)
    res = sample_decode(served, cfg.model, _port_decode(cfg, **kw), _t(mem), _t(mlen),
                        prng.PRNGKey(11))
    for f in ("tokens", "lengths", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("token_log_probs", "scores"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    assert _least_lead(draws, [prng.PRNGKey(11)]) > LEAD
    lengths = res.lengths.numpy()
    assert len(set(lengths.tolist())) > 1, lengths
    if min_len:
        assert (lengths > min_len).all()
    if topk:  # every drawn token among the top k of its step
        assert (res.token_log_probs.numpy()[res.tokens.numpy() != 0] > -1e8).all()


def test_sample_topk_1_equals_greedy():
    """topk 1 keeps only the argmax: the greedy call, token for token, with
    log-prob 0 for every drawn token."""
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.decode.sampling import sample_decode

    _js, _jc, served, cfg, mem, mlen = _decoder("lean_mqa")
    m = dataclasses.replace(cfg.model, staged_decode=False)
    greedy = greedy_decode(served, m, _t(mem), _t(mlen))
    res = sample_decode(served, m, _port_decode(cfg, mode="sample", sampling_topk=1),
                        _t(mem), _t(mlen), prng.PRNGKey(5))
    for f in ("tokens", "lengths", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), getattr(greedy, f).numpy())
    assert (res.token_log_probs.numpy() == 0.0).all()


def test_sample_seeds_reproduce_and_differ():
    """One key twice: the same tokens; another seed or batch number: other
    tokens; the noise is finite (never drawn from U = 0) with the Gumbel
    mean."""
    from nanodecoder_tpu_torch.decode.sampling import sample_decode

    _js, _jc, served, cfg, mem, mlen = _decoder("lean_mqa")
    dcfg = _port_decode(cfg, mode="sample", temperature=1.3)

    def run(seed, batch_no=0):
        return sample_decode(served, cfg.model, dcfg, _t(mem), _t(mlen),
                             _sampling_keys(seed, batch_no + 1)[-1]).tokens.numpy()
    a, b, c, d = run(3), run(3), run(4), run(3, 1)
    np.testing.assert_array_equal(a, b)
    assert (a != c).any() and (a != d).any()
    g = prng.gumbel(prng.PRNGKey(0), (4096, 344), device="cpu")
    assert torch.isfinite(g).all() and abs(float(g.mean()) - 0.5772) < 0.01


def _sample_translator(seed=9, **kw):
    from nanodecoder_tpu_torch.decode.translator import Translator

    served, cfg = small._port_served()
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(
        cfg.decode, mode="sample", sampling_seed=seed, **{"temperature": 1.5, **kw}))
    return Translator(served, cfg, device="cpu")


def test_translator_batches_draw_apart_and_reproduce():
    """Two batches of the same 8 chunks draw apart (each batch has its own
    key); a new Translator with the seed reproduces both; a temperature of
    0 raises."""
    sig, lens, _mem, _mlen = small._small_memory(np.random.default_rng(1234), b=8)
    chunks = np.concatenate([sig, sig])
    lengths = np.concatenate([lens, lens])
    first = _sample_translator().decode_chunk_batch(chunks, lengths)
    again = _sample_translator()
    second = again.decode_chunk_batch(chunks, lengths)
    assert again.batches == 2 and again.sample_batches == 2
    for x, y in zip(first, second):
        np.testing.assert_array_equal(x, y)
    tokens = first[0]
    assert (tokens[:8] != tokens[8:]).any()
    other = _sample_translator(seed=10).decode_chunk_batch(chunks, lengths)
    assert (other[0] != tokens).any()
    with pytest.raises(ValueError, match="temperature > 0"):
        _sample_translator(temperature=0.0)


SAMPLED = {"temperature": 1.0, "sampling_topk": 5}


def test_translator_sample_matches_jax(monkeypatch):
    """Translator in sample mode (lean MQA, T 1.0, top-k 5) from one
    sampling_seed on both sides, over two dispatched batches: tokens,
    lengths and positions equal to the JAX package's Translator, log-probs
    within 1e-5; every live row's winning draw leads by more than 1e-5."""
    from nanodecoder_tpu.decode.translator import Translator as JTranslator

    sig, lens, _mem, _mlen = small._small_memory(np.random.default_rng(1234), b=8)
    chunks = np.concatenate([sig, sig[::-1]])
    lengths = np.concatenate([lens, lens[::-1]])
    jcfg = dataclasses.replace(small.SMALL, decode=dataclasses.replace(
        small.SMALL.decode, mode="sample", sampling_seed=21, **SAMPLED))
    ref = JTranslator(small._small_params(), jcfg).decode_chunk_batch(chunks, lengths)
    draws = _recording_draws(monkeypatch)
    tr = _sample_translator(seed=21, **SAMPLED)
    got = tr.decode_chunk_batch(chunks, lengths)
    assert tr.sample_batches == 2
    for i, name in ((0, "tokens"), (1, "lengths"), (4, "positions")):
        np.testing.assert_array_equal(got[i], np.asarray(ref[i]), err_msg=name)
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), atol=1e-5, rtol=1e-5)
    assert _least_lead(draws, _sampling_keys(21, 2)) > LEAD
    assert len(set(np.asarray(got[1]).tolist())) > 1


def test_engine_sample_matches_jax(fast5_files, monkeypatch):
    """The streaming engine in sample mode (T 1.0, top-k 5) from one
    sampling_seed: FASTQ ids and sequences equal to the JAX engine's on
    the same reads (qualities within one character), every live row's
    winning draw leading by more than 1e-5."""
    from nanodecoder_tpu.decode.engine import StreamingBasecaller as JEngine
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy
    from test_torch_engine import _flat, _jcfg, _jparams, _port_cfg, assert_fastq_close

    sampled = {**SAMPLED, "sampling_seed": 6}
    jcfg = _jcfg("sample")
    jcfg = dataclasses.replace(jcfg, decode=dataclasses.replace(jcfg.decode, **sampled))
    want = io.StringIO()
    JEngine(_jparams(), jcfg).run(fast5_files, want, num_workers=2)
    cfg = _port_cfg("sample")
    cfg = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode, **sampled))
    draws = _recording_draws(monkeypatch)
    eng = StreamingBasecaller(params_from_numpy(_flat(), cfg.model, device="cpu"), cfg,
                              device="cpu")
    got = io.StringIO()
    eng.run(fast5_files, got, num_workers=2)
    assert eng.batches > 1
    assert_fastq_close(got.getvalue(), want.getvalue())
    assert _least_lead(draws, _sampling_keys(6, eng.batches)) > LEAD


def test_engine_sample_mode_reproduces_at_any_depth(fast5_files):
    """The engine numbers its sample batches in dispatch order: depth 1 and
    depth 4 give the same FASTQ, and topk 1 gives the greedy engine's."""
    from nanodecoder_tpu_torch.decode.engine import StreamingBasecaller
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy
    from test_torch_engine import _flat, _port_cfg

    def run(mode, depth, **kw):
        cfg = _port_cfg(mode)

        cfg = dataclasses.replace(cfg, decode=dataclasses.replace(cfg.decode, **kw))
        eng = StreamingBasecaller(params_from_numpy(_flat(), cfg.model, device="cpu"),
                                  cfg, depth=depth, device="cpu")
        out = io.StringIO()
        eng.run(fast5_files, out, num_workers=2)
        return out.getvalue(), eng.batches

    sampled = {"temperature": 1.5, "sampling_seed": 4}
    a, n = run("sample", 1, **sampled)
    b, _ = run("sample", 4, **sampled)
    assert a == b and n > 1
    greedy, _ = run("greedy", 2)
    top1, _ = run("sample", 2, sampling_topk=1)
    assert a != greedy
    ids = lambda text: text.splitlines()[0::4]  # noqa: E731
    assert ids(top1) == ids(greedy)
    assert top1.splitlines()[1::4] == greedy.splitlines()[1::4]


# --- beam with the coverage penalty --------------------------------------------


COVERAGE_CASES = [(d, kind, beta) for d in ("lean_mqa", "rnn")
                  for kind in ("wu", "summary") for beta in (0.2, 4.0)]


@pytest.mark.parametrize("name,kind,beta", COVERAGE_CASES)
def test_beam_coverage_matches_jax(name, kind, beta, caplog):
    """Beam 3 with the coverage penalty: tokens, lengths, finished flags
    and positions equal to JAX's, scores and log-probs within 1e-5; the
    scores differ from the same decode at beta 0 (and at beta 4, some
    hypothesis too); the Translator warns that the kernels are off."""
    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu_torch.decode.beam import beam_decode
    from nanodecoder_tpu_torch.decode.translator import Translator

    jserved, jcfg, served, cfg, mem, mlen = _decoder(name)
    kw = dict(mode="beam", beam_size=3, length_penalty="avg", coverage_penalty=kind,
              beta=beta, use_pallas=True)
    jd = dataclasses.replace(jcfg.decode, **kw)
    ref = jax.jit(jbeam, static_argnums=(1, 2))(jserved, jcfg.model, jd,
                                                 jnp.asarray(mem), jnp.asarray(mlen))
    res = beam_decode(served, cfg.model, _port_decode(cfg, **kw), _t(mem), _t(mlen))
    for f in ("tokens", "lengths", "finished", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
    for f in ("scores", "token_log_probs"):
        np.testing.assert_allclose(getattr(res, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
    plain = beam_decode(served, cfg.model, _port_decode(cfg, **{**kw, "beta": 0.0}),
                        _t(mem), _t(mlen))
    assert np.abs(res.scores.numpy() - plain.scores.numpy()).max() > 1e-3
    if beta > 1.0:
        assert (res.tokens.numpy() != plain.tokens.numpy()).any()
    # The package's logger does not propagate to the root, where caplog listens.
    logger = logging.getLogger("nanodecoder_tpu_torch")
    logger.addHandler(caplog.handler)
    try:
        Translator(served, dataclasses.replace(cfg, decode=_port_decode(cfg, **kw)),
                   device="cpu")
    finally:
        logger.removeHandler(caplog.handler)
    assert "turns off the beam advance kernel" in caplog.text


def test_flagship_coverage_matches_jax():
    """The MQA flagship at full width (bench_results), golden read 101 (4
    chunks), beam 5, f32, coverage "wu" at beta 0.2 through both
    Translators: tokens and lengths equal, scores within 1e-5, and the
    scores apart from the port's beta-0 decode."""
    from nanodecoder_tpu.config import Config as JConfig
    from nanodecoder_tpu.decode.translator import Translator as JTranslator
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.train.checkpoint import load_params_npz as jload
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.signal import chunk_signal, normalize_signal
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    def flagship(config, beta):
        cfg = config.from_json(open(FLAGSHIP_CONFIG).read())
        return dataclasses.replace(
            cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32"),
            decode=dataclasses.replace(cfg.decode, mode="beam", beam_size=5,
                                       h2d_dtype="float32", batch_chunks_beam=4,
                                       coverage_penalty="wu", beta=beta))
    cfg, jcfg = flagship(Config, 0.2), flagship(JConfig, 0.2)
    spec = SimSpec()
    _truth, sig = simulate_read(np.random.default_rng(101), 900, spec, spec.level_table())
    sc = cfg.signal
    cb = chunk_signal(normalize_signal(sig, sc.normalization, sc.mad_scale, sc.clip_sigma),
                      sc.chunk_len, sc.chunk_overlap, sc.min_chunk_fill)
    params = load_params_npz(FLAGSHIP_NPZ, cfg.model, device="cpu")
    got = Translator(params, cfg, device="cpu").decode_chunk_batch(cb.chunks, cb.lengths)
    ref = JTranslator(jload(FLAGSHIP_NPZ, init_model(jax.random.PRNGKey(0), jcfg.model)),
                      jcfg).decode_chunk_batch(cb.chunks, cb.lengths)
    plain = Translator(params, flagship(Config, 0.0), device="cpu").decode_chunk_batch(
        cb.chunks, cb.lengths)
    assert cb.n_chunks == 4 and (got[1] > 40).all()
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])
    np.testing.assert_allclose(got[3], ref[3], atol=1e-5, rtol=1e-5)
    assert np.abs(got[3] - plain[3]).min() > 1e-3


def test_coverage_beam_leaves_the_kernels(monkeypatch):
    """Under the coverage penalty the decode takes the top-k advance and
    the unfolded step: K3 and K2 are never called, even with use_pallas."""
    from nanodecoder_tpu_torch.decode import beam
    from nanodecoder_tpu_torch.models import decoder

    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper was called under coverage")
    monkeypatch.setattr(beam, "beam_advance", refuse)
    monkeypatch.setattr(decoder, "write_cache_block", refuse)
    _js, _jc, served, cfg, mem, mlen = _decoder("lean_mqa")
    res = beam.beam_decode(served, cfg.model, _port_decode(
        cfg, mode="beam", beam_size=3, coverage_penalty="wu", beta=0.2, use_pallas=True),
        _t(mem), _t(mlen))
    assert res.steps > 0


# --- beam with the path-indirection reorder ---------------------------------------


@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("name", ["lean_mqa", "lean_mha"])
def test_beam_path_reorder_matches_jax_and_physical(name, staged):
    """Beam 3, path mode: tokens, lengths, finished flags and positions
    equal to JAX's path mode and to the port's physical reorder; scores
    and log-probs within 1e-5 of JAX's (f32 steps summed in another
    order) and within 1e-6 of the physical reorder's."""
    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu_torch.decode.beam import beam_decode

    jserved, jcfg, served, cfg, mem, mlen = _decoder(name)
    jm = dataclasses.replace(jcfg.model, staged_decode=staged)
    m = dataclasses.replace(cfg.model, staged_decode=staged)
    kw = dict(mode="beam", beam_size=3, length_penalty="avg", use_pallas=True)
    jd = dataclasses.replace(jcfg.decode, path_reorder=True, **kw)
    ref = jax.jit(jbeam, static_argnums=(1, 2))(jserved, jm, jd, jnp.asarray(mem),
                                                 jnp.asarray(mlen))
    got = beam_decode(served, m, _port_decode(cfg, path_reorder=True, **kw), _t(mem),
                      _t(mlen))
    phys = beam_decode(served, m, _port_decode(cfg, **kw), _t(mem), _t(mlen))
    for f in ("tokens", "lengths", "finished", "attn_pos"):
        np.testing.assert_array_equal(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                      err_msg=f)
        np.testing.assert_array_equal(getattr(got, f).numpy(), getattr(phys, f).numpy(),
                                      err_msg=f)
    for f in ("scores", "token_log_probs"):
        np.testing.assert_allclose(getattr(got, f).numpy(), np.asarray(getattr(ref, f)),
                                   atol=1e-5, rtol=1e-5, err_msg=f)
        np.testing.assert_allclose(getattr(got, f).numpy(), getattr(phys, f).numpy(),
                                   atol=1e-6, rtol=1e-6, err_msg=f)
    assert got.steps == phys.steps
    if staged:
        assert got.steps > 8  # past the first stage boundary


def test_path_reorder_ignored_off_the_lean_step():
    """The RNN decoder and an unfolded config ignore path_reorder, as in the
    JAX package (the port's lean step runs it as the physical reorder
    too): the same result as without it."""
    from nanodecoder_tpu_torch.decode.beam import beam_decode

    for name in ("rnn", "unfolded_mha"):
        _js, _jc, served, cfg, mem, mlen = _decoder(name)
        kw = dict(mode="beam", beam_size=3, length_penalty="avg")
        a = beam_decode(served, cfg.model, _port_decode(cfg, path_reorder=True, **kw),
                        _t(mem), _t(mlen))
        b = beam_decode(served, cfg.model, _port_decode(cfg, **kw), _t(mem), _t(mlen))
        for f in ("tokens", "scores", "token_log_probs"):
            assert torch.equal(getattr(a, f), getattr(b, f)), (name, f)


# --- the basecall CLI ------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--sample", "--sampling-topk", "1"],
                                  ["--beam", "3", "--coverage-penalty", "wu", "--beta",
                                   "0.2"]],
                         ids=["sample_topk1", "beam_coverage"])
def test_basecall_cli_modes_match_jax_cli(argv, tmp_path, fast5_files):
    """Both CLIs with --cpu --parity and these flags on the same files and
    npz export: ids, sequences and order byte-equal, qualities within 1
    Phred."""
    from nanodecoder_tpu_torch.cli import basecall
    from test_torch_engine import _jax_cli, _write_ckpt, assert_fastq_close

    ckpt = _write_ckpt(tmp_path)
    common = ["--input", os.path.dirname(fast5_files[0]), "--ckpt", ckpt, "--parity",
              "--workers", "2", "--stitch", "attn", *argv]
    port_out, jax_out = str(tmp_path / "port.fastq"), str(tmp_path / "jax.fastq")
    assert basecall.main(["--cpu", "--output", port_out, *common]) == 0
    _jax_cli(["--output", jax_out, *common], tmp_path)
    assert_fastq_close(open(port_out).read(), open(jax_out).read())


def test_basecall_cli_beam_with_sample_exits_2(tmp_path, fast5_files):
    from nanodecoder_tpu_torch.cli import basecall
    from test_torch_engine import _write_ckpt

    assert basecall.main(["--cpu", "--input", fast5_files[0], "--output",
                          str(tmp_path / "o.fq"), "--ckpt", _write_ckpt(tmp_path),
                          "--beam", "3", "--sample"]) == 2


# --- on the card ---------------------------------------------------------------------


def _tiny_on(dev, lean=True):
    """The JAX package's tiny config (random params, generator 3x) on dev,
    served, with a memory bank of 4 simulated chunks (the port's simulator:
    the card's machine cannot import the JAX package's training modules)."""
    from nanodecoder_tpu_torch.config import tiny_test_config
    from nanodecoder_tpu_torch.models.model import (encode, init_model,
                                                    prepare_serving_params)
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    cfg = tiny_test_config()
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, staged_decode=True, lean_step=lean, use_pallas=True,
        compute_dtype="float32"), decode=dataclasses.replace(cfg.decode, use_pallas=True))
    params = init_model(prng.PRNGKey(3), cfg.model, dev)
    params["generator"]["w"] = params["generator"]["w"] * 3.0
    served = prepare_serving_params(params, cfg.model)
    rng, spec = np.random.default_rng(4), SimSpec()
    sig = np.stack([simulate_read(rng, 40, spec)[1][:256] for _ in range(4)])
    sig = (sig - sig.mean(axis=1, keepdims=True)) / sig.std(axis=1, keepdims=True)
    lens = np.array([256, 200, 100, 256], np.int32)
    mem, mlen = encode(served, cfg.model, _t(sig.astype(np.float32)).to(dev),
                       _t(lens).to(dev))
    return served, cfg, mem, mlen


@pytest.mark.cuda
def test_path_reorder_equals_physical_on_card(cuda):
    """path_reorder on the card (K2 and K3): tokens and lengths equal to
    the physical reorder, scores within 1e-6."""
    from nanodecoder_tpu_torch.decode.beam import beam_decode

    served, cfg, mem, mlen = _tiny_on(cuda)
    kw = dict(mode="beam", beam_size=3, length_penalty="avg")
    got = beam_decode(served, cfg.model, _port_decode(cfg, path_reorder=True, **kw),
                      mem, mlen)
    phys = beam_decode(served, cfg.model, _port_decode(cfg, **kw), mem, mlen)
    for f in ("tokens", "lengths", "attn_pos"):
        assert torch.equal(getattr(got, f), getattr(phys, f)), f
    torch.testing.assert_close(got.scores, phys.scores, atol=1e-6, rtol=1e-6)


@pytest.mark.cuda
def test_sample_topk_1_equals_greedy_on_card(cuda):
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.decode.sampling import sample_decode

    served, cfg, mem, mlen = _tiny_on(cuda)
    m = dataclasses.replace(cfg.model, staged_decode=False)
    greedy = greedy_decode(served, m, mem, mlen)
    res = sample_decode(served, m, _port_decode(cfg, mode="sample", sampling_topk=1),
                        mem, mlen, prng.PRNGKey(0))
    for f in ("tokens", "lengths", "attn_pos"):
        assert torch.equal(getattr(res, f), getattr(greedy, f)), f
