"""PyTorch port, the recurrent model family: the LSTM cell, the biLSTM
encoder, Luong global attention, the input-feed RNN decoder, the four
encoder x decoder combinations through encode, the teacher-forced pass,
greedy and beam search, training, the npz interchange, the OpenNMT
importer, and the train and basecall CLIs.

Each comparison feeds the same numpy inputs (and the JAX package's
params, carried over by `params_from_numpy`) to the JAX package and to
the port on the CPU at the tiny config's widths (D 32, 2 + 2 layers,
lstm_hidden 32, chunks of 256 samples), float32 unless a test says
otherwise, use_pallas false on the model side (the JAX package's XLA
path).  Decoding cases scale the JAX init's generator 3x and, for the
RNN decoder, its LSTM cells' weights 3x (with the init's scale, the tiny
recurrence settles on one token a row and either ends at once or never):
rows end by EOS at different steps, PAD follows, and some rows run to
the end.  The tests marked `cuda` hold the card against the CPU and skip
where there is none.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.models import model as tm
from nanodecoder_tpu_torch.prng import PRNGKey
from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy, params_to_numpy

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EOS = 2
COMBOS = [("lstm", "rnn"), ("transformer", "rnn"), ("lstm", "transformer"),
          ("transformer", "transformer")]


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The tiny model's many small ops run fastest on one thread, and far
    faster than on eight when the suite's other workers hold the cores;
    restored after the module."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _jcfg(enc="lstm", dec="rnn", score="general", **model):
    """The JAX package's tiny config with these model types and overrides
    (staged decoding on, so a lean transformer decoder grows its cache
    over stages of 8, 24 and 48 rows)."""
    from nanodecoder_tpu.config import tiny_test_config

    cfg = tiny_test_config()
    return dataclasses.replace(cfg, model=dataclasses.replace(
        cfg.model, encoder_type=enc, decoder_type=dec, rnn_attention=score,
        staged_decode=True, **model))


def _port_cfg(jcfg):
    from nanodecoder_tpu_torch.config import Config

    return Config.from_json(jcfg.to_json())


def _flat(params) -> dict:
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


@functools.lru_cache(maxsize=None)
def _jparams(enc="lstm", dec="rnn", score="general", scale=3.0):
    """The JAX init (seed 3 with an RNN decoder, else 4), the generator and
    an RNN decoder's cell weights scaled by `scale`."""
    from nanodecoder_tpu.models.model import init_model

    params = init_model(jax.random.PRNGKey(3 if dec == "rnn" else 4),
                        _jcfg(enc, dec, score).model)
    params["generator"]["w"] = params["generator"]["w"] * scale
    if dec == "rnn":
        params["decoder"]["layers"] = [
            {**cell, "wx": cell["wx"] * scale, "wh": cell["wh"] * scale}
            for cell in params["decoder"]["layers"]]
    return params


def _pparams(jparams, jcfg):
    return params_from_numpy(_flat(jparams), _port_cfg(jcfg).model, "cpu")


def _t(x):
    return torch.from_numpy(np.array(x))


@functools.lru_cache(maxsize=None)
def _chunks(b=6, seed=1234):
    """Normalized simulated chunks (B, 256) and their lengths: row 1 is
    short (100 samples) and the last row is a length-0 padding row."""
    from nanodecoder_tpu.train.data import SimSpec, simulate_read

    rng = np.random.default_rng(seed)
    spec = SimSpec()
    sig = np.zeros((b, 256), np.float32)
    for i in range(b):
        _, s = simulate_read(rng, 40, spec)
        s = (s - s.mean()) / s.std()
        sig[i] = s[:256] if s.shape[0] >= 256 else np.pad(s, (0, 256 - s.shape[0]))
    lens = np.full((b,), 256, np.int32)
    lens[1], lens[-1] = 100, 0
    sig[1, 100:] = 0.0
    sig[-1] = 0.0
    return sig, lens


# --------------------------------------------------------------------------
# the cell, the biLSTM encoder, Luong attention


def test_lstm_cell_matches_jax_and_torch_lstm(rng_np):
    """The cell over 7 steps against JAX's lstm_cell and against
    torch.nn.LSTM (one layer; its two biases summed into ours), atol 1e-5
    as tests/test_importer.py holds JAX's."""
    from nanodecoder_tpu.models.encoder import lstm_cell as jcell
    from nanodecoder_tpu_torch.models.modules import lstm_cell

    lstm = torch.nn.LSTM(input_size=12, hidden_size=10)
    sd = lstm.state_dict()
    cell = {"wx": sd["weight_ih_l0"].T.contiguous(), "wh": sd["weight_hh_l0"].T.contiguous(),
            "b": sd["bias_ih_l0"] + sd["bias_hh_l0"]}
    jc = {k: jnp.asarray(v.numpy()) for k, v in cell.items()}
    x = rng_np.normal(size=(7, 3, 12)).astype(np.float32)
    with torch.no_grad():
        want = lstm(_t(x))[0].numpy()
        h = c = torch.zeros(3, 10)
        jh = jcc = jnp.zeros((3, 10))
        for t in range(7):
            h, c = lstm_cell(cell, _t(x[t]), h, c)
            jh, jcc = jcell(jc, jnp.asarray(x[t]), jh, jcc)
            np.testing.assert_allclose(h.numpy(), want[t], atol=1e-5)
            np.testing.assert_allclose(h.numpy(), np.asarray(jh), atol=1e-5)
            np.testing.assert_allclose(c.numpy(), np.asarray(jcc), atol=1e-5)


# bf16: one bf16 rounding (2^-8 relative) per op, compounded over 64
# recurrent steps and two layers, then a layer norm: the tolerance of a
# few bf16 ulps of an O(1) output.
ENC_TOL = {"float32": 1e-5, "bfloat16": 6e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_lstm_encoder_matches_jax(dtype):
    """encode() through the conv front-end and the biLSTM body, rows of
    256 and 100 samples (64 and 25 encoder positions): allclose at
    ENC_TOL (atol and rtol), padded positions exactly 0, lengths equal."""
    from nanodecoder_tpu.models.model import encode as jencode

    jcfg = _jcfg(compute_dtype=dtype)
    sig, lens = _chunks(3)
    sig, lens = sig[:2], lens[:2]
    jp = _jparams()
    mem, ml = jencode(jp, jcfg.model, jnp.asarray(sig), jnp.asarray(lens))
    with torch.no_grad():
        got, gl = tm.encode(_pparams(jp, jcfg), _port_cfg(jcfg).model, _t(sig), _t(lens))
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 64, 32)
    np.testing.assert_array_equal(gl.numpy(), np.asarray(ml))
    ref = np.asarray(mem.astype(jnp.float32))
    out = got.float().numpy()
    tol = ENC_TOL[dtype]
    np.testing.assert_allclose(out, ref, atol=tol, rtol=tol)
    assert (out[1, 25:] == 0).all() and (out[1, :25] != 0).any()


@pytest.mark.parametrize("score", ["dot", "general", "mlp"])
def test_global_attention_matches_jax(score, rng_np):
    """Outputs and probabilities allclose 1e-5 (f32, another sum order);
    masked positions get probability 0; the argmax positions equal."""
    from nanodecoder_tpu.models.decoder import global_attention as jattn
    from nanodecoder_tpu.models.decoder import init_global_attention as jinit
    from nanodecoder_tpu_torch.models.decoder import global_attention

    p = jinit(jax.random.PRNGKey(5), 32, score)
    q = rng_np.normal(size=(3, 32)).astype(np.float32)
    mem = rng_np.normal(size=(3, 20, 32)).astype(np.float32)
    mask = np.arange(20)[None, :] < np.array([20, 7, 1])[:, None]
    ref, rprobs = jattn(p, jnp.asarray(q), jnp.asarray(mem), jnp.asarray(mask), score)
    pt = {k: {n: _t(a) for n, a in v.items()} for k, v in p.items()}
    out, probs = global_attention(pt, _t(q), _t(mem), _t(mask), score)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=1e-5, rtol=1e-5)
    assert probs.dtype == torch.float32 and (probs.numpy()[~mask] == 0).all()
    np.testing.assert_array_equal(probs.argmax(-1).numpy(), np.asarray(rprobs).argmax(-1))


@pytest.mark.parametrize("score", ["dot", "general", "mlp"])
def test_rnn_decoder_step_and_forced_match_jax(score, rng_np):
    """Six decode steps on random tokens (log-probs and state allclose
    1e-5, attention positions equal), and the teacher-forced pass over
    the same tokens (hidden and attention (B, 1, T, S) allclose 1e-5)."""
    from nanodecoder_tpu.models import decoder as jdec
    from nanodecoder_tpu.models import model as jm
    from nanodecoder_tpu_torch.models import decoder as tdec

    jcfg = _jcfg("transformer", "rnn", score)
    jp, cfg = _jparams("transformer", "rnn", score), _port_cfg(jcfg)
    pp = _pparams(jp, jcfg)
    mem = rng_np.normal(size=(4, 16, 32)).astype(np.float32)
    ml = np.array([16, 9, 3, 16], np.int32)
    tokens = rng_np.integers(3, jcfg.model.vocab_size, size=(4, 6)).astype(np.int32)
    jstate = jm.init_decode_state(jp, jcfg.model, jnp.asarray(mem), jnp.asarray(ml))
    state = tm.init_decode_state(pp, cfg.model, _t(mem), _t(ml))
    assert state["step"] == 0 and len(state["hidden"]) == 2
    with torch.no_grad():
        for t in range(6):
            rlp, rpos, jstate = jm.decode_step(jp, jcfg.model, jnp.asarray(tokens[:, t]),
                                               jstate)
            lp, pos, state = tm.decode_step(pp, cfg.model, _t(tokens[:, t]).long(), state)
            np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), atol=1e-5, rtol=1e-5)
            np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos))
            np.testing.assert_allclose(state["input_feed"].numpy(),
                                       np.asarray(jstate["input_feed"]), atol=1e-5)
            for hc, jhc in zip(state["hidden"], jstate["hidden"]):
                for k in ("h", "c"):
                    np.testing.assert_allclose(hc[k].numpy(), np.asarray(jhc[k]),
                                               atol=1e-5)
        assert state["step"] == 6
        y = tm._embed_tokens(pp, cfg.model, _t(tokens).long())
        hid, attn = tdec.rnn_decoder_forced(pp["decoder"], cfg.model, y, _t(mem), _t(ml))
    jy = jm._embed_tokens(jp, jcfg.model, jnp.asarray(tokens))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-6)
    rh, ra = jdec.rnn_decoder_forced(jp["decoder"], jcfg.model, jy, jnp.asarray(mem),
                                     jnp.asarray(ml))
    assert attn.shape == ra.shape == (4, 1, 6, 16)
    np.testing.assert_allclose(hid.numpy(), np.asarray(rh), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(attn.numpy(), np.asarray(ra), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("enc,dec", COMBOS)
def test_encode_and_teacher_forced_match_jax(enc, dec):
    """encode + decode_teacher_forced for each combination: memory, log-
    probs and attention allclose 1e-5 (f32, another sum order)."""
    from nanodecoder_tpu.models import model as jm

    jcfg = _jcfg(enc, dec)
    jp, cfg = _jparams(enc, dec, scale=1.0), _port_cfg(jcfg)
    sig, lens = _chunks(4)
    tgt = np.random.default_rng(2).integers(0, 8, size=(4, 9)).astype(np.int32)
    mem, ml = jm.encode(jp, jcfg.model, jnp.asarray(sig), jnp.asarray(lens))
    rlp, rattn = jm.decode_teacher_forced(jp, jcfg.model, jnp.asarray(tgt), mem, ml)
    with torch.no_grad():
        pp = _pparams(jp, jcfg)
        tmem, tml = tm.encode(pp, cfg.model, _t(sig), _t(lens))
        lp, attn = tm.decode_teacher_forced(pp, cfg.model, _t(tgt), tmem, tml)
    np.testing.assert_allclose(tmem.numpy(), np.asarray(mem), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), atol=1e-5, rtol=1e-5)
    assert attn.shape == rattn.shape
    np.testing.assert_allclose(attn.numpy(), np.asarray(rattn), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("enc,dec", COMBOS)
def test_init_model_and_npz_keys_match_jax(enc, dec):
    """The port's init_model and the npz interchange have exactly the keys
    and shapes that the JAX package's save_params_npz writes (all three
    Luong scores for the RNN decoder); a round trip through the port's
    save_params_npz is bit-equal and loads in the JAX package."""
    from nanodecoder_tpu.models.model import init_model as jinit
    from nanodecoder_tpu.models.model import param_count
    from nanodecoder_tpu.train.checkpoint import save_params_npz as jsave
    from nanodecoder_tpu_torch.train.checkpoint import (expected_param_shapes,
                                                        load_params_npz, save_params_npz)

    import tempfile
    for score in (("dot", "general", "mlp") if dec == "rnn" else ("general",)):
        jcfg = _jcfg(enc, dec, score)
        cfg = _port_cfg(jcfg)
        jp = jinit(jax.random.PRNGKey(0), jcfg.model)
        with tempfile.TemporaryDirectory() as tmp:
            jpath, ppath = os.path.join(tmp, "j.npz"), os.path.join(tmp, "p.npz")
            jsave(jpath, jp)
            with np.load(jpath) as data:
                jflat = {k: data[k] for k in data.files}
            want = {k: v.shape for k, v in jflat.items()}
            assert expected_param_shapes(cfg.model) == want
            ours = tm.init_model(PRNGKey(0), cfg.model)
            assert {k: v.shape for k, v in params_to_numpy(ours).items()} == want
            assert tm.param_count(ours) == param_count(jp)
            loaded = load_params_npz(jpath, cfg.model, device="cpu")
            save_params_npz(ppath, loaded)
            with np.load(ppath) as data:
                assert set(data.files) == set(jflat)
                for k in jflat:
                    assert data[k].tobytes() == jflat[k].tobytes(), k


def test_prepare_serving_params_folds_each_transformer_side():
    """Lean models fold only their transformer side(s), as the JAX package
    does; the RNN decoder and the biLSTM encoder keep their master
    weights.  (The port had folded both sides whenever lean_step was set.)"""
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep

    for enc, dec in COMBOS:
        jcfg = _jcfg(enc, dec)
        jp = _jparams(enc, dec)
        served = tm.prepare_serving_params(_pparams(jp, jcfg), _port_cfg(jcfg).model)
        ref = jprep(jp, jcfg.model)
        assert ("_lean" in served) == ("_lean" in ref) == (dec == "transformer")
        assert ("_enc_lean" in served) == ("_enc_lean" in ref) == (enc == "transformer")


def test_staged_lengths_only_for_a_lean_transformer_decoder():
    """Staged cache growth applies only to a lean transformer decoder (the
    port had staged any lean decoder, and grew an LSTM state as a cache)."""
    from nanodecoder_tpu_torch.decode.greedy import staged_lengths

    for enc, dec in COMBOS:
        for lean in (True, False):
            cfg = _port_cfg(_jcfg(enc, dec, lean_step=lean)).model
            want = [8, 24, 48] if lean and dec == "transformer" else [48]
            assert staged_lengths(cfg) == want, (enc, dec, lean)


# --------------------------------------------------------------------------
# greedy and beam search


def _served(enc, dec, b=6):
    """(JAX served params, port served params, JAX config, port config,
    memory, lengths): the JAX encoder's memory bank over _chunks(b) as
    numpy, which both decoders read (the encoders are held to 1e-5 above;
    a position whose attention ties within that would part the two)."""
    from nanodecoder_tpu.models import model as jm

    jcfg = _jcfg(enc, dec)
    cfg = _port_cfg(jcfg)
    jp = jm.prepare_serving_params(_jparams(enc, dec), jcfg.model)
    pp = tm.prepare_serving_params(_pparams(_jparams(enc, dec), jcfg), cfg.model)
    sig, lens = _chunks(b)
    mem, ml = jm.encode(jp, jcfg.model, jnp.asarray(sig), jnp.asarray(lens))
    return jp, pp, jcfg, cfg, np.asarray(mem), np.asarray(ml)


@pytest.mark.parametrize("min_len", [0, 5])
@pytest.mark.parametrize("enc,dec", COMBOS[:3])
def test_greedy_matches_jax_exactly(enc, dec, min_len):
    """Greedy on one memory bank: tokens, lengths and attention positions
    exactly equal, token log-probs allclose 1e-4.  Rows end by EOS at
    different steps (PAD after), one runs to the end, and with min_len no
    row ends before it."""
    from nanodecoder_tpu.decode.greedy import greedy_decode as jgreedy
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode

    jp, pp, jcfg, cfg, mem, ml = _served(enc, dec)
    ref = jgreedy(jp, jcfg.model, jnp.asarray(mem), jnp.asarray(ml), min_len=min_len)
    res = greedy_decode(pp, cfg.model, _t(mem), _t(ml), min_len=min_len)
    for name in ("tokens", "lengths", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(res.token_log_probs.numpy(),
                               np.asarray(ref.token_log_probs), atol=1e-4)
    lengths = res.lengths.numpy()
    assert len(set(lengths.tolist())) > 2 and (lengths == 48).any() and \
        (lengths < 48).any(), lengths
    assert lengths.min() > min_len
    for row, n in zip(res.tokens.numpy(), lengths):
        if n < 48:
            assert row[n - 1] == EOS and (row[n:] == 0).all()


@pytest.mark.parametrize("use_pallas", [False, True])
def test_beam_rnn_matches_jax(use_pallas):
    """Beam 3 on (lstm, rnn), the advance by K3's plain version
    (use_pallas; the JAX side in interpret mode) or by advance_top_k (the
    JAX package's lax.top_k): all K hypotheses' tokens, lengths,
    finished flags and positions equal, scores and token log-probs
    allclose 1e-5."""
    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu_torch.decode.beam import beam_decode
    from nanodecoder_tpu_torch.ops import beam_step

    jp, pp, jcfg, cfg, mem, ml = _served("lstm", "rnn")
    jd = dataclasses.replace(jcfg.decode, mode="beam", beam_size=3, length_penalty="avg",
                             use_pallas=use_pallas)
    ref = jax.jit(jbeam, static_argnums=(1, 2))(jp, jcfg.model, jd, jnp.asarray(mem),
                                                jnp.asarray(ml))
    before = beam_step.beam_advance.launches
    res = beam_decode(pp, cfg.model, _port_cfg(dataclasses.replace(jcfg, decode=jd)).decode,
                      _t(mem), _t(ml))
    assert beam_step.beam_advance.launches == before  # the CPU runs the plain version
    for name in ("tokens", "lengths", "finished", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("scores", "token_log_probs"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5, rtol=1e-5,
                                   err_msg=name)
    lengths = res.lengths.numpy()
    assert res.tokens.shape == (6, 3, 48) and len(set(lengths.ravel().tolist())) > 2


def test_reorder_decode_state_beam_rnn_matches_jax(rng_np):
    """The RNN state gathered by beam origin: bitwise equal to JAX's, fresh
    tensors; the tiled memory bank and mask stay as they are."""
    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu.models.model import reorder_decode_state_beam as jreorder

    jcfg = _jcfg()
    cfg = _port_cfg(jcfg)
    mem = rng_np.normal(size=(12, 16, 32)).astype(np.float32)
    ml = np.full((12,), 16, np.int32)
    jstate = jinit(_jparams(), jcfg.model, jnp.asarray(mem), jnp.asarray(ml))
    state = tm.init_decode_state(None, cfg.model, _t(mem), _t(ml))
    for i in range(2):
        for k in ("h", "c"):
            a = rng_np.normal(size=(12, 32)).astype(np.float32)
            state["hidden"][i][k], jstate["hidden"][i][k] = _t(a), jnp.asarray(a)
    feed = rng_np.normal(size=(12, 32)).astype(np.float32)
    state["input_feed"], jstate["input_feed"] = _t(feed), jnp.asarray(feed)
    origin = rng_np.integers(0, 3, size=(4, 3)).astype(np.int32)
    out = tm.reorder_decode_state_beam(state, _t(origin))
    ref = jreorder(jstate, jnp.asarray(origin))
    assert out["input_feed"].numpy().tobytes() == np.asarray(ref["input_feed"]).tobytes()
    for hc, rhc, old in zip(out["hidden"], ref["hidden"], state["hidden"]):
        for k in ("h", "c"):
            assert hc[k].numpy().tobytes() == np.asarray(rhc[k]).tobytes()
            assert hc[k].data_ptr() != old[k].data_ptr()
    assert out["memory"] is state["memory"] and out["mem_mask"] is state["mem_mask"]
    with pytest.raises(ValueError, match="transformer-only"):
        tm.init_decode_state(None, cfg.model, _t(mem), _t(ml), beam_k=3)


# --------------------------------------------------------------------------
# training


@pytest.mark.parametrize("accum,ga", [(1, 0.0), (1, 0.3), (2, 0.0), (2, 0.3)])
def test_train_steps_rnn_match_jax(accum, ga):
    """Three Adam steps (constant lr 1e-3) on (lstm, rnn) from the same
    params and batches at dropout 0, at tests/test_torch_train.py's
    tolerances: metrics equal (counts exact, loss_sum and xent_sum rtol
    1e-5), the first step's gradients within rtol 1e-4 / atol 1e-6, params
    after 3 steps within atol 1e-5 but for the elements whose gradient
    was non-zero and under 1e-6 in a step (Adam turns such rounding noise
    into a step of about lr), which are held to the step bound.  The
    exempt elements stay under 5% (3.7% to 4.1% when written; 0.6% in
    the transformer's test: the RNN decoder's LSTM gradients peak at 2e-3
    to 2e-2, an order under the transformer's, so more of them fall under
    1e-6).  Guided attention reads the (B, 1, T, S) Luong attention."""
    import optax
    from nanodecoder_tpu.train import trainer as jt
    from nanodecoder_tpu.train.data import synthetic_batches
    from nanodecoder_tpu.train.optim import build_optimizer
    from test_torch_train import ADAM_STEP, _capture, _grad_np
    from nanodecoder_tpu_torch.train.trainer import Trainer
    from nanodecoder_tpu_torch.vocab import PAD_ID

    jcfg = _jcfg(dropout=0.0)
    jcfg = dataclasses.replace(jcfg, train=dataclasses.replace(
        jcfg.train, accum_steps=accum, guided_attention_weight=ga, optimizer="adam",
        lr_schedule="constant", learning_rate=1e-3))
    cfg = _port_cfg(jcfg)
    jp = _jparams(scale=1.0)
    jopt = optax.chain(_capture(), build_optimizer(jcfg.train, 32)[0])
    jstate = jt.TrainState(jp, jopt.init(jp), jnp.zeros((), jnp.int32))
    jstep = jax.jit(jt.make_train_step(jcfg, jopt))
    trainer = Trainer(cfg, _pparams(jp, jcfg))
    it = synthetic_batches(jcfg, seed=0)
    tiny = {}
    for i in range(3):
        batch = next(it)
        if accum == 2 and i == 0:  # unequal token counts in the micro-batches
            for k in ("tgt_in", "tgt_out"):
                batch[k] = batch[k].copy()
                batch[k][1, :, 4:] = PAD_ID
        jstate, jm = jstep(jstate, batch, jax.random.PRNGKey(i))
        metrics = trainer.train_step(batch)
        for k in ("n_tokens", "n_correct"):
            assert int(metrics[k]) == int(jm[k]), k
        for k in ("loss_sum", "xent_sum"):
            np.testing.assert_allclose(float(metrics[k]), float(jm[k]), rtol=1e-5)
        jgrads = _flat(jstate.opt_state[0])
        for key, g in jgrads.items():
            tiny[key] = tiny.get(key, False) | ((np.abs(g) < 1e-6) & (g != 0))
        if i == 0:
            for key, t in tm.named_leaves(trainer.params).items():
                np.testing.assert_allclose(_grad_np(key, t), jgrads[key], rtol=1e-4,
                                           atol=1e-6, err_msg=key)
    got, want, start = params_to_numpy(trainer.params), _flat(jstate.params), _flat(jp)
    for key in want:
        np.testing.assert_allclose(got[key][~tiny[key]], want[key][~tiny[key]], atol=1e-5,
                                   rtol=0, err_msg=key)
        assert np.all(np.abs(got[key] - start[key])[tiny[key]] <= 3e-3 * ADAM_STEP), key
    assert sum(int(m.sum()) for m in tiny.values()) < 0.05 * sum(
        m.size for m in tiny.values())


# --------------------------------------------------------------------------
# the OpenNMT importer


def _opennmt_state_dict(cfg, seed=0, std=0.2):
    """A synthetic OpenNMT-py state_dict with the reference's names and
    torch layouts for cfg's encoder (transformer or biLSTM) and its
    transformer decoder (K/V projections dec_kv heads wide), values
    N(0, std) from a numpy seed."""
    rng = np.random.default_rng(seed)
    d, dk = cfg.d_model, cfg.d_model // cfg.dec_heads * cfg.dec_kv
    sd = {}

    def put(name, *shape):
        sd[name] = torch.from_numpy((rng.normal(size=shape) * std).astype(np.float32))

    def linear(prefix, n_out, n_in):
        put(f"{prefix}.weight", n_out, n_in)
        put(f"{prefix}.bias", n_out)

    def ln(prefix):
        linear(prefix, d, 1)
        sd[f"{prefix}.weight"] = 1.0 + sd[f"{prefix}.weight"][:, 0]

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
        put(f"encoder.frontend.convs.{i}.weight", ch, in_ch, k)
        put(f"encoder.frontend.convs.{i}.bias", ch)
        in_ch = ch
    linear("encoder.frontend.proj", d, in_ch)
    ln("encoder.frontend.ln")
    for i in range(cfg.enc_layers):
        if cfg.encoder_type == "lstm":
            h = cfg.lstm_hidden
            for direction in ("fwd", "bwd"):
                p = f"encoder.rnn.{i}.{direction}"
                put(f"{p}.weight_ih_l0", 4 * h, d)
                put(f"{p}.weight_hh_l0", 4 * h, h)
                put(f"{p}.bias_ih_l0", 4 * h)
                put(f"{p}.bias_hh_l0", 4 * h)
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
    put("decoder.embeddings.weight", cfg.vocab_size, d)
    linear("generator", cfg.vocab_size, d)
    return sd


@pytest.mark.parametrize("enc,kv_heads", [("transformer", 0), ("lstm", 0), ("lstm", 1)])
def test_importer_matches_jax(enc, kv_heads):
    """One synthetic OpenNMT state_dict through the JAX package's
    import_state_dict and the port's: bit-equal flat arrays under the same
    keys, and greedy tokens, lengths and positions equal on one memory
    bank (each side's imported model)."""
    from nanodecoder_tpu.decode.greedy import greedy_decode as jgreedy
    from nanodecoder_tpu.models import model as jm
    from nanodecoder_tpu.models.importer import import_state_dict as jimport
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.models.importer import import_flat, import_state_dict

    jcfg = _jcfg(enc, "transformer", dec_kv_heads=kv_heads)
    cfg = _port_cfg(jcfg)
    sd = _opennmt_state_dict(cfg.model)
    ref = _flat(jimport(sd, jcfg.model))
    flat = import_flat(sd, cfg.model)
    assert set(flat) == set(ref)
    for key, arr in ref.items():
        assert flat[key].dtype == np.float32 and flat[key].tobytes() == arr.tobytes(), key
    jp = jax.tree_util.tree_map(jnp.asarray, jimport(sd, jcfg.model))
    sig, lens = _chunks(4)
    mem, ml = jm.encode(jp, jcfg.model, jnp.asarray(sig), jnp.asarray(lens))
    want = jgreedy(jm.prepare_serving_params(jp, jcfg.model), jcfg.model, mem, ml)
    pp = tm.prepare_serving_params(import_state_dict(sd, cfg.model, "cpu"), cfg.model)
    got = greedy_decode(pp, cfg.model, _t(mem), _t(ml))
    for name in ("tokens", "lengths", "attn_pos"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), err_msg=name)


def test_importer_rnn_decoder_raises_as_jax_does():
    from nanodecoder_tpu.models.importer import import_state_dict as jimport
    from nanodecoder_tpu_torch.models.importer import import_state_dict

    jcfg = _jcfg("lstm", "rnn")
    sd = _opennmt_state_dict(_jcfg("lstm", "transformer").model)
    with pytest.raises(NotImplementedError):
        jimport(sd, jcfg.model)
    with pytest.raises(NotImplementedError):
        import_state_dict(sd, _port_cfg(jcfg).model, "cpu")


def test_load_torch_checkpoint_round_trip(tmp_path):
    """A reference-shaped .pt ({'model', 'generator' as 0.weight / 0.bias,
    'opt'}) through the port's load_torch_checkpoint: the params equal the
    port's import of the state_dict and the JAX package's load of the same
    file, bit for bit."""
    from nanodecoder_tpu.models.importer import load_torch_checkpoint as jload
    from nanodecoder_tpu_torch.models.importer import import_flat, load_torch_checkpoint

    jcfg = _jcfg("lstm", "transformer")
    cfg = _port_cfg(jcfg)
    sd = _opennmt_state_dict(cfg.model, seed=1)
    want = import_flat(sd, cfg.model)
    model = dict(sd)
    gen = {"0.weight": model.pop("generator.weight"), "0.bias": model.pop("generator.bias")}
    path = str(tmp_path / "ref.pt")
    torch.save({"model": model, "generator": gen, "opt": None}, path)
    got = params_to_numpy(load_torch_checkpoint(path, cfg.model, device="cpu"))
    ref = _flat(jload(path, jcfg.model))
    assert set(got) == set(want) == set(ref)
    for key in want:
        assert got[key].tobytes() == want[key].tobytes() == ref[key].tobytes(), key
    if not torch.cuda.is_available():  # the card is the default device
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            load_torch_checkpoint(path, cfg.model)


# --------------------------------------------------------------------------
# the train and basecall CLIs


def test_train_then_basecall_cli_matches_jax_cli(tmp_path, capsys):
    """The port's train CLI, 2 steps on the CPU, on a tiny (lstm, rnn)
    config; then the port's basecall CLI on its checkpoint directory and
    the JAX package's on the same params as an .npz export (config.json
    beside it), both --cpu --parity on the same fast5 file: ids,
    sequences and record order equal, qualities within 1 Phred (f32 sums
    in another order); then the port's evaluate CLI on the export."""
    import h5py
    import shutil
    from nanodecoder_tpu.train.data import SimSpec, simulate_read
    from test_torch_engine import assert_fastq_close
    from nanodecoder_tpu_torch.cli import basecall, evaluate, train

    jcfg = _jcfg(dropout=0.0)
    # Batches of 8 chunks: the JAX engine shards a batch over the 8
    # virtual CPU devices of the test run.
    jcfg = dataclasses.replace(
        jcfg, decode=dataclasses.replace(jcfg.decode, batch_chunks=8, batch_chunks_engine=8),
        train=dataclasses.replace(jcfg.train, batch_size=4, save_every=2, valid_every=1000))
    cfg_path = str(tmp_path / "config.json")
    with open(cfg_path, "w") as f:
        f.write(jcfg.to_json())
    ck = str(tmp_path / "ck")
    assert train.main(["--cpu", "--ckpt-dir", ck, "--config", cfg_path, "--steps", "2",
                       "--report-every", "1"]) == 0
    export = tmp_path / "export"
    export.mkdir()
    shutil.copy(os.path.join(ck, "2", "params.npz"), export / "params.npz")
    shutil.copy(os.path.join(ck, "config.json"), export / "config.json")

    rng = np.random.default_rng(5)
    spec = SimSpec()
    fast5 = str(tmp_path / "reads.fast5")
    with h5py.File(fast5, "w") as f:
        for i in range(3):
            _truth, sig = simulate_read(rng, int(rng.integers(60, 160)), spec)
            raw = f.create_group(f"read_r{i}/Raw")
            raw.attrs["read_id"] = f"r{i}".encode()
            raw.create_dataset("Signal", data=np.rint(sig * 4).astype(np.int16))
    common = ["--input", fast5, "--parity", "--workers", "1"]
    port_out, jax_out = str(tmp_path / "port.fastq"), str(tmp_path / "jax.fastq")
    assert basecall.main(["--cpu", "--output", port_out, "--ckpt", ck, *common]) == 0
    env = {**os.environ, "JAX_PLATFORMS": "cpu", "PYTHONPATH": REPO,
           "JAX_COMPILATION_CACHE_DIR": str(tmp_path / "jax_cache")}
    res = subprocess.run([sys.executable, "-m", "nanodecoder_tpu.cli.basecall", "--cpu",
                          "--output", jax_out, "--ckpt", str(export / "params.npz"),
                          *common], cwd=str(tmp_path), env=env, capture_output=True,
                         text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    got = open(port_out).read()
    assert_fastq_close(got, open(jax_out).read())
    assert len(got.splitlines()) == 12
    # The evaluate CLI on the .npz export (beam 3: K3's plain version).
    assert evaluate.main(["--cpu", "--ckpt", str(export / "params.npz"), "--simulate", "1",
                          "--read-bases", "300", "--beam", "3", "--json"]) == 0
    summary = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert summary["n_reads"] == 1


# --------------------------------------------------------------------------
# the card


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["greedy", "beam"])
def test_rnn_decode_on_card_matches_cpu(cuda, mode):
    """Tiny (lstm, rnn), f32 without TF32, the port alone (no call into
    the JAX package, whose checkpoint module needs orbax): params from the port's
    init_model (seed 4; generator and decoder cells scaled 3x, as the
    CPU tests scale the JAX init), chunks from the port's simulator;
    encode, then greedy or beam 3 (K3 on the card), on the card and on
    the CPU: memory allclose 1e-4, tokens equal in at least 99% of the
    positions (a near-tie may part f32 sums in another order), K3
    launched once per beam step on the card, and rows ending by EOS at
    different steps."""
    from nanodecoder_tpu_torch.config import tiny_test_config
    from nanodecoder_tpu_torch.decode.beam import beam_decode
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.ops import beam_step
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    base = tiny_test_config()
    model = dataclasses.replace(base.model, encoder_type="lstm", decoder_type="rnn")
    dcfg = dataclasses.replace(base.decode, mode="beam", beam_size=3, use_pallas=True)
    start = tm.init_model(PRNGKey(4), model)
    for cell in start["decoder"]["layers"]:
        cell["wx"], cell["wh"] = cell["wx"] * 3, cell["wh"] * 3
    start["generator"]["w"] = start["generator"]["w"] * 3
    rng, spec = np.random.default_rng(1234), SimSpec()
    sig = np.zeros((8, 256), np.float32)
    for i in range(8):
        s = simulate_read(rng, 40, spec)[1][:256]
        sig[i, :s.shape[0]] = (s - s.mean()) / s.std()
    lens = np.full((8,), 256, np.int32)
    lens[1], lens[-1] = 100, 0
    out = []
    for dev in (cuda, torch.device("cpu")):
        pp = tm.prepare_serving_params(tm.params_to(start, dev), model)
        before = beam_step.beam_advance.launches
        with torch.no_grad():
            mem, ml = tm.encode(pp, model, _t(sig).to(dev), _t(lens).to(dev))
            res = (greedy_decode(pp, model, mem, ml) if mode == "greedy"
                   else beam_decode(pp, model, dcfg, mem, ml))
        if mode == "beam" and dev.type == "cuda":
            assert beam_step.beam_advance.launches - before == res.steps > 0
        out.append((mem.cpu(), res.tokens.cpu(), res.lengths.cpu()))
    (card_mem, card_tok, _), (cpu_mem, cpu_tok, cpu_len) = out
    torch.testing.assert_close(card_mem, cpu_mem, atol=1e-4, rtol=1e-4)
    same = (card_tok == cpu_tok).float().mean().item()
    assert same >= 0.99, same
    assert len(set(cpu_len.flatten().tolist())) > 2, cpu_len
