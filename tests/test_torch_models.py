"""PyTorch port, model path: modules, encoder, decode step and greedy
decoding held against the JAX package on the same inputs (f32, CPU).

Small MQA config: d 64, 2 encoder heads, 4 decoder query heads sharing
one KV head, 2 + 2 layers, chunk_len 256, max_decode_len 48 decoded in
stages of 8, 24 and 48 rows."""

import dataclasses
import functools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nanodecoder_tpu.config import Config as JConfig
from nanodecoder_tpu.config import DecodeConfig as JDecode
from nanodecoder_tpu.config import ModelConfig as JModel
from nanodecoder_tpu.config import SignalConfig as JSignal
from nanodecoder_tpu_torch.config import Config

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
CONFIG = os.path.join(REPO, "bench_results", "config.json")

SMALL = JConfig(
    signal=JSignal(chunk_len=256, chunk_overlap=32),
    model=JModel(vocab_size=8, d_model=64, conv_channels=(16, 32, 64),
                 enc_layers=2, enc_heads=2, enc_ffn_dim=128, dec_layers=2,
                 dec_heads=4, dec_kv_heads=1, dec_ffn_dim=128,
                 max_decode_len=48, staged_decode=True,
                 compute_dtype="float32"),
    decode=JDecode(max_len=48, batch_chunks=8, use_pallas=False),
)
EOS = 2


def _port_config(jcfg: JConfig) -> Config:
    return Config.from_json(jcfg.to_json())


def _flatten(params) -> dict:
    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)
        flat[key] = np.asarray(leaf)
    return flat


@functools.lru_cache(maxsize=None)
def _small_params():
    """JAX init of the small config with the generator scaled up 3x: the
    argmax margins grow, and with this seed greedy rows finish at
    different steps on both sides of a stage boundary (EOS, PAD and the
    early exit are exercised)."""
    from nanodecoder_tpu.models.model import init_model

    params = init_model(jax.random.PRNGKey(3), SMALL.model)
    params["generator"]["w"] = params["generator"]["w"] * 3.0
    return params


def _t(x):
    return torch.from_numpy(np.array(x))


def _small_memory(rng, b=6):
    """JAX lean-encoder memory bank over simulated chunks; row 1 is
    short and the last row is a length-0 batch-padding row."""
    from nanodecoder_tpu.models.model import encode, prepare_serving_params
    from nanodecoder_tpu.train.data import SimSpec, simulate_read

    spec = SimSpec()
    sig = np.zeros((b, 256), np.float32)
    lens = np.full((b,), 256, np.int32)
    for i in range(b):
        _, s = simulate_read(rng, 40, spec)
        s = (s - s.mean()) / s.std()
        sig[i] = s[:256] if s.shape[0] >= 256 else np.pad(s, (0, 256 - s.shape[0]))
    lens[1], lens[-1] = 100, 0
    sig[1, 100:] = 0.0
    sig[-1] = 0.0
    served = prepare_serving_params(_small_params(), SMALL.model)
    mem, mlen = encode(served, SMALL.model, jnp.asarray(sig), jnp.asarray(lens))
    return sig, lens, np.asarray(mem), np.asarray(mlen)


def _port_served(jcfg=SMALL):
    from nanodecoder_tpu_torch.models.model import prepare_serving_params
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    cfg = _port_config(jcfg)
    params = params_from_numpy(_flatten(_small_params()), cfg.model, device="cpu")
    return prepare_serving_params(params, cfg.model), cfg


# --- modules ---------------------------------------------------------------


def test_layer_norm_and_positions_match_jax(rng_np):
    from nanodecoder_tpu.models import modules as jnn
    from nanodecoder_tpu_torch.models import modules as tnn

    x = rng_np.normal(size=(3, 5, 64)).astype(np.float32) * 3 + 1
    p = {"scale": rng_np.normal(size=64).astype(np.float32),
         "bias": rng_np.normal(size=64).astype(np.float32)}
    got = tnn.layer_norm({k: _t(v) for k, v in p.items()}, _t(x)).numpy()
    ref = np.asarray(jnn.layer_norm({k: jnp.asarray(v) for k, v in p.items()},
                                    jnp.asarray(x)))
    np.testing.assert_allclose(got, ref, atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tnn.sinusoidal_positions(97, 256).numpy(),
                               np.asarray(jnn.sinusoidal_positions(97, 256)),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("hq,hk", [(4, 1), (4, 2), (2, 2)])
def test_attention_core_matches_jax(hq, hk, rng_np):
    from nanodecoder_tpu.models import modules as jnn
    from nanodecoder_tpu_torch.models import modules as tnn

    b, tq, tk, dh = 3, 2, 11, 16
    q = rng_np.normal(size=(b, tq, hq, dh)).astype(np.float32)
    k = rng_np.normal(size=(b, tk, hk, dh)).astype(np.float32)
    v = rng_np.normal(size=(b, tk, hk, dh)).astype(np.float32)
    lens = np.array([0, 5, 11], np.int32)
    tmask = tnn.length_mask(_t(lens), tk)[:, None, None, :]
    jmask = jnn.length_mask(jnp.asarray(lens), tk)[:, None, None, :]
    out, probs = tnn.attention_core(_t(q), _t(k), _t(v), tmask)
    rout, rprobs = jnn.attention_core(jnp.asarray(q), jnp.asarray(k),
                                      jnp.asarray(v), jmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=1e-5, rtol=1e-5)


def test_conv_frontend_matches_jax(rng_np):
    from nanodecoder_tpu.models.encoder import conv_frontend as jconv
    from nanodecoder_tpu_torch.models.encoder import conv_frontend

    fe_flat = {k: v for k, v in _flatten(_small_params()).items()}
    _, cfg = _port_served()
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    fe = params_from_numpy(fe_flat, cfg.model, device="cpu")["encoder"]["frontend"]
    sig = rng_np.normal(size=(4, 256)).astype(np.float32)
    lens = np.array([256, 255, 9, 0], np.int32)
    x, ol = conv_frontend(fe, cfg.model, _t(sig), _t(lens))
    rx, rol = jconv(_small_params()["encoder"]["frontend"], SMALL.model,
                    jnp.asarray(sig), jnp.asarray(lens))
    np.testing.assert_allclose(x.numpy(), np.asarray(rx), atol=1e-5, rtol=1e-5)
    np.testing.assert_array_equal(ol.numpy(), np.asarray(rol))


# --- encoder on the flagship ------------------------------------------------


def test_memory_bank_matches_jax_encode_flagship(rng_np):
    from nanodecoder_tpu.models.model import encode as jencode
    from nanodecoder_tpu.models.model import init_model
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu.train.checkpoint import load_params_npz as jload
    from nanodecoder_tpu_torch.models.model import encode, prepare_serving_params
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz

    text = open(CONFIG).read()
    jcfg = JConfig.from_json(text)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(
        jcfg.model, compute_dtype="float32"))
    cfg = _port_config(jcfg)
    sig = np.clip(rng_np.normal(size=(4, 2048)), -5, 5).astype(np.float32)
    lens = np.array([2048, 1000, 37, 0], np.int32)
    for i, n in enumerate(lens):
        sig[i, n:] = 0.0
    jparams = jprep(jload(NPZ, init_model(jax.random.PRNGKey(0), jcfg.model)),
                    jcfg.model)
    rmem, rlen = jencode(jparams, jcfg.model, jnp.asarray(sig), jnp.asarray(lens))
    served = prepare_serving_params(load_params_npz(NPZ, cfg.model, device="cpu"),
                                    cfg.model)
    with torch.inference_mode():
        mem, mlen = encode(served, cfg.model, _t(sig), _t(lens))
    np.testing.assert_array_equal(mlen.numpy(), np.asarray(rlen))
    assert mem.shape == (4, 256, 256)
    np.testing.assert_allclose(mem.numpy(), np.asarray(rmem), atol=1e-4, rtol=1e-4)
    for i, n in enumerate(mlen.numpy()):
        assert not mem[i, n:].any(), i


# --- decoder ------------------------------------------------------------------


def test_decode_step_matches_jax(rng_np):
    """Per-step log-probs and attention positions of the lean step, both
    sides fed the same tokens, across the 8-row block boundaries."""
    from nanodecoder_tpu.models.model import decode_step as jstep
    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.models.model import decode_step, init_decode_state

    _sig, _lens, mem, mlen = _small_memory(rng_np)
    jparams = jprep(_small_params(), SMALL.model)
    jstate = jinit(jparams, SMALL.model, jnp.asarray(mem), jnp.asarray(mlen))
    step_j = jax.jit(jstep, static_argnums=1)
    served, cfg = _port_served()
    state = init_decode_state(served, cfg.model, _t(mem), _t(mlen))
    tokens = np.full((mem.shape[0],), 1, np.int32)  # BOS
    with torch.inference_mode():
        for t in range(20):
            rlp, rpos, jstate = step_j(jparams, SMALL.model, jnp.asarray(tokens), jstate)
            lp, pos, state = decode_step(served, cfg.model, _t(tokens).long(), state)
            np.testing.assert_allclose(lp.numpy(), np.asarray(rlp), atol=1e-4,
                                       rtol=1e-4, err_msg=f"step {t}")
            np.testing.assert_array_equal(pos.numpy(), np.asarray(rpos),
                                          err_msg=f"step {t}")
            tokens = np.asarray(rlp).argmax(-1).astype(np.int32)
        np.testing.assert_allclose(state["self_kv"].numpy(),
                                   np.asarray(jstate["self_kv"]), atol=1e-5)


def test_greedy_matrices_match_jax(rng_np):
    from nanodecoder_tpu.decode.greedy import greedy_decode as jgreedy
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.decode.greedy import decode_stage_lengths, greedy_decode

    assert decode_stage_lengths(48) == [8, 24, 48]
    assert decode_stage_lengths(96) == [24, 48, 96]
    _sig, _lens, mem, mlen = _small_memory(rng_np, b=8)
    ref = jgreedy(jprep(_small_params(), SMALL.model), SMALL.model,
                  jnp.asarray(mem), jnp.asarray(mlen))
    served, cfg = _port_served()
    res = greedy_decode(served, cfg.model, _t(mem), _t(mlen))
    np.testing.assert_array_equal(res.tokens.numpy(), np.asarray(ref.tokens))
    np.testing.assert_array_equal(res.lengths.numpy(), np.asarray(ref.lengths))
    np.testing.assert_array_equal(res.attn_pos.numpy(), np.asarray(ref.attn_pos))
    np.testing.assert_allclose(res.token_log_probs.numpy(),
                               np.asarray(ref.token_log_probs), atol=1e-4)
    lengths = res.lengths.numpy()
    # The case is meaningful: rows finish at different steps, some in a
    # later stage, and PAD follows every EOS.
    assert len(set(lengths.tolist())) > 2 and lengths.max() > 8, lengths
    for row, n in zip(res.tokens.numpy(), lengths):
        if n < 48:
            assert row[n - 1] == EOS and (row[n:] == 0).all()
