"""PyTorch port, MHA decoding and the unfolded serving path: kernels K4a,
K4b (decode attention, int8 caches included; GQA/MQA caches too, as the
JAX kernels take them), K5 and K6 (encoder
attention) through their plain versions on the CPU, the int8 cross-cache
quantization, and greedy and beam decoding, each held against the JAX
package on the same inputs.

The JAX side runs with use_pallas set, so its Pallas kernels run in
interpret mode on the CPU.  Small config: d 64, 2 encoder heads, 4
decoder heads with their own K/V (dec_kv_heads 0), 2 + 2 layers,
max_decode_len 48.  Four model variants: lean MHA, lean MHA with int8
cross caches, unfolded MHA (lean_step false) and unfolded MQA.

The `cuda`-marked tests hold the CUDA kernels against the plain versions
on the card and skip where there is none:

    python -m pytest tests/test_torch_mha.py -m cuda --noconftest
"""

import dataclasses
import functools
import json
import os

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.ops import attention, encoder_attention

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NPZ = os.path.join(REPO, "bench_results", "flagship_params.npz")
CONFIG = os.path.join(REPO, "bench_results", "config.json")
GOLDEN = os.path.join(REPO, "tests", "golden", "flagship_golden.json")

VARIANTS = {
    "lean": {},
    "lean_int8": {"cross_cache_int8": True},
    "unfolded": {"lean_step": False},
    "unfolded_mqa": {"lean_step": False, "dec_kv_heads": 1},
}


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _t(x):
    return torch.from_numpy(np.array(x))


def _jcfg(variant: str, pallas: bool = True):
    from nanodecoder_tpu.config import Config, DecodeConfig, ModelConfig, SignalConfig

    model = ModelConfig(vocab_size=8, d_model=64, conv_channels=(16, 32, 64),
                        enc_layers=2, enc_heads=2, enc_ffn_dim=128, dec_layers=2,
                        dec_heads=4, dec_kv_heads=0, dec_ffn_dim=128,
                        max_decode_len=48, staged_decode=True,
                        compute_dtype="float32", use_pallas=pallas)
    return Config(signal=SignalConfig(chunk_len=256, chunk_overlap=32),
                  model=dataclasses.replace(model, **VARIANTS[variant]),
                  decode=DecodeConfig(max_len=48, batch_chunks=8, use_pallas=pallas))


def _port_cfg(variant: str, pallas: bool = True):
    from nanodecoder_tpu_torch.config import Config

    return Config.from_json(_jcfg(variant, pallas).to_json())


@functools.lru_cache(maxsize=None)
def _jparams(kv_heads: int):
    """JAX init with the generator scaled up 3x for wider argmax margins.
    With these seeds greedy rows finish at different steps, on both sides
    of a stage boundary, and some run to the end."""
    import jax

    from nanodecoder_tpu.models.model import init_model

    cfg = _jcfg("unfolded_mqa" if kv_heads else "lean").model
    params = init_model(jax.random.PRNGKey(3 if kv_heads else 2), cfg)
    params["generator"]["w"] = params["generator"]["w"] * 3.0
    return params


def _flatten(params) -> dict:
    import jax

    flat = {}
    for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]:
        key = "/".join(str(getattr(p, "key", getattr(p, "idx", p))) for p in kp)
        flat[key] = np.asarray(leaf)
    return flat


def _port_served(variant: str, pallas: bool = True):
    from nanodecoder_tpu_torch.models.model import prepare_serving_params
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    cfg = _port_cfg(variant, pallas)
    params = params_from_numpy(_flatten(_jparams(cfg.model.dec_kv_heads)), cfg.model,
                               device="cpu")
    return prepare_serving_params(params, cfg.model), cfg


def _chunks(b=6):
    """Simulated signal chunks; row 1 is short and the last row is a
    length-0 batch-padding row."""
    from nanodecoder_tpu.train.data import SimSpec, simulate_read

    rng = np.random.default_rng(1234)
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
    return sig, lens


@functools.lru_cache(maxsize=None)
def _jax_bank(variant: str, pallas: bool = True):
    """(signal, lengths, JAX memory bank, JAX encoder lengths)."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.models.model import encode, prepare_serving_params

    jcfg = _jcfg(variant, pallas)
    sig, lens = _chunks()
    served = prepare_serving_params(_jparams(jcfg.model.dec_kv_heads), jcfg.model)
    mem, mlen = jax.jit(encode, static_argnums=1)(served, jcfg.model, jnp.asarray(sig),
                                                  jnp.asarray(lens))
    return sig, lens, np.asarray(mem), np.asarray(mlen)


# --- kernels K4a / K4b (plain versions on the CPU) -----------------------------


def _decode_inputs(rng, b, t, h, dh, group):
    """q (B * G, D), k/v (B, T, D) f32 and lengths (B,): a length-0 padding
    row, a partial and a full row.  In row 2 the keys at 5 and 9 are the
    same and the strongest match for every query and head, so the head-sum
    argmax ties and must pick 5."""
    d = h * dh
    q = rng.normal(size=(b * group, d)).astype(np.float32)
    k = rng.normal(size=(b, t, d)).astype(np.float32)
    v = rng.normal(size=(b, t, d)).astype(np.float32)
    lens = rng.integers(1, t + 1, size=b).astype(np.int32)
    lens[0], lens[1], lens[2] = 0, t, t
    q[2 * group:3 * group] = np.abs(q[2 * group:3 * group]) * np.sign(q[2 * group])
    k[2, 5] = k[2, 9] = 4.0 * np.sign(q[2 * group])
    return q, k, v, lens


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_decode_attention_plain_matches_jax_interpret(kind, group, rng_np):
    """Outputs allclose (f32 and int8 1e-5, another sum order; bf16 one
    rounding step of the output), attention positions exactly equal."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.ops import attention as ja

    b, t, h, dh = 4, 24, 4, 16
    q, k, v, lens = _decode_inputs(rng_np, b, t, h, dh, group)
    qdt = "float32" if kind == "int8" else kind
    jq, tq = jnp.asarray(q).astype(qdt), _t(q).to(getattr(torch, qdt))
    if kind == "int8":
        quant = jax.jit(ja.quantize_cache_int8)
        (jk, jks), (jv, jvs) = quant(jnp.asarray(k)), quant(jnp.asarray(v))
        (tk, tks), (tv, tvs) = (attention.quantize_cache_int8(_t(x)) for x in (k, v))
        jkw, tkw = {"k_scale": jks, "v_scale": jvs}, {"k_scale": tks, "v_scale": tvs}
    else:
        jk, jv = jnp.asarray(k).astype(kind), jnp.asarray(v).astype(kind)
        tk, tv = _t(k).to(getattr(torch, kind)), _t(v).to(getattr(torch, kind))
        jkw, tkw = {}, {}
    jl, tl = jnp.asarray(lens), _t(lens)
    if group == 1:
        fn = attention.decode_attention
        ro, ra = ja.decode_attention(jq, jk, jv, jl, h, interpret=True, **jkw)
        before = fn.launches
        go, ga = fn(tq, tk, tv, tl, h, **tkw)
    else:
        fn = attention.decode_attention_grouped
        ro, ra = ja.decode_attention_grouped(jq, jk, jv, jl, h, group, interpret=True,
                                             **jkw)
        before = fn.launches
        go, ga = fn(tq, tk, tv, tl, h, group, **tkw)
    assert fn.launches == before  # the CPU runs the plain version
    assert go.dtype == tq.dtype and go.shape == (b * group, h * dh)
    tol = 1e-2 if kind == "bfloat16" else 1e-5
    np.testing.assert_allclose(go.float().numpy(), np.asarray(ro.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))
    assert ga.dtype == torch.int32
    assert (ga.numpy()[2 * group:3 * group] == 5).all()


@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("n_kv", [1, 2, 4])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_decode_attention_gqa_plain_matches_jax_interpret(kind, n_kv, group, rng_np):
    """GQA/MQA caches (n_kv KV heads for 4 query heads, test_gqa.py's
    shapes) through the CPU route, against the JAX kernels in interpret
    mode: outputs allclose (f32 1e-5, another sum order; bf16 1e-2, one
    rounding step of the output), attention positions exactly equal."""
    import jax.numpy as jnp

    from nanodecoder_tpu.ops import attention as ja

    b, t, h, dh = 4, 24, 4, 16
    d, dk = h * dh, n_kv * dh
    q = rng_np.normal(size=(b * group, d)).astype(np.float32)
    k, v = (rng_np.normal(size=(b, t, dk)).astype(np.float32) for _ in range(2))
    lens = rng_np.integers(1, t + 1, size=b).astype(np.int32)
    lens[0] = 0
    jq, jk, jv = (jnp.asarray(x).astype(kind) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(getattr(torch, kind)) for x in (q, k, v))
    if group == 1:
        fn = attention.decode_attention
        ro, ra = ja.decode_attention(jq, jk, jv, jnp.asarray(lens), h, interpret=True)
        before = fn.launches
        go, ga = fn(tq, tk, tv, _t(lens), h)
    else:
        fn = attention.decode_attention_grouped
        ro, ra = ja.decode_attention_grouped(jq, jk, jv, jnp.asarray(lens), h, group,
                                             interpret=True)
        before = fn.launches
        go, ga = fn(tq, tk, tv, _t(lens), h, group)
    assert fn.launches == before  # the CPU runs the plain version
    assert go.dtype == tq.dtype and go.shape == (b * group, d)
    tol = 1e-2 if kind == "bfloat16" else 1e-5
    np.testing.assert_allclose(go.float().numpy(), np.asarray(ro.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    np.testing.assert_array_equal(ga.numpy(), np.asarray(ra))


def test_quantize_cache_int8_bitwise_matches_jax(rng_np):
    """Bitwise against the compiled JAX function (the decode programs'
    form, where XLA multiplies by f32(1/127)); eagerly JAX divides by
    127, so its scales may differ in the last bit and its int8 values
    agree here."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.ops import attention as ja

    x = (rng_np.normal(size=(6, 40, 64))
         * rng_np.exponential(1.0, size=(6, 1, 64))).astype(np.float32)
    x[0, :, 3] = 0.0                                  # an all-zero lane: scale 1e-8/127
    x[1, 7, 5] = 127.5 * np.abs(x[1, :, 5]).max() / 127.0
    q, s = attention.quantize_cache_int8(_t(x))
    rq, rs = jax.jit(ja.quantize_cache_int8)(jnp.asarray(x))
    assert q.dtype == torch.int8 and s.dtype == torch.float32
    assert q.numpy().tobytes() == np.asarray(rq).tobytes()
    assert s.numpy().tobytes() == np.asarray(rs).tobytes()
    eq, es = ja.quantize_cache_int8(jnp.asarray(x))
    assert q.numpy().tobytes() == np.asarray(eq).tobytes()
    np.testing.assert_allclose(s.numpy(), np.asarray(es), rtol=1.2e-7, atol=0)
    for dt in ("float32", "bfloat16"):
        got = attention.dequantize_cache_int8(q, s, getattr(torch, dt))
        ref = ja.dequantize_cache_int8(rq, rs, jnp.dtype(dt))
        assert got.float().numpy().tobytes() == \
            np.asarray(ref.astype(jnp.float32)).tobytes()
    # bf16 caches quantize through f32, as on the JAX side.
    xb = _t(x).to(torch.bfloat16)
    qb, sb = attention.quantize_cache_int8(xb)
    rqb, rsb = jax.jit(ja.quantize_cache_int8)(jnp.asarray(x).astype(jnp.bfloat16))
    assert qb.numpy().tobytes() == np.asarray(rqb).tobytes()
    assert sb.numpy().tobytes() == np.asarray(rsb).tobytes()


def test_decode_attention_wrappers_reject_bad_inputs():
    f, g = attention.decode_attention, attention.decode_attention_grouped
    q, kv, n = torch.zeros(2, 64), torch.zeros(2, 8, 64), torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="dividing n_heads"):
        f(q, torch.zeros(2, 8, 48), torch.zeros(2, 8, 48), n, 4)   # n_kv 3 of 4 heads
    i8, sc = torch.zeros(2, 8, 16, dtype=torch.int8), torch.ones(2, 64)
    with pytest.raises(ValueError, match="MHA only"):
        f(q, i8, i8, n, 4, sc, sc)                                 # int8 + MQA
    with pytest.raises(ValueError):
        g(torch.zeros(5, 64), kv, kv, n, 4, 3)                     # rows != B * G
    with pytest.raises(TypeError):
        f(q, kv.bfloat16(), kv.bfloat16(), n, 4)                   # dtype mismatch
    with pytest.raises(TypeError):
        f(q, kv, kv, n, 4, torch.ones(2, 64), torch.ones(2, 64))   # scales, no int8
    with pytest.raises(ValueError):
        f(q, kv.to(torch.int8), kv.to(torch.int8), n, 4, torch.ones(2, 64))
    with pytest.raises(ValueError):
        f(q.to("meta"), kv.to("meta"), kv.to("meta"), n.to("meta"), 4)


# --- kernels K5 / K6 (plain versions on the CPU) -------------------------------


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,s,h,dh", [(3, 16, 2, 32), (2, 24, 1, 128)])
def test_k5_k6_plain_match_jax_interpret(b, s, h, dh, dtype, rng_np):
    """allclose: f32 1e-5 (another sum order), bf16 one rounding step."""
    import jax.numpy as jnp

    from nanodecoder_tpu.ops import encoder_attention as je

    q, k, v = (rng_np.normal(size=(b, s, h * dh)).astype(np.float32) for _ in range(3))
    lens = rng_np.integers(1, s + 1, size=b).astype(np.int32)
    lens[0] = 0
    jq, jk, jv = (jnp.asarray(x).astype(dtype) for x in (q, k, v))
    tq, tk, tv = (_t(x).to(getattr(torch, dtype)) for x in (q, k, v))
    tol = 1e-5 if dtype == "float32" else 1e-2
    ref5 = je.flash_encoder_attention_nld(jq, jk, jv, jnp.asarray(lens), h,
                                          interpret=True)
    k5, k6 = encoder_attention.flash_encoder_attention_nld, \
        encoder_attention.flash_encoder_attention
    before = (k5.launches, k6.launches)
    got5 = k5(tq, tk, tv, _t(lens), h)
    assert got5.shape == (b, s, h * dh) and got5.dtype == tq.dtype
    np.testing.assert_allclose(got5.float().numpy(), np.asarray(ref5.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    split = lambda x: x.reshape(b, s, h, dh)  # noqa: E731
    ref6 = je.flash_encoder_attention(split(jq), split(jk), split(jv), jnp.asarray(lens),
                                      interpret=True)
    got6 = k6(split(tq), split(tk), split(tv), _t(lens))
    assert got6.shape == (b, s, h, dh)
    np.testing.assert_allclose(got6.float().numpy(), np.asarray(ref6.astype(jnp.float32)),
                               atol=tol, rtol=tol)
    assert (k5.launches, k6.launches) == before


def test_k5_k6_wrappers_reject_bad_inputs():
    k5, k6 = encoder_attention.flash_encoder_attention_nld, \
        encoder_attention.flash_encoder_attention
    x, n = torch.zeros(2, 8, 64), torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        k5(x, x, torch.zeros(2, 8, 32), n, 2)
    with pytest.raises(ValueError):
        k5(x, x, x, n, 3)                                        # 64 % 3
    with pytest.raises(TypeError):
        k5(x, x.bfloat16(), x, n, 2)
    with pytest.raises(ValueError):
        k6(x, x, x, n)                                           # not 4-D
    with pytest.raises(ValueError):
        k6(*(torch.zeros(2, 8, 2, 32, device="meta"),) * 3, n.to("meta"))


# --- modules, encoder and decode state ------------------------------------------


def test_mha_and_ffn_match_jax(rng_np):
    import jax.numpy as jnp

    from nanodecoder_tpu.models import modules as jnn
    from nanodecoder_tpu_torch.models import modules as tnn

    layer = _jparams(0)["decoder"]["layers"][0]
    jp = {"attn": layer["cross_attn"], "ffn": layer["ffn"]}
    tp = {name: {k: {kk: _t(vv) for kk, vv in sub.items()} for k, sub in p.items()}
          for name, p in jp.items()}
    x = rng_np.normal(size=(3, 5, 64)).astype(np.float32)
    mem = rng_np.normal(size=(3, 9, 64)).astype(np.float32)
    lens = np.array([0, 4, 9], np.int32)
    tmask = tnn.length_mask(_t(lens), 9)[:, None, None, :]
    jmask = jnn.length_mask(jnp.asarray(lens), 9)[:, None, None, :]
    out, probs = tnn.mha(tp["attn"], 4, _t(x), _t(mem), tmask)
    rout, rprobs = jnn.mha(jp["attn"], 4, jnp.asarray(x), jnp.asarray(mem), jmask)
    np.testing.assert_allclose(out.numpy(), np.asarray(rout), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(probs.numpy(), np.asarray(rprobs), atol=1e-6)
    np.testing.assert_allclose(tnn.ffn(tp["ffn"], _t(x)).numpy(),
                               np.asarray(jnn.ffn(jp["ffn"], jnp.asarray(x))),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("variant", ["lean", "unfolded"])
def test_encode_matches_jax(variant):
    """The memory bank allclose 1e-5 and the lengths equal; the unfolded
    encoder runs K5 (its plain version here), the lean one K1."""
    from nanodecoder_tpu_torch.models.model import encode

    sig, lens, rmem, rlen = _jax_bank(variant)
    served, cfg = _port_served(variant)
    with torch.inference_mode():
        mem, mlen = encode(served, cfg.model, _t(sig), _t(lens))
    np.testing.assert_array_equal(mlen.numpy(), rlen)
    np.testing.assert_allclose(mem.numpy(), rmem, atol=1e-5, rtol=1e-5)
    assert ("_lean" in served) == (variant == "lean")


@pytest.mark.parametrize("variant", ["lean_int8", "unfolded_mqa"])
def test_int8_cross_cache_state_matches_jax(variant):
    """With cross_cache_int8 the decode state holds int8 cross caches whose
    values and scales equal JAX's bitwise (MHA serves them through K4a/K4b's
    int8 branch, MQA through the dequantize fallback).  The memory bank and
    the cross K/V weights are rounded to multiples of 1/16 and 1/256, so
    both frameworks project them exactly and the comparison sees the
    quantization alone."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.models.model import init_decode_state as jinit
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.models.model import init_decode_state, prepare_serving_params
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    jcfg = _jcfg(variant)
    jcfg = dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model,
                                                               cross_cache_int8=True))
    cfg = _port_cfg(variant)
    cfg = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model,
                                                            cross_cache_int8=True))
    _sig, _lens, mem, mlen = _jax_bank(variant)
    mem = np.round(mem * 16) / 16
    params = jax.tree_util.tree_map(lambda x: x, _jparams(jcfg.model.dec_kv_heads))
    for layer in params["decoder"]["layers"]:
        for name in ("k", "v"):
            dense = layer["cross_attn"][name]
            dense["w"] = jnp.round(dense["w"] * 256) / 256
            dense["b"] = jnp.round(dense["b"] * 256) / 256
    jstate = jax.jit(jinit, static_argnums=(1, 4))(jprep(params, jcfg.model), jcfg.model,
                                                   jnp.asarray(mem), jnp.asarray(mlen), 3)
    served = prepare_serving_params(params_from_numpy(_flatten(params), cfg.model,
                                                      device="cpu"), cfg.model)
    state = init_decode_state(served, cfg.model, _t(mem), _t(mlen), beam_k=3)
    for layer, ref in zip(state["layers"], jstate["layers"]):
        assert sorted(layer) == sorted(ref)
        for key in ("cross_k", "cross_v", "cross_k_scale", "cross_v_scale"):
            r = np.asarray(ref[key])
            assert layer[key].dtype == (torch.int8 if r.dtype == np.int8 else torch.float32)
            assert layer[key].numpy().tobytes() == r.tobytes(), key
    if variant == "unfolded_mqa":
        assert state["layers"][0]["self_k"].shape == (18, 48, 1, 16)
        assert "self_kv" not in state


# --- greedy and beam decoding ----------------------------------------------------


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_greedy_matches_jax(variant):
    """Tokens, lengths and attention positions equal; log-probs allclose
    1e-5 (f32 sums in another order)."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.decode.greedy import greedy_decode as jgreedy
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode

    jcfg = _jcfg(variant)
    _sig, _lens, mem, mlen = _jax_bank(variant)
    ref = jax.jit(jgreedy, static_argnums=1)(jprep(_jparams(jcfg.model.dec_kv_heads),
                                                   jcfg.model),
                                             jcfg.model, jnp.asarray(mem),
                                             jnp.asarray(mlen))
    served, cfg = _port_served(variant)
    res = greedy_decode(served, cfg.model, _t(mem), _t(mlen))
    for name in ("tokens", "lengths", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    np.testing.assert_allclose(res.token_log_probs.numpy(),
                               np.asarray(ref.token_log_probs), atol=1e-5, rtol=1e-5)
    lengths = res.lengths.numpy()
    assert len(set(lengths.tolist())) > 2, lengths


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_beam_matches_jax(variant):
    """Beam 3, all hypotheses: tokens, lengths, finished flags and
    positions equal; scores and log-probs allclose 1e-5."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.decode.beam import beam_decode

    jcfg = _jcfg(variant)
    jd = dataclasses.replace(jcfg.decode, mode="beam", beam_size=3, length_penalty="avg")
    _sig, _lens, mem, mlen = _jax_bank(variant)
    ref = jax.jit(jbeam, static_argnums=(1, 2))(
        jprep(_jparams(jcfg.model.dec_kv_heads), jcfg.model), jcfg.model, jd,
        jnp.asarray(mem), jnp.asarray(mlen))
    served, cfg = _port_served(variant)
    dcfg = dataclasses.replace(cfg.decode, mode="beam", beam_size=3,
                               length_penalty="avg")
    res = beam_decode(served, cfg.model, dcfg, _t(mem), _t(mlen))
    for name in ("tokens", "lengths", "finished", "attn_pos"):
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in ("scores", "token_log_probs"):
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)


# --- use_pallas false: the plain PyTorch route against JAX's XLA path ------------


def _forbid(monkeypatch, module, *names):
    """Make the named kernel wrappers, as `module` imported them, raise."""
    def refuse(*_a, **_k):
        raise AssertionError("a kernel wrapper was called with use_pallas false")
    for name in names:
        monkeypatch.setattr(module, name, refuse)


@pytest.mark.parametrize("variant", ["lean", "unfolded"])
def test_encode_without_kernels_matches_jax(variant, monkeypatch):
    """use_pallas false: both encoders take attention_core (neither K1's
    nor K5's wrapper is called); the bank allclose 1e-5 to JAX's XLA
    encoder."""
    from nanodecoder_tpu_torch.models import encoder
    from nanodecoder_tpu_torch.models.model import encode

    sig, lens, rmem, rlen = _jax_bank(variant, False)
    served, cfg = _port_served(variant, False)
    _forbid(monkeypatch, encoder, "flash_encoder_attention_qkv",
            "flash_encoder_attention_nld")
    with torch.inference_mode():
        mem, mlen = encode(served, cfg.model, _t(sig), _t(lens))
    np.testing.assert_array_equal(mlen.numpy(), rlen)
    np.testing.assert_allclose(mem.numpy(), rmem, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("mode", ["greedy", "beam"])
@pytest.mark.parametrize("variant", ["lean", "unfolded"])
def test_decode_without_kernels_matches_jax(variant, mode, monkeypatch):
    """use_pallas false on both sides: MHA cross attention by the einsum,
    attention positions the head-mean argmax, and (beam 3) the advance by
    three top-k selections.  Tokens, lengths, positions (and finished
    flags) equal; log-probs (and scores) allclose 1e-5 (f32 sums in
    another order).  No decode-attention wrapper is called."""
    import jax
    import jax.numpy as jnp

    from nanodecoder_tpu.decode.beam import beam_decode as jbeam
    from nanodecoder_tpu.decode.greedy import greedy_decode as jgreedy
    from nanodecoder_tpu.models.model import prepare_serving_params as jprep
    from nanodecoder_tpu_torch.decode import beam
    from nanodecoder_tpu_torch.decode.beam import beam_decode
    from nanodecoder_tpu_torch.decode.greedy import greedy_decode
    from nanodecoder_tpu_torch.models import decoder

    jcfg = _jcfg(variant, False)
    _sig, _lens, mem, mlen = _jax_bank(variant, False)
    jserved = jprep(_jparams(0), jcfg.model)
    served, cfg = _port_served(variant, False)
    _forbid(monkeypatch, decoder, "decode_attention", "decode_attention_grouped")
    _forbid(monkeypatch, beam, "beam_advance")
    if mode == "greedy":
        ref = jax.jit(jgreedy, static_argnums=1)(jserved, jcfg.model, jnp.asarray(mem),
                                                 jnp.asarray(mlen))
        res = greedy_decode(served, cfg.model, _t(mem), _t(mlen))
        exact, close = ("tokens", "lengths", "attn_pos"), ("token_log_probs",)
    else:
        jd = dataclasses.replace(jcfg.decode, mode="beam", beam_size=3,
                                 length_penalty="avg")
        ref = jax.jit(jbeam, static_argnums=(1, 2))(jserved, jcfg.model, jd,
                                                    jnp.asarray(mem), jnp.asarray(mlen))
        dcfg = dataclasses.replace(cfg.decode, mode="beam", beam_size=3,
                                   length_penalty="avg")
        res = beam_decode(served, cfg.model, dcfg, _t(mem), _t(mlen))
        exact = ("tokens", "lengths", "finished", "attn_pos")
        close = ("scores", "token_log_probs")
    for name in exact:
        np.testing.assert_array_equal(getattr(res, name).numpy(),
                                      np.asarray(getattr(ref, name)), err_msg=name)
    for name in close:
        np.testing.assert_allclose(getattr(res, name).numpy(),
                                   np.asarray(getattr(ref, name)), atol=1e-5,
                                   rtol=1e-5, err_msg=name)
    assert len(set(res.lengths.numpy().ravel().tolist())) > 2


# --- the flagship in MHA form ----------------------------------------------------


def expand_kv_heads(flat: dict, heads: int) -> dict:
    """Flat MQA params -> the same model in MHA form: every decoder K/V
    projection (self and cross, w (D, Dh) and b (Dh,)) tiled across the
    heads.  The MHA model computes the same function."""
    out = dict(flat)
    for key, arr in flat.items():
        if key.startswith("decoder/layers/") and any(
                f"_attn/{p}/" in key for p in "kv"):
            out[key] = np.tile(arr, (1,) * (arr.ndim - 1) + (heads,))
    return out


def test_mha_flagship_greedy_and_unfolded_match_golden():
    """Golden read 101 (f32, float32 wire) through the port's Translator on
    the MHA form of the flagship: lean and unfolded both basecall the
    stored string."""
    from nanodecoder_tpu_torch.config import Config
    from nanodecoder_tpu_torch.decode.translator import Translator
    from nanodecoder_tpu_torch.io.fast5 import RawRead
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy
    from nanodecoder_tpu_torch.train.data import SimSpec, simulate_read

    cfg = Config.from_json(open(CONFIG).read())
    cfg = dataclasses.replace(
        cfg, model=dataclasses.replace(cfg.model, compute_dtype="float32",
                                       dec_kv_heads=0),
        decode=dataclasses.replace(cfg.decode, h2d_dtype="float32", batch_chunks=4))
    with np.load(NPZ) as data:
        flat = expand_kv_heads({k: data[k] for k in data.files}, cfg.model.dec_heads)
    assert flat["decoder/layers/0/cross_attn/k/w"].shape == (256, 256)
    params = params_from_numpy(flat, cfg.model, device="cpu")
    spec = SimSpec()
    _truth, sig = simulate_read(np.random.default_rng(101), 900, spec, spec.level_table())
    want = json.load(open(GOLDEN))["reads"]["golden_101"]["sequence"]
    for lean in (True, False):
        c = dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, lean_step=lean))
        tr = Translator(params, c, device="cpu")
        assert tr.basecall_read(RawRead("golden_101", sig, "sim")).sequence == want, lean


# --- the card -----------------------------------------------------------------------


# Kernel-vs-plain tolerances on the card (atol, rtol), as chip_smoke.py
# states them: f32 sums in another order; bf16 one rounding step of an
# output or of a probability at a rounding boundary; int8 f32 sums of
# integers in another order, then scaled.
K4_TOL = {"float32": (1e-5, 1e-5), "bfloat16": (2e-2, 2e-2), "int8": (2e-5, 1e-5)}


def _k4_on_card(dev, kind, group, b, t, seed=0, h=8, dh=32, n_kv=None, tie_is_max=True):
    """K4a (group 1) or K4b against its plain version on _decode_inputs
    (with n_kv, K/V cut to the first n_kv heads: GQA): outputs within
    K4_TOL, attention positions equal in at least 99% of rows and in
    every row of chunk 2, and (tie_is_max) chunk 2's tie resolved to the
    lower position.  Under GQA the tied key need not be the strongest for
    the heads that read another KV head's lanes, so another position may
    win there (tie_is_max false)."""
    rng = np.random.default_rng(seed)
    q, k, v, lens = _decode_inputs(rng, b, t, h, dh, group)
    if n_kv is not None:
        k, v = (np.ascontiguousarray(x[:, :, :n_kv * dh]) for x in (k, v))
    qdt = torch.float32 if kind == "int8" else getattr(torch, kind)
    tq = _t(q).to(dev, qdt)
    if kind == "int8":
        (tk, ks), (tv, vs) = (attention.quantize_cache_int8(_t(x).to(dev)) for x in (k, v))
        kw = {"k_scale": ks, "v_scale": vs}
    else:
        tk, tv, kw = _t(k).to(dev, qdt), _t(v).to(dev, qdt), {}
    n = _t(lens).to(dev)
    if group == 1:
        got = attention.decode_attention(tq, tk, tv, n, h, **kw)
        ref = attention.decode_attention_plain(tq, tk, tv, n, h, **kw)
    else:
        got = attention.decode_attention_grouped(tq, tk, tv, n, h, group, **kw)
        ref = attention.decode_attention_grouped_plain(tq, tk, tv, n, h, group, **kw)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(got[0]).all())
    atol, rtol = K4_TOL[kind]
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
    assert (got[1] == ref[1]).float().mean() > 0.99
    tied = slice(2 * group, 3 * group)
    assert torch.equal(got[1][tied], ref[1][tied])
    if tie_is_max:
        assert (got[1][tied] == 5).all()


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 5])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_k4_kernels_match_plain_on_card(cuda, kind, group):
    _k4_on_card(cuda, kind, group, b=64, t=256)


@pytest.mark.cuda
@pytest.mark.parametrize("t", [37, 256])
@pytest.mark.parametrize("group", [2, 3, 5, 8])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_k4b_kernel_group_sizes_on_card(cuda, kind, group, t):
    """The grouped kernel's instantiations, at a cache length that is no
    multiple of its 16-row stages and at the flagship's."""
    _k4_on_card(cuda, kind, group, b=48, t=t, seed=group * 1000 + t)


@pytest.mark.cuda
@pytest.mark.parametrize("h,dh", [(4, 16), (8, 64)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16", "int8"])
def test_k4b_kernel_other_widths_on_card(cuda, kind, h, dh):
    """The grouped kernel at D 64 (Dh 16, most threads without an output
    channel) and D 512 (four channels a thread)."""
    _k4_on_card(cuda, kind, 3, b=24, t=37, seed=dh, h=h, dh=dh)


@pytest.mark.cuda
@pytest.mark.parametrize("h,dh,n_kv", [(8, 32, 1), (8, 32, 2), (8, 32, 4), (4, 16, 1),
                                       (4, 16, 2), (8, 64, 1)])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_k4a_kernel_gqa_on_card(cuda, kind, h, dh, n_kv):
    """K4a on GQA/MQA caches: every query head of a KV group reads its
    KV head's lanes (one to eight query heads per KV head)."""
    _k4_on_card(cuda, kind, 1, b=48, t=37, seed=h * 100 + dh + n_kv, h=h, dh=dh, n_kv=n_kv)


@pytest.mark.cuda
def test_k4_kernels_gqa_contract_on_card(cuda):
    """Both kernels take GQA/MQA caches in exact dtypes, the grouped one
    too; int8 caches are MHA only and raise on GQA, as the JAX kernels
    assert."""
    q, n = torch.randn(6, 64, device=cuda), torch.full((2,), 8, dtype=torch.int32,
                                                        device=cuda)
    kv = torch.randn(2, 8, 16, device=cuda)
    got = attention.decode_attention_grouped(q, kv, kv, n, 4, 3)
    ref = attention.decode_attention_grouped_plain(q, kv, kv, n, 4, 3)
    torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-5)
    assert torch.equal(got[1], ref[1])
    i8, sc = kv.to(torch.int8), torch.ones(2, 64, device=cuda)
    with pytest.raises(ValueError, match="MHA only"):
        attention.decode_attention(q[:2], i8, i8, n, 4, sc, sc)
    with pytest.raises(ValueError, match="MHA only"):
        attention.decode_attention_grouped(q, i8, i8, n, 4, 3, sc, sc)


_ALL, _EXACT = ("float32", "bfloat16", "int8"), ("float32", "bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("kind,h,dh,n_kv", [
    (kind, h, dh, n_kv)
    for h, dh, n_kv, kinds in [(4, 8, 4, _ALL), (6, 64, 6, _ALL), (12, 64, 12, _ALL),
                               (16, 32, 1, _EXACT), (32, 16, 2, _EXACT)]
    for kind in kinds])
def test_k4a_kernel_wide_shapes_on_card(cuda, kind, h, dh, n_kv):
    """K4a at shapes the 16-byte row kernel took only in part or not at
    all: Dh 8 (the tiny config; int8 on the scalar kernel), D 384 and 768
    (rows of 48 or 96 16-byte loads), 16 query heads per KV head."""
    _k4_on_card(cuda, kind, 1, b=40, t=256, seed=h * 1000 + dh + n_kv, h=h, dh=dh,
                n_kv=None if n_kv == h else n_kv)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,group,h,dh,n_kv", [
    (kind, group, h, dh, n_kv)
    for group, h, dh, n_kv, kinds in [
        (9, 8, 32, 8, _ALL), (12, 8, 32, 8, _ALL), (16, 8, 32, 8, _ALL),
        (5, 8, 32, 1, _EXACT), (12, 8, 32, 1, _EXACT), (5, 8, 32, 2, _EXACT),
        (12, 8, 32, 2, _EXACT), (5, 4, 8, 4, _ALL), (5, 4, 24, 4, _ALL),
        (5, 16, 128, 16, _ALL)]
    for kind in kinds])
def test_k4b_kernel_wide_shapes_on_card(cuda, kind, group, h, dh, n_kv):
    """K4b at shapes the earlier kernel refused: groups over 8 (equal
    sub-groups of the grouped kernel), GQA/MQA caches, Dh 8 and 24, and D
    2048 (16 heads of 128; the scalar kernel)."""
    _k4_on_card(cuda, kind, group, b=24, t=37, seed=group * 100 + dh + n_kv, h=h, dh=dh,
                n_kv=None if n_kv == h else n_kv, tie_is_max=n_kv == h)


@pytest.mark.cuda
@pytest.mark.parametrize("kind,group,h,dh,n_kv,scalar", [
    ("bfloat16", 1, 8, 32, None, False),  # the MHA flagship's K4a: the row kernel
    ("int8", 1, 8, 32, None, False),
    ("int8", 1, 4, 8, None, True),        # int8 at Dh 8: no whole 16-byte load a head
    ("float32", 1, 16, 32, 1, True),      # 16 query heads per KV head
    ("bfloat16", 5, 8, 32, None, False),  # the MHA flagship's K4b: the grouped kernel
    ("float32", 5, 4, 8, None, True),     # the tiny config's K4b (Dh 8)
    ("bfloat16", 5, 8, 32, 2, True),      # GQA caches in K4b
])
def test_k4_kernel_route_on_card(cuda, kind, group, h, dh, n_kv, scalar):
    """Which kernel a shape runs, as the wrapper counts it: every call is
    one launch, and the scalar kernel's are counted apart."""
    fn = attention.decode_attention if group == 1 else attention.decode_attention_grouped
    launches, scalar_launches = fn.launches, fn.scalar_launches
    _k4_on_card(cuda, kind, group, b=24, t=37, seed=7, h=h, dh=dh, n_kv=n_kv,
                tie_is_max=n_kv is None)
    assert fn.launches == launches + 1
    assert fn.scalar_launches == scalar_launches + int(scalar)


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 5])
def test_k4_kernel_misaligned_cache_on_card(cuda, group):
    """Caches whose base is not 16-byte aligned (views one element into
    their storage) run the scalar kernel, counted as such, and match the
    plain version."""
    rng = np.random.default_rng(11)
    b, t, h = 24, 37, 8
    q, k, v, lens = _decode_inputs(rng, b, t, h, 32, group)

    def shifted(x):
        buf = torch.empty(x.size + 1, dtype=torch.bfloat16, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(_t(x))
        return view

    tq, tk, tv, n = _t(q).to(cuda, torch.bfloat16), shifted(k), shifted(v), _t(lens).to(cuda)
    assert tk.is_contiguous() and tk.data_ptr() % 16
    fn = attention.decode_attention if group == 1 else attention.decode_attention_grouped
    args = (tq, tk, tv, n, h) + ((group,) if group > 1 else ())
    plain = (attention.decode_attention_plain if group == 1
             else attention.decode_attention_grouped_plain)
    scalar_launches = fn.scalar_launches
    got = fn(*args)
    ref = plain(*args)
    torch.cuda.synchronize()
    assert fn.scalar_launches == scalar_launches + 1
    atol, rtol = K4_TOL["bfloat16"]
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
    assert (got[1] == ref[1]).float().mean() > 0.99


@pytest.mark.cuda
@pytest.mark.parametrize("kind,group", [("float32", 1), ("bfloat16", 1), ("int8", 1),
                                        ("float32", 3), ("bfloat16", 3)])
def test_k4_kernel_scores_beyond_shared_memory_on_card(cuda, kind, group):
    """32 heads at T 1800: one query row's H x T f32 scores (230 KB)
    overflow a block's shared memory.  The scalar kernel keeps them in a
    device-memory workspace and matches the plain version."""
    fn = attention.decode_attention if group == 1 else attention.decode_attention_grouped
    scalar_launches = fn.scalar_launches
    _k4_on_card(cuda, kind, group, b=4, t=1800, seed=31 + group, h=32, dh=32)
    assert fn.scalar_launches == scalar_launches + 1


@pytest.mark.cuda
@pytest.mark.parametrize("group", [1, 3])
@pytest.mark.parametrize("kind", ["float32", "bfloat16"])
def test_k4_kernel_gqa_scores_beyond_shared_memory_on_card(cuda, kind, group):
    """The same on GQA caches (32 query heads on 2 KV heads) at B 2, with
    a partial and a full row."""
    rng = np.random.default_rng(41 + group)
    b, t, h, dh, n_kv = 2, 1800, 32, 32, 2
    dt = getattr(torch, kind)
    q = torch.from_numpy(rng.normal(size=(b * group, h * dh)).astype(np.float32)).to(cuda, dt)
    k, v = (torch.from_numpy(rng.normal(size=(b, t, n_kv * dh)).astype(np.float32)).to(cuda, dt)
            for _ in range(2))
    n = torch.tensor([1000, t], dtype=torch.int32, device=cuda)
    fn = attention.decode_attention if group == 1 else attention.decode_attention_grouped
    plain = (attention.decode_attention_plain if group == 1
             else attention.decode_attention_grouped_plain)
    args = (q, k, v, n, h) + ((group,) if group > 1 else ())
    scalar_launches = fn.scalar_launches
    got, ref = fn(*args), plain(*args)
    torch.cuda.synchronize()
    assert fn.scalar_launches == scalar_launches + 1
    atol, rtol = K4_TOL[kind]
    torch.testing.assert_close(got[0].float(), ref[0].float(), atol=atol, rtol=rtol)
    assert torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_k5_k6_kernels_match_plain_on_card(cuda, dtype, atol):
    rng = np.random.default_rng(0)
    b, s, h, dh = 6, 256, 2, 128
    q, k, v = (_t(rng.normal(size=(b, s, h * dh)).astype(np.float32)).to(cuda, dtype)
               for _ in range(3))
    lens = _t(np.array([0, 1, 100, 256, 200, 37], np.int32)).to(cuda)
    got = encoder_attention.flash_encoder_attention_nld(q, k, v, lens, h)
    ref = encoder_attention.encoder_attention_nld_plain(q, k, v, lens, h)
    split = lambda x: x.reshape(b, s, h, dh)  # noqa: E731
    got6 = encoder_attention.flash_encoder_attention(split(q), split(k), split(v), lens)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=atol)
    assert torch.equal(got6.reshape(b, s, h * dh), got)
