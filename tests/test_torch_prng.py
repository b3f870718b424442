"""PyTorch port, `jax.random`: threefry2x32 keys (`nanodecoder_tpu_torch.prng`),
the draws of kernel R1 (`ops/threefry.py`: its plain version here), and
the keys the port threads through init and dropout, held against JAX 0.9
on the CPU:

  * keys (PRNGKey, split, fold_in), bits, uniform, bernoulli, dropout
    masks and dropout's values in float32 and bfloat16: exact;
  * normal: within 4 ulps (XLA's erf_inv polynomial evaluated in torch;
    the largest gap measured is 3 ulps, which the test prints);
  * gumbel: within 2e-6 absolute (the logs round apart);
  * categorical: exact wherever the winning draw leads the runner-up by
    more than 1e-5, which the test asserts;
  * init_model: glorot-drawn arrays bit-equal, normal-drawn ones (the
    target embedding) within 4 ulps;
  * encode and decode_teacher_forced with train=True at dropout 0.1 and
    one key: within 1e-5.

`tests/golden/jax_prng.npz` (scripts/make_prng_fixture.py) holds JAX's
draws for the card, which has no JAX; the tests here hold it to JAX and
to the port.  JAX is imported inside the tests that compare with it, so
the tests marked `cuda` (R1 against its plain version) also run where JAX
is absent:

    python -m pytest tests/test_torch_prng.py -m cuda --noconftest
"""

import dataclasses
import importlib.util
import math
import os

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.ops.threefry import (keys_from_table, threefry_draw,
                                                threefry_draw_plain, threefry_draw_table,
                                                threefry_draw_table_plain)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(REPO, "tests", "golden", "jax_prng.npz")
NORMAL_ULPS = 4
GUMBEL_ATOL = 2e-6
LEAD = 1e-5
OFFSET = 2**32 - 3


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """Small ops run fastest on one thread, and far faster than on eight
    when the suite's other workers hold the cores; restored after."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _jax():
    import jax

    jax.config.update("jax_platforms", "cpu")
    return jax


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    """The largest distance in float32 units in the last place (same-sign
    values: the bit patterns as integers)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    assert (np.signbit(a) == np.signbit(b))[a != b].all()
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


def _jax_bits_at(key, n: int, offset: int) -> np.ndarray:
    """JAX's threefry2x32 primitive over the counters offset .. offset+n-1
    (jax.random itself draws from counter 0), XORed as random_bits does."""
    jax = _jax()
    import jax.numpy as jnp
    from jax._src import prng as jprng

    i = np.arange(n, dtype=np.uint64) + np.uint64(offset)
    hi = jnp.asarray((i >> np.uint64(32)).astype(np.uint32))
    lo = jnp.asarray((i & np.uint64(0xFFFFFFFF)).astype(np.uint32))
    words = jnp.asarray(key, jnp.uint32)
    b1, b2 = jprng.threefry2x32_p.bind(words[0], words[1], hi, lo)
    return np.asarray(jax.device_get(b1 ^ b2))


# --- keys ---------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, 2**31, 2**32 + 5, -1])
def test_prng_key_matches_jax(seed):
    jax = _jax()
    got = prng.PRNGKey(seed)
    assert got.dtype == np.uint32 and got.shape == (2,)
    np.testing.assert_array_equal(got, np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("num", [2, 3, 4, 16])
def test_split_matches_jax(num):
    jax = _jax()
    for seed in (0, 42):
        np.testing.assert_array_equal(prng.split(prng.PRNGKey(seed), num),
                                      np.asarray(jax.random.split(
                                          jax.random.PRNGKey(seed), num)))
    k1, k2 = prng.split(prng.PRNGKey(0))  # unpacks as JAX's does
    np.testing.assert_array_equal(k2, np.asarray(jax.random.split(jax.random.PRNGKey(0))[1]))
    assert k1.shape == (2,)


@pytest.mark.parametrize("data", [0, 7, 2**32 - 1])
def test_fold_in_matches_jax_and_refuses_beyond_uint32(data):
    jax = _jax()
    for seed in (0, 42):
        np.testing.assert_array_equal(prng.fold_in(prng.PRNGKey(seed), data),
                                      np.asarray(jax.random.fold_in(
                                          jax.random.PRNGKey(seed), data)))
    for bad in (-1, 2**32):
        with pytest.raises(OverflowError):
            jax.random.fold_in(jax.random.PRNGKey(0), bad)
        with pytest.raises(OverflowError):
            prng.fold_in(prng.PRNGKey(0), bad)


# --- bits and uniform -----------------------------------------------------------


@pytest.mark.parametrize("offset", [0, OFFSET], ids=["from_0", "past_2^32"])
@pytest.mark.parametrize("shape", [(), (1,), (7,), (3, 5, 11)])
def test_bits_and_uniform_match_jax(shape, offset):
    """Bits exact; uniform on [0, 1) exact.  From counter 0 against
    jax.random.bits / uniform; from 2^32 - 3 (the counter's high word
    turns 1 inside the draw) against JAX's threefry primitive there, and
    the uniform against jax/_src/random.py's transform of those bits,
    ((bits >> 9) | the bits of 1.0) - 1 (the fixture test holds JAX's own
    transform at an offset)."""
    jax = _jax()
    key = prng.PRNGKey(42)
    bits = prng.bits(key, shape, device="cpu", offset=offset)
    assert bits.shape == shape and bits.dtype == torch.int32
    u = prng.uniform(key, shape, device="cpu", offset=offset)
    assert u.shape == shape and u.dtype == torch.float32
    n = math.prod(shape)
    if offset == 0:
        jkey = jax.random.PRNGKey(42)
        want_bits = np.asarray(jax.random.bits(jkey, shape))
        want_u = np.asarray(jax.random.uniform(jkey, shape))
    else:
        want_bits = _jax_bits_at(key, n, offset).reshape(shape)
        f = ((want_bits >> np.uint32(9)) | np.uint32(0x3F800000)).view(np.float32)
        want_u = (f - np.float32(1.0)).astype(np.float32)
    np.testing.assert_array_equal(bits.numpy().view(np.uint32), want_bits)
    np.testing.assert_array_equal(u.numpy(), want_u)


@pytest.mark.parametrize("lo,hi", [(-math.sqrt(6 / 288), math.sqrt(6 / 288)),
                                   (-math.sqrt(6 / 1280), math.sqrt(6 / 1280)),
                                   (-math.sqrt(6 / 6), math.sqrt(6 / 6)),
                                   (float(np.finfo(np.float32).tiny), 1.0)],
                         ids=["glorot_32x256", "glorot_256x1024", "glorot_5x1", "tiny_1"])
def test_uniform_at_glorot_scales_and_gumbel_range_matches_jax(lo, hi):
    """uniform(lo, hi) bit-equal to JAX's, whose multiply-add XLA compiles
    as one fused multiply-add: rounding the product first would miss about
    half the values at these scales."""
    jax = _jax()
    got = prng.uniform(prng.PRNGKey(3), (4099,), lo, hi, device="cpu").numpy()
    want = np.asarray(jax.random.uniform(jax.random.PRNGKey(3), (4099,), minval=lo,
                                         maxval=hi))
    np.testing.assert_array_equal(got, want)
    assert got.min() >= np.float32(lo) and got.max() < np.float32(hi)


@pytest.mark.parametrize("shape", [(4099,), (4, 33, 32)])
def test_bernoulli_matches_jax(shape):
    jax = _jax()
    got = prng.bernoulli(prng.PRNGKey(9), 0.9, shape, device="cpu")
    assert got.dtype == torch.bool
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jax.random.bernoulli(jax.random.PRNGKey(9), 0.9, shape)))


# --- normal, gumbel, categorical ---------------------------------------------------


def test_normal_within_4_ulps_of_jax():
    jax = _jax()
    n = 1 << 16
    got = prng.normal(prng.PRNGKey(0), (n,), device="cpu").numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(0), (n,)))
    ulps = _ulps(got, want)
    print(f"normal: {np.mean(got != want):.4f} of {n} draws differ, at most {ulps} ulps")
    assert ulps <= NORMAL_ULPS
    # torch.erfinv is another function: far from JAX's.
    lo = float(np.nextafter(np.float32(-1), np.float32(0)))
    u = prng.uniform(prng.PRNGKey(0), (n,), lo, 1.0, device="cpu")
    assert _ulps(float(np.float32(math.sqrt(2))) * torch.erfinv(u).numpy(), want) > 16


def test_gumbel_within_2e6_of_jax():
    jax = _jax()
    n = 1 << 16
    got = prng.gumbel(prng.PRNGKey(1), (n,), device="cpu").numpy()
    want = np.asarray(jax.random.gumbel(jax.random.PRNGKey(1), (n,)))
    gap = float(np.abs(got - want).max())
    print(f"gumbel: largest gap {gap:.3g} over {n} draws")
    assert gap <= GUMBEL_ATOL and np.isfinite(got).all()


def _lead(noisy: np.ndarray) -> float:
    top2 = np.sort(noisy, axis=-1)[..., -2:]
    return float((top2[..., 1] - top2[..., 0]).min())


def test_categorical_matches_jax():
    """(8, 5) logits, several keys: the port's draws equal JAX's; every
    winning draw leads by more than 1e-5; rows taken at their place in a
    larger batch (row0) draw what that batch draws for them."""
    jax = _jax()
    logits = np.random.default_rng(0).normal(size=(8, 5)).astype(np.float32)
    for seed in range(4):
        key = prng.PRNGKey(seed)
        got = prng.categorical(key, torch.from_numpy(logits)).numpy()
        want = np.asarray(jax.random.categorical(jax.random.PRNGKey(seed), logits))
        np.testing.assert_array_equal(got, want)
        noise = prng.gumbel(key, logits.shape, device="cpu").numpy()
        assert _lead(noise + logits) > LEAD
        tail = prng.categorical(key, torch.from_numpy(logits[3:]), row0=3).numpy()
        np.testing.assert_array_equal(tail, want[3:])
    ties = np.zeros((64, 3), np.float32)  # equal logits: the lowest index on noise ties
    assert set(prng.categorical(prng.PRNGKey(5), torch.from_numpy(ties)).tolist()) \
        == {0, 1, 2}


# --- the fixture for the card --------------------------------------------------------


def _fixture_script():
    spec = importlib.util.spec_from_file_location(
        "make_prng_fixture", os.path.join(REPO, "scripts", "make_prng_fixture.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def test_fixture_is_jax_and_the_port_draws_it():
    """tests/golden/jax_prng.npz equals what its script makes now, and the
    port's plain draws give it: bits, uniform and masks exact, normal and
    gumbel at the tolerances, from counter 0 and past 2^32."""
    script = _fixture_script()
    with np.load(FIXTURE) as f:
        saved = {k: f[k] for k in f.files}
    made = script.fixture()
    assert saved.keys() == made.keys()
    for k in saved:
        np.testing.assert_array_equal(saved[k], made[k], err_msg=k)
    key, off = saved["key"], int(saved["offset"])
    assert off < 2**32 < off + script.N1
    for pre, offset, n in (("", 0, script.N0), ("off_", off, script.N1)):
        draw = dict(device="cpu", offset=offset)
        np.testing.assert_array_equal(
            prng.bits(key, (n,), **draw).numpy().view(np.uint32), saved[pre + "bits"])
        np.testing.assert_array_equal(
            prng.uniform(key, (n,), script.GLOROT_LO, -script.GLOROT_LO, **draw).numpy(),
            saved[pre + "uniform"])
        np.testing.assert_array_equal(prng.bernoulli(key, script.P, (n,), **draw).numpy(),
                                      saved[pre + "bernoulli"])
        assert _ulps(prng.normal(key, (n,), **draw).numpy(),
                     saved[pre + "normal"]) <= NORMAL_ULPS
        assert np.abs(prng.gumbel(key, (n,), **draw).numpy()
                      - saved[pre + "gumbel"]).max() <= GUMBEL_ATOL


# --- init and dropout ---------------------------------------------------------------

INIT_CASES = {
    "transformer": {},
    "lean_mha": {"dec_kv_heads": 0, "lean_step": True},
    "gqa": {"dec_kv_heads": 2},
    "rnn": {"encoder_type": "lstm", "decoder_type": "rnn"},
    "hybrid_transformer_rnn": {"decoder_type": "rnn", "rnn_attention": "mlp"},
    "hybrid_lstm_transformer": {"encoder_type": "lstm", "dec_kv_heads": 1},
}


def _flat(params) -> dict:
    jax = _jax()
    return {"/".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in kp):
            np.asarray(leaf)
            for kp, leaf in jax.tree_util.tree_flatten_with_path(params)[0]}


def _cfgs(model: dict):
    from nanodecoder_tpu.config import tiny_test_config as jax_tiny
    from nanodecoder_tpu_torch.config import tiny_test_config

    jcfg, cfg = jax_tiny(), tiny_test_config()
    return (dataclasses.replace(jcfg, model=dataclasses.replace(jcfg.model, **model)),
            dataclasses.replace(cfg, model=dataclasses.replace(cfg.model, **model)))


@pytest.mark.parametrize("name", list(INIT_CASES))
def test_init_model_matches_jax(name):
    """The port's init_model(PRNGKey(s)) against the JAX package's
    init_model(jax.random.PRNGKey(s)): every glorot array bit-equal, the
    embedding table (normal) within 4 ulps."""
    jax = _jax()
    from nanodecoder_tpu.models.model import init_model as jinit
    from nanodecoder_tpu_torch.models.model import init_model
    from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy

    jcfg, cfg = _cfgs(INIT_CASES[name])
    want = _flat(jinit(jax.random.PRNGKey(5), jcfg.model))
    got = params_to_numpy(init_model(prng.PRNGKey(5), cfg.model))
    assert got.keys() == want.keys()
    for k in want:
        if k == "tgt_embed/table":
            assert _ulps(got[k], want[k]) <= NORMAL_ULPS, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _teacher_forced(train_over: dict):
    """(JAX config, port config, JAX params, port params (theirs, carried
    over), a batch) at the tiny config with dropout 0.1."""
    jax = _jax()
    from nanodecoder_tpu.models.model import init_model as jinit
    from nanodecoder_tpu.train.data import synthetic_batches
    from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy

    jcfg, cfg = _cfgs({"dropout": 0.1, **train_over})
    jp = jinit(jax.random.PRNGKey(0), jcfg.model)
    params = params_from_numpy(_flat(jp), cfg.model, "cpu")
    batch = next(synthetic_batches(jcfg, seed=2, accum_axis=False))
    return jcfg, cfg, jp, params, batch


@pytest.mark.parametrize("kv_heads", [1, 0], ids=["mqa", "mha"])
def test_teacher_forced_pass_with_dropout_matches_jax(kv_heads):
    """encode and decode_teacher_forced with train=True, dropout 0.1 and
    one key on both sides (as the JAX trainer passes them): memory and
    log-probs within 1e-5, and apart from the dropout-free pass."""
    jax = _jax()
    import jax.numpy as jnp
    from nanodecoder_tpu.models import model as jm
    from nanodecoder_tpu_torch.models import model as tm

    jcfg, cfg, jp, params, b = _teacher_forced({"dec_kv_heads": kv_heads})
    jb = {k: jnp.asarray(v) for k, v in b.items()}
    jkey = jax.random.PRNGKey(17)
    jmem, jml = jm.encode(jp, jcfg.model, jb["signal"], jb["sig_lengths"], jkey, True)
    jlp, _ = jm.decode_teacher_forced(jp, jcfg.model, jb["tgt_in"], jmem, jml, jkey, True)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    key = prng.PRNGKey(17)
    with torch.no_grad():
        mem, ml = tm.encode(params, cfg.model, tb["signal"], tb["sig_lengths"], key, True)
        lp, _ = tm.decode_teacher_forced(params, cfg.model, tb["tgt_in"], mem, ml, key, True)
        plain, _ = tm.encode(params, cfg.model, tb["signal"], tb["sig_lengths"])
    np.testing.assert_allclose(mem.numpy(), np.asarray(jmem), atol=1e-5, rtol=0)
    np.testing.assert_allclose(lp.numpy(), np.asarray(jlp), atol=1e-5, rtol=0)
    assert np.abs(mem.numpy() - plain.numpy()).max() > 1e-2


def test_encoder_draws_one_mask_for_the_attention_output_and_its_residual(monkeypatch):
    """The JAX encoder passes one key (r1) to mha's dropout of the (B, T, H,
    Dh) attention output and to the residual's of the (B, T, D) branch:
    one flat count and row length, so the two masks are equal (shown with
    JAX) and the port draws it once: three draws a layer, not four; a
    rank's rows of a mask are the rows of the global mask."""
    jax = _jax()
    from nanodecoder_tpu_torch.models import model as tm
    from nanodecoder_tpu_torch.models import modules as tnn

    k = jax.random.PRNGKey(3)
    heads = np.asarray(jax.random.bernoulli(k, 0.9, (4, 33, 4, 8))).reshape(4, 33, 32)
    np.testing.assert_array_equal(heads, np.asarray(jax.random.bernoulli(k, 0.9, (4, 33, 32))))
    whole = np.asarray(jax.random.bernoulli(k, 0.9, (4, 33, 32)))
    rows = tnn.dropout_mask(prng.PRNGKey(3), 0.1, (2, 33, 32), "cpu", row0=2)
    np.testing.assert_array_equal(rows.numpy(), whole[2:])

    jcfg, cfg, _jp, params, b = _teacher_forced({})
    draws = []
    real = prng.bernoulli

    def counted(*args, **kw):
        draws.append(args[2])
        return real(*args, **kw)
    monkeypatch.setattr(prng, "bernoulli", counted)
    tb = {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}
    with torch.no_grad():
        tm.encode(params, cfg.model, tb["signal"], tb["sig_lengths"], prng.PRNGKey(1), True)
    assert len(draws) == 3 * cfg.model.enc_layers
    assert [tuple(s)[-1] for s in draws[:3]] == [32, 64, 32]



def _sass(kind: int, body: list[str]) -> str:
    """A cuobjdump -sass listing of R1's instance `kind` holding `body`."""
    lines = [f"\t\tFunction : _ZN12_GLOBAL__N_115threefry_kernelILi{kind}EEEvPvxjjyfff"]
    for i, ins in enumerate(body + ["BRA 0x1;", "NOP ;", "NOP ;"]):
        lines += [f"        /*{16 * i:04x}*/                   {ins} /* 0x0 */",
                  "                                              /* 0x0 */"]
    return "\n".join(lines) + "\n"


def test_r1_bound_counts_the_built_kernels_pipes():
    """chip_smoke.py's bound of R1 reads the kernel's SASS: every
    instruction up to the last EXIT (the trailing branch and NOPs out), on
    the ALU (64 lanes an SM), the IMAD half of the FMA pipe (64), the FMA
    pipe (128) and the issue slots (128); the busiest sets the bound.  A
    branch before the last EXIT is refused."""
    import chip_smoke

    head = ["S2R R2, SR_TID.X ;", "ISETP.GE.U32.AND P0, PT, R2, UR4, PT ;", "@P0 EXIT ;"]
    hash_ = ["IADD3 R0, R7, R4, R6 ;", "SHF.L.W.U32.HI R7, R7, 0xd, R7 ;",
             "LOP3.LUT R7, R7, R0, RZ, 0x3c, !PT ;", "IMAD.IADD R0, R0, 0x1, R7 ;"] * 8
    tails = {0: ["STG.E [R2.64], R7 ;"],
             1: ["FADD R7, R7, -1 ;", "FFMA R7, R7, R6, R5 ;", "FMNMX R7, R7, R5, !PT ;",
                 "STG.E [R2.64], R7 ;"],
             2: ["FADD R7, R7, -1 ;", "FSETP.GEU.AND P0, PT, R7, R6, PT ;",
                 "SEL R7, RZ, 0x1, P0 ;", "STG.E.U8 [R2.64], R7 ;"]}
    text = "".join(_sass(k, head + hash_ + tail + ["EXIT ;"]) for k, tail in tails.items())
    got = chip_smoke.r1_sass_pipes(text)
    assert got == {"bits": {"alu": 25, "imad": 8, "fma": 8, "issue": 37},
                   "uniform": {"alu": 26, "imad": 8, "fma": 10, "issue": 40},
                   "bernoulli": {"alu": 27, "imad": 8, "fma": 9, "issue": 40}}
    n, sm_per_s = 1 << 20, 132 * 1.98e9
    ms, by = chip_smoke.r1_bound(n, "bernoulli", got, sm_per_s)
    assert by == "operations" and ms == pytest.approx(n * 27 / 64 / sm_per_s * 1e3)
    with pytest.raises(chip_smoke.SmokeError, match="branches"):
        chip_smoke.r1_sass_pipes(_sass(0, head + ["BRA 0x40 ;"] + hash_ + ["EXIT ;"]))


@pytest.mark.parametrize("rate", [0.1, 0.3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dropout_values_match_jax_jitted(dtype, rate):
    """The JAX package's dropout, jitted as the train step runs it, against
    the port's on one key and input: equal values in float32 and in
    bfloat16, where JAX's weakly typed keep rounds to bfloat16 before XLA
    multiplies by its reciprocal."""
    jax = _jax()
    import jax.numpy as jnp
    from nanodecoder_tpu.models import modules as jnn
    from nanodecoder_tpu_torch.models import modules as tnn

    x = np.random.default_rng(4).standard_normal((4, 33, 32)).astype(np.float32)
    jx = jnp.asarray(x, dtype=dtype)
    want = np.asarray(jax.jit(lambda v: jnn.dropout(v, rate, jax.random.PRNGKey(9), True))(jx))
    tx = torch.from_numpy(np.asarray(jx).astype(np.float32)).to(getattr(torch, dtype))
    got = tnn.dropout(tx, rate, prng.PRNGKey(9), True)
    assert got.dtype == tx.dtype
    np.testing.assert_array_equal(got.float().numpy(), want.astype(np.float32))


TABLE_KEYS = np.array([[0, 7], [0xDEADBEEF, 0x80000001], [0xFFFFFFFF, 0]], np.uint32)
DRAW_KW = {"bits": {}, "uniform": {"lo": -0.0684, "hi": 0.0684}, "bernoulli": {"p": 0.9}}


@pytest.mark.parametrize("kind", ["bits", "uniform", "bernoulli"])
@pytest.mark.parametrize("offset", [0, OFFSET], ids=["from_0", "past_2^32"])
def test_table_keyed_plain_twin_equals_the_scalar_keyed_plain(kind, offset):
    """R1's table-keyed plain version (the key words read as tensors from a
    row of an int32 key table, words past 2^31 included) equals the plain
    version under the same key, for every kind, and so does the launcher
    on the CPU."""
    table = torch.from_numpy(TABLE_KEYS.view(np.int32).copy())
    n = 1000 + 3
    for row, key in enumerate(TABLE_KEYS):
        want = threefry_draw_plain(key, n, kind, offset=offset, **DRAW_KW[kind])
        got = threefry_draw_table_plain(table, row, n, kind, offset=offset, **DRAW_KW[kind])
        assert got.dtype == want.dtype and torch.equal(got, want), row
        assert torch.equal(threefry_draw_table(table, row, n, kind, offset=offset,
                                               **DRAW_KW[kind]), want)
    with pytest.raises(IndexError):
        threefry_draw_table(table, 3, n, kind)
    with pytest.raises(ValueError, match="key table"):
        threefry_draw_table(table.long(), 0, n, kind)


# --- R1 on the card --------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "uniform", "bernoulli"])
@pytest.mark.parametrize("offset", [0, OFFSET], ids=["from_0", "past_2^32"])
def test_threefry_kernel_matches_plain_on_card(cuda, kind, offset):
    """R1 against its plain version on the card and on the CPU, exact, at
    2^20 + 3 draws (a ragged last block) and at the counter offset."""
    n = (1 << 20) + 3
    kw = {"uniform": {"lo": -0.0684, "hi": 0.0684}, "bernoulli": {"p": 0.9}}.get(kind, {})
    before = threefry_draw.launches
    got = threefry_draw(prng.PRNGKey(42), n, kind, offset=offset, device=cuda, **kw)
    plain = threefry_draw_plain(prng.PRNGKey(42), n, kind, offset=offset, device=cuda, **kw)
    torch.cuda.synchronize()
    assert threefry_draw.launches == before + 1
    assert torch.equal(got, plain)
    assert torch.equal(got.cpu(), threefry_draw_plain(prng.PRNGKey(42), n, kind,
                                                      offset=offset, **kw))


@pytest.mark.cuda
def test_threefry_kernel_matches_the_jax_fixture_on_card(cuda):
    """R1's draws on the card against JAX's in the committed fixture:
    bits, uniform and masks exact, normal within 4 ulps, gumbel within
    2e-6, from counter 0 and past 2^32."""
    with np.load(FIXTURE) as f:
        saved = {k: f[k] for k in f.files}
    key, off = saved["key"], int(saved["offset"])
    lim = -math.sqrt(6.0 / (256 + 1024))  # the fixture's GLOROT_LO
    for pre, offset in (("", 0), ("off_", off)):
        n = len(saved[pre + "bits"])
        draw = dict(device=cuda, offset=offset)
        assert np.array_equal(prng.bits(key, (n,), **draw).cpu().numpy().view(np.uint32),
                              saved[pre + "bits"])
        assert np.array_equal(prng.uniform(key, (n,), lim, -lim, **draw).cpu().numpy(),
                              saved[pre + "uniform"])
        assert np.array_equal(prng.bernoulli(key, 0.9, (n,), **draw).cpu().numpy(),
                              saved[pre + "bernoulli"])
        assert _ulps(prng.normal(key, (n,), **draw).cpu().numpy(),
                     saved[pre + "normal"]) <= NORMAL_ULPS
        assert np.abs(prng.gumbel(key, (n,), **draw).cpu().numpy()
                      - saved[pre + "gumbel"]).max() <= GUMBEL_ATOL


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["bits", "uniform", "bernoulli"])
def test_table_keyed_kernel_matches_the_scalar_kernel_on_card(cuda, kind):
    """R1's table-keyed kernel under each row of a key table equals the
    scalar-keyed kernel under that key; inside `keys_from_table`, draws
    captured in a CUDA graph take the table's rows in turn, collect the
    keys they were handed, and draw under whatever the table holds when
    the graph is replayed."""
    n = (1 << 20) + 3
    kw = DRAW_KW[kind]
    table = torch.from_numpy(TABLE_KEYS.view(np.int32).copy()).to(cuda)
    for row, key in enumerate(TABLE_KEYS):
        got = threefry_draw_table(table, row, n, kind, offset=OFFSET, **kw)
        assert torch.equal(got, threefry_draw(key, n, kind, offset=OFFSET, device=cuda, **kw))
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with keys_from_table(table) as handed:
        with torch.cuda.graph(graph, stream=stream):
            outs = [threefry_draw(prng.PRNGKey(i), n, kind, device=cuda, **kw) for i in range(2)]
    assert handed == [(0, 0), (0, 1)]
    for keys in (TABLE_KEYS, TABLE_KEYS[::-1].copy()):
        table.copy_(torch.from_numpy(keys.view(np.int32).copy()))
        graph.replay()
        for row, out in enumerate(outs):
            assert torch.equal(out, threefry_draw(keys[row], n, kind, device=cuda, **kw))
