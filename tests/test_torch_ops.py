"""PyTorch port, kernels K1 (encoder attention) and K2 (cache block write),
and the card's tests of K3 (beam advance) and K7 (beam top-k), whose
CPU tests against the JAX package are in test_torch_beam.py.

On the CPU the wrappers run their plain PyTorch versions, which are held
against the JAX kernels in interpret mode.  The tests marked `cuda` hold
the CUDA kernels against the plain versions on the card and skip where
there is none.  This file imports JAX only inside the tests that compare
with it, so the card's tests also run where JAX is absent:

    python -m pytest tests/test_torch_ops.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from nanodecoder_tpu_torch.ops import beam_step, cache_update, encoder_attention


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _qkv(rng, b, s, h, dh):
    qkv = rng.normal(size=(b, s, 3 * h * dh)).astype(np.float32)
    lens = rng.integers(1, s + 1, size=b).astype(np.int32)
    lens[0] = 0          # a batch-padding row
    lens[-1] = s         # a full row
    return qkv, lens


@pytest.mark.parametrize("b,s,h,dh", [(3, 16, 2, 32), (4, 40, 2, 64), (2, 24, 1, 128)])
def test_k1_plain_matches_jax_interpret(b, s, h, dh, rng_np):
    import jax.numpy as jnp
    from nanodecoder_tpu.ops.encoder_attention import flash_encoder_attention_qkv

    qkv, lens = _qkv(rng_np, b, s, h, dh)
    ref = np.asarray(flash_encoder_attention_qkv(
        jnp.asarray(qkv), jnp.asarray(lens), h, interpret=True))
    before = encoder_attention.flash_encoder_attention_qkv.launches
    got = encoder_attention.flash_encoder_attention_qkv(
        torch.from_numpy(qkv), torch.from_numpy(lens), h)
    # The CPU path is the plain version and launches nothing.
    assert encoder_attention.flash_encoder_attention_qkv.launches == before
    assert got.shape == (b, s, h * dh) and got.dtype == torch.float32
    assert np.isfinite(got.numpy()).all()
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5, rtol=1e-5)
    # The length-0 row attends uniformly: every query row is the mean of V.
    v_mean = qkv[0, :, 2 * h * dh:].mean(axis=0)
    np.testing.assert_allclose(got.numpy()[0], np.broadcast_to(v_mean, got.shape[1:]),
                               atol=1e-5)


def test_k1_wrapper_rejects_bad_inputs():
    f = encoder_attention.flash_encoder_attention_qkv
    lens = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        f(torch.zeros(2, 8, 100), lens, 2)          # 3D not divisible
    with pytest.raises(ValueError):
        f(torch.zeros(2, 8, 96), torch.zeros(3, dtype=torch.int32), 2)
    with pytest.raises(ValueError):
        f(torch.zeros(2, 8, 96, device="meta"), lens.to("meta"), 2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_k2_plain_matches_jax_interpret(dtype, rng_np):
    import jax.numpy as jnp
    from nanodecoder_tpu.ops.cache_update import write_cache_block as jax_write

    b, t, c = 3, 24, 256
    cache = rng_np.normal(size=(b, t, c)).astype(np.float32)
    tc = torch.from_numpy(cache).to(getattr(torch, dtype))
    jc = jnp.asarray(cache).astype(dtype)
    for step in (0, 5, 8, 17, 23):
        slab = rng_np.normal(size=(b, cache_update.BLOCK, c)).astype(np.float32)
        ts = torch.from_numpy(slab).to(tc.dtype)
        before = cache_update.write_cache_block.launches
        tc = cache_update.write_cache_block(tc, ts, step)
        assert cache_update.write_cache_block.launches == before
        jc = jax_write(jc, jnp.asarray(slab).astype(dtype), jnp.int32(step),
                       interpret=True)
        got = tc.to(torch.float32).numpy()
        assert got.tobytes() == np.asarray(jc.astype(jnp.float32)).tobytes(), step


def test_k2_wrapper_contract():
    f = cache_update.write_cache_block
    cache = torch.zeros(2, 16, 4)
    with pytest.raises(ValueError):
        f(torch.zeros(2, 12, 4), torch.zeros(2, 8, 4), 0)   # T % 8 != 0
    with pytest.raises(ValueError):
        f(cache, torch.zeros(2, 8, 4), 16)                   # step out of range
    with pytest.raises(TypeError):
        f(cache, torch.zeros(2, 8, 4, dtype=torch.bfloat16), 0)
    out = f(cache, torch.ones(2, 8, 4), 9)
    assert out[:, 8:].eq(1).all() and out[:, :8].eq(0).all()
    assert cache.eq(0).all()  # the plain version writes into a clone


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [(torch.float32, 1e-5), (torch.bfloat16, 3e-2)])
def test_k1_kernel_matches_plain_on_card(cuda, dtype, atol):
    qkv, lens = _qkv(np.random.default_rng(0), 6, 256, 2, 128)
    q = torch.from_numpy(qkv).to(cuda, dtype)
    n = torch.from_numpy(lens).to(cuda)
    got = encoder_attention.flash_encoder_attention_qkv(q, n, 2)
    ref = encoder_attention.encoder_attention_plain(q, n, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=ENC_TOL[dtype][1])


# Kernel-vs-plain tolerances on the card (atol, rtol), as chip_smoke.py
# states them: f32 sums in another order; bf16 one rounding step of an
# output or of a probability at a rounding boundary.
ENC_TOL = {torch.float32: (1e-5, 1e-5), torch.bfloat16: (3e-2, 2e-2)}
_F32_BF16 = (torch.float32, torch.bfloat16)


@pytest.mark.cuda
@pytest.mark.parametrize("s", [1, 40, 63, 64, 65, 256, 300])
@pytest.mark.parametrize("heads", [1, 2, 8])
@pytest.mark.parametrize("dh", [32, 64, 128])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_encoder_attention_layouts_on_card(cuda, dtype, dh, heads, s):
    """K1 (QKV slab), K5 (separate q/k/v) and K6 ((B, S, H, Dh)) against
    their plain versions, with lengths 0 (uniform), 1, the 64-key tile
    edges 63, 64, 65 and S, each clipped to S."""
    _encoder_layouts_on_card(cuda, dtype, dh, heads, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dh,heads,s", [
    (dtype, dh, heads, s)
    for dh, heads, s, dtypes in [
        (8, 4, 256, _F32_BF16), (16, 2, 256, _F32_BF16), (48, 2, 256, _F32_BF16),
        (96, 2, 256, _F32_BF16), (256, 1, 256, _F32_BF16), (256, 2, 300, _F32_BF16),
        (128, 2, 2048, (torch.float32,)), (128, 2, 4096, (torch.float32,))]
    for dtype in dtypes])
def test_encoder_attention_wide_on_card(cuda, dtype, dh, heads, s):
    """The layouts at head dims without an instantiation (padded with zero
    lanes to the next one), at Dh 256, and in f32 at S beyond the score
    strip (the two-pass kernel), lengths as above."""
    _encoder_layouts_on_card(cuda, dtype, dh, heads, s)


@pytest.mark.cuda
@pytest.mark.parametrize("dh", [320, 512])
@pytest.mark.parametrize("dtype", _F32_BF16)
def test_encoder_attention_head_dims_over_256_on_card(cuda, dtype, dh):
    """The layouts at head dims over 256 (the scalar kernel, Dh in
    slices), B 2, S 256, 2 heads, a length-0 and a partial row; every
    launch runs the scalar kernel."""
    ea = encoder_attention
    fns = (ea.flash_encoder_attention_qkv, ea.flash_encoder_attention_nld,
           ea.flash_encoder_attention)
    before = [(f.launches, f.scalar_launches) for f in fns]
    _encoder_layouts_on_card(cuda, dtype, dh, 2, 256, lengths=[0, 130])
    assert [(f.launches, f.scalar_launches) for f in fns] == \
        [(n + 1, m + 1) for n, m in before]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", _F32_BF16)
def test_encoder_attention_unaligned_view_on_card(cuda, dtype):
    """Operands one element into their storage (contiguous, not 16-byte
    aligned) run the scalar kernel and match the plain version; the same
    values in aligned storage run the fast kernel."""
    ea = encoder_attention
    qkv, lens = _qkv(np.random.default_rng(5), 4, 100, 2, 64)

    def shifted(x):
        buf = torch.empty(x.numel() + 1, dtype=dtype, device=cuda)
        view = buf[1:].view(x.shape)
        view.copy_(x)
        return view

    aligned = torch.from_numpy(qkv).to(cuda, dtype)
    d = aligned.shape[2] // 3
    x = shifted(aligned)
    q, k, v = (shifted(aligned[..., i * d:(i + 1) * d].contiguous()) for i in range(3))
    assert x.is_contiguous() and x.data_ptr() % 16 and q.data_ptr() % 16
    n = torch.from_numpy(lens).to(cuda)
    f1, f5 = ea.flash_encoder_attention_qkv, ea.flash_encoder_attention_nld
    before = (f1.scalar_launches, f5.scalar_launches)
    got1, got5 = f1(x, n, 2), f5(q, k, v, n, 2)
    assert (f1.scalar_launches, f5.scalar_launches) == (before[0] + 1, before[1] + 1)
    fast = f1(aligned, n, 2)
    assert f1.scalar_launches == before[0] + 1
    ref1 = ea.encoder_attention_plain(x, n, 2)
    ref5 = ea.encoder_attention_nld_plain(q, k, v, n, 2)
    torch.cuda.synchronize()
    atol, rtol = ENC_TOL[dtype]
    for got, ref in ((got1, ref1), (got5, ref5), (fast, ref1)):
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol)


@pytest.mark.cuda
def test_encoder_attention_batch_over_65535_on_card(cuda):
    """B 65540 (past grid z's 65535) at S 32, 1 head of 32, f32: the fast
    kernel loops over batch rows, every row against the plain version."""
    ea = encoder_attention
    b, s, d = 65540, 32, 32
    gen = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(b, s, 3 * d, device=cuda, generator=gen)
    n = torch.randint(0, s + 1, (b,), device=cuda, generator=gen, dtype=torch.int32)
    before = ea.flash_encoder_attention_qkv.scalar_launches
    got = ea.flash_encoder_attention_qkv(x, n, 1)
    ref = ea.encoder_attention_plain(x, n, 1)
    torch.cuda.synchronize()
    assert ea.flash_encoder_attention_qkv.scalar_launches == before
    torch.testing.assert_close(got, ref, atol=1e-5, rtol=1e-5)


def _encoder_layouts_on_card(cuda, dtype, dh, heads, s, lengths=(0, 1, 63, 64, 65)):
    ea = encoder_attention
    lengths = np.minimum(list(lengths) + [s], s).astype(np.int32)
    b, d = len(lengths), heads * dh
    rng = np.random.default_rng(1000 * s + 10 * dh + heads)
    x = torch.from_numpy(rng.normal(size=(b, s, 3 * d)).astype(np.float32)).to(cuda, dtype)
    n = torch.from_numpy(lengths).to(cuda)
    q, k, v = (x[..., i * d:(i + 1) * d].contiguous() for i in range(3))
    split = lambda t: t.view(b, s, heads, dh)  # noqa: E731
    cases = {
        "K1": (ea.flash_encoder_attention_qkv(x, n, heads),
               ea.encoder_attention_plain(x, n, heads)),
        "K5": (ea.flash_encoder_attention_nld(q, k, v, n, heads),
               ea.encoder_attention_nld_plain(q, k, v, n, heads)),
        "K6": (ea.flash_encoder_attention(split(q), split(k), split(v), n),
               ea.encoder_attention_heads_plain(split(q), split(k), split(v), n)),
    }
    torch.cuda.synchronize()
    atol, rtol = ENC_TOL[dtype]
    for name, (got, ref) in cases.items():
        assert bool(torch.isfinite(got).all()), name
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=rtol,
                                   msg=lambda m, name=name: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_bit_exact_on_card(cuda, dtype):
    cache = torch.randn(5, 96, 256, device=cuda).to(dtype)
    ref = cache.clone()
    for step in range(0, 96, 7):
        slab = torch.randn(5, 8, 256, device=cuda).to(dtype)
        ref = cache_update.write_cache_block_plain(ref, slab, step)
        cache = cache_update.write_cache_block(cache, slab, step)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [1536, 130, 129])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_k2_kernel_other_widths_on_card(cuda, dtype, c):
    """K2 at the MHA self-cache width and at widths whose rows take 4-byte
    (C 130 bf16) or 1-byte (C 129 bf16) units."""
    cache = torch.randn(7, 48, c, device=cuda).to(dtype)
    ref = cache.clone()
    for step in range(0, 48, 5):
        slab = torch.randn(7, 8, c, device=cuda).to(dtype)
        ref = cache_update.write_cache_block_plain(ref, slab, step)
        cache = cache_update.write_cache_block(cache, slab, step)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


@pytest.mark.cuda
def test_k2_kernel_block_over_2gib_on_card(cuda):
    """B 1, T 8, an int8 cache of C 2^28 + 1 bytes a row: one batch row's
    block is 2^31 + 8 one-byte copy units (rows not 4-byte aligned), past
    the 32-bit run of earlier kernels.  About 2 GiB each for the cache and
    the slab; held bit for bit against copy_, then freed."""
    c = 2 ** 28 + 1
    cache = torch.zeros(1, 8, c, dtype=torch.int8, device=cuda)
    slab = torch.randint(-128, 128, (1, 8, c), dtype=torch.int8, device=cuda)
    ref = torch.empty_like(cache).copy_(slab)
    out = cache_update.write_cache_block(cache, slab, 5)
    torch.cuda.synchronize()
    assert out.data_ptr() == cache.data_ptr()
    equal = torch.equal(out, ref)
    del cache, slab, ref, out
    torch.cuda.empty_cache()
    assert equal


@pytest.mark.cuda
@pytest.mark.parametrize("c,dtype", [(1, torch.bfloat16), (4, torch.float32)])
def test_k2_kernel_many_rows_on_card(cuda, c, dtype):
    """K2 at B 262147, past 65535 groups of 4 batch rows (one grid
    column's worth), so blocks go on to further row groups."""
    b = 262147
    cache = torch.randn(b, 16, c, device=cuda).to(dtype)
    ref = cache.clone()
    for step in (3, 12):
        slab = torch.randn(b, 8, c, device=cuda).to(dtype)
        ref = cache_update.write_cache_block_plain(ref, slab, step)
        cache = cache_update.write_cache_block(cache, slab, step)
    torch.cuda.synchronize()
    assert torch.equal(cache, ref)


def _beam_inputs_on(dev, case, b=256, k=5, v=344, seed=0):
    """Beam step inputs (flagship-shaped by default): random scores with
    some EOS-heavy rows, the first step (alive [0, -1e9, ...], nothing
    finished), all ties, every candidate under -1e9 ("below"), fewer than
    2K candidates above -1e9 beside exact -1e9 ties ("few"), or -inf
    log-probs."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    lp = torch.log_softmax(2 * torch.randn(b, k, v, device=dev, generator=gen), -1)
    alive = -torch.rand(b, k, device=dev, generator=gen).mul(9).sort(dim=1,
                                                                   descending=True).values
    fin = torch.full((b, k), -1e9, device=dev)
    fin[:, :min(2, k)] = -torch.rand(b, min(2, k), device=dev, generator=gen)
    if case == "step0":
        alive = torch.full((b, k), -1e9, device=dev)
        alive[:, 0] = 0.0
        fin = torch.full((b, k), -1e9, device=dev)
    elif case == "ties":
        lp, alive = torch.zeros_like(lp), torch.zeros_like(alive)
    elif case == "below":
        alive = torch.full((b, k), -2e9, device=dev)
        fin = torch.full((b, k), -1e9, device=dev)
    elif case == "few":
        alive = torch.full((b, k), -1e9, device=dev)
        alive[:, 0] = 0.0
        fin = torch.full((b, k), -1e9, device=dev)
        lp[:, 0, 6:] = -float("inf")
    elif case == "neg_inf":
        lp[:, :, 1::3] = -float("inf")
        lp[::4, k - 1] = -float("inf")
    return alive, lp, fin


def _bits(x: torch.Tensor) -> torch.Tensor:
    return x.view(torch.int32) if x.dtype == torch.float32 else x


@pytest.mark.cuda
@pytest.mark.parametrize("k,v", [(5, 344), (5, 8), (1, 8), (3, 33), (10, 200), (16, 128),
                                 (5, 1000)])
@pytest.mark.parametrize("case", ["random", "step0", "ties", "below", "few", "neg_inf"])
def test_k3_k7_kernels_bit_exact_on_card(cuda, case, k, v):
    """Bitwise against the plain versions.  K3 runs its warp kernel up to
    K 10 and K * V 2048 (V 8 < 2K; V 33 with unaligned rows; K 10 at its
    limits) and the block kernel beyond (K 16, V 1000)."""
    alive, lp, fin = _beam_inputs_on(cuda, case, b=64, k=k, v=v)
    lp[:8, :, 2] = -0.05  # EOS-heavy rows
    got = beam_step.beam_advance(alive, lp, fin, 3.5, k, v, 2)
    ref = beam_step.beam_advance_plain(alive, lp, fin, 3.5, k, v, 2)
    torch.cuda.synchronize()
    for g, r in zip(got, ref):
        assert g.dtype == r.dtype and torch.equal(_bits(g), _bits(r))
    s, i = beam_step.beam_topk(alive, lp, 2 * k)
    rs, ri = beam_step.beam_topk_plain(alive, lp, 2 * k)
    torch.cuda.synchronize()
    assert torch.equal(_bits(s), _bits(rs)) and torch.equal(i, ri)
