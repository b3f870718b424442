"""One-token multi-head attention over a decode cache (kernels K4a, K4b)
and the int8 cross-cache quantization.

`decode_attention` (K4a): q (B, D), one query per row, against its own
(B, T, Dk) K/V cache row.  `decode_attention_grouped` (K4b): q (B * G, D),
the G consecutive rows of a chunk (its beams) against the chunk's one
cache row, which is read once for all of them.  The cache holds n_kv
heads of Dh = D / H lanes, Dk = n_kv * Dh: MHA (n_kv = H) or, for exact
dtypes, GQA/MQA (n_kv dividing H; query head h reads KV head
h // (H / n_kv)), as in the JAX package.  Both return (out (rows, D) in
q's dtype, amax (rows,) int32).  Per row and head:

  * q is cast to the cache dtype (int8 caches: q stays f32 and is
    multiplied by the per-lane K scales instead);
  * scores accumulated in f32, then * (1 / sqrt(Dh)); positions
    t >= valid_lens set to -1e9 by a select (a length-0 row attends
    uniformly, never NaN);
  * p = exp(s - max) / sum, all f32;
  * amax: the probabilities summed over the heads, and the lowest t
    whose sum reaches the maximum;
  * p cast to the V dtype (f32 for int8), P.V accumulated in f32, times
    the per-lane V scales for int8, cast to q's dtype.

This mirrors the Pallas kernel bodies (`_decode_attn_kernel`,
`_decode_attn_grouped_kernel`), not only their jnp references: the
head-summed argmax and the rounding points are the kernel's.  int8
caches are MHA only, as the JAX kernels assert.

On a CUDA tensor the wrappers launch the kernels in
`csrc/decode_attention.cu` (K4a and K4b have a kernel each: K4a streams
its row with 16-byte loads several rows deep; the grouped one streams
the chunk's cache through a cp.async ring for up to 8 beams a block, in
sub-groups beyond; a scalar kernel takes the shapes neither fits, so
every shape the JAX kernels take runs a CUDA kernel; where one query
row's H x T f32 scores overflow a block's shared memory, the wrapper
gives the scalar kernel a (rows, H, T) f32 workspace in device memory
for them); on a CPU tensor they run the plain PyTorch versions below.
Nothing falls back from one to the other.

The scalar kernel reads 10 to 150 times under the other two's bound
shares on an H100 (PERF.md section 6).  It runs what they do not take:
in K4a, heads that are no power of two of 16-byte loads up to 32 (int8
at Dh 8, any dtype at Dh 24) and over 8 query heads per KV head; in K4b,
GQA caches, Dh not a multiple of 16 and D over 1024 (the tiny test
config's beam path); in both, caches whose base is not 16-byte aligned
(a view at an odd offset).  Each wrapper counts its launches in
`.launches` and, of those, the scalar kernel's in `.scalar_launches`,
so the slow route stays visible.
"""

from __future__ import annotations

import ctypes
import functools
import math

import torch

from nanodecoder_tpu_torch.ops import _build

NEG_INF = -1e9
_DTYPES = (torch.float32, torch.bfloat16)
_NO_IDX = 2 ** 30
_SCALAR_KERNEL = 2            # nd_decode_attention's report of the scalar kernel
_launched = ctypes.c_int(-1)  # the kernel the last launch ran


def quantize_cache_int8(x: torch.Tensor):
    """(B, T, D) cache -> (int8 values, (B, D) f32 per-lane scales):
    symmetric per-(row, lane) quantization, rounding half to even.

    The scale is amax * f32(1/127), not amax / 127: XLA compiles the JAX
    package's division by the constant into that multiply, and the two
    differ in the last bit of about one scale in twenty."""
    xf = x.to(torch.float32)
    amax = xf.abs().amax(dim=1)                                  # (B, D)
    scale = torch.clamp(amax, min=1e-8) * torch.tensor(
        1.0 / 127.0, dtype=torch.float32, device=x.device)
    q = torch.round(xf / scale[:, None, :]).clamp(-127, 127).to(torch.int8)
    return q, scale


def dequantize_cache_int8(q: torch.Tensor, scale: torch.Tensor,
                          dtype: torch.dtype) -> torch.Tensor:
    """Inverse of quantize_cache_int8 (the fallback path for GQA/MQA)."""
    return (q.to(torch.float32) * scale[:, None, :]).to(dtype)


def _attend_plain(q4: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                  valid_lens: torch.Tensor, n_heads: int, k_scale, v_scale):
    """Shared body of the plain versions.  q4: (B, G, H, Dh); caches
    (B, T, n_kv * Dh).  Returns (out (B, G, D) f32 before the output
    cast, amax (B, G) int32)."""
    b, g, h, dh = q4.shape
    t = k_cache.shape[1]
    n_kv = k_cache.shape[2] // dh
    quantized = k_scale is not None
    if quantized:
        qm = q4.to(torch.float32) * k_scale.to(torch.float32).reshape(b, 1, h, dh)
    else:
        qm = q4.to(k_cache.dtype).to(torch.float32)
    kf, vf = (x.to(torch.float32).reshape(b, t, n_kv, dh) for x in (k_cache, v_cache))
    if n_kv != h:  # query head h reads KV head h // (H / n_kv)
        kf, vf = (x.repeat_interleave(h // n_kv, dim=2) for x in (kf, vf))
    s = torch.einsum("bghd,bthd->bght", qm, kf)
    s = s * (1.0 / math.sqrt(dh))
    pos = torch.arange(t, device=s.device)
    live = pos[None, :] < valid_lens.to(pos.dtype)[:, None]      # (B, T)
    s = torch.where(live[:, None, None, :], s, torch.tensor(
        NEG_INF, dtype=s.dtype, device=s.device))
    m = s.amax(dim=-1, keepdim=True)
    e = torch.exp(s - m)
    p = e / e.sum(dim=-1, keepdim=True)                          # (B, G, H, T)
    # Head sum in head order, then the lowest position reaching the max.
    pm = p[:, :, 0]
    for i in range(1, h):
        pm = pm + p[:, :, i]
    is_max = pm >= pm.amax(dim=-1, keepdim=True)
    amax = torch.where(is_max, pos, _NO_IDX).amin(dim=-1).to(torch.int32)
    pv = p if quantized else p.to(v_cache.dtype).to(torch.float32)
    out = torch.einsum("bght,bthd->bghd", pv, vf)
    out = out.reshape(b, g, h * dh)
    if quantized:
        out = out * v_scale.to(torch.float32)[:, None, :]
    return out, amax


def decode_attention_plain(q, k_cache, v_cache, valid_lens, n_heads: int,
                           k_scale=None, v_scale=None):
    """K4a's plain PyTorch version: (out (B, D) in q's dtype, amax (B,))."""
    b, d = q.shape
    out, amax = _attend_plain(q.reshape(b, 1, n_heads, d // n_heads), k_cache,
                              v_cache, valid_lens, n_heads, k_scale, v_scale)
    return out.reshape(b, d).to(q.dtype), amax.reshape(b)


def decode_attention_reference(q, k_cache, v_cache, valid_lens, n_heads: int
                               ) -> torch.Tensor:
    """The JAX package's `decode_attention_reference`: (B, D) outputs of
    exact caches (MHA, GQA or MQA), K4a's plain version without the
    attention position."""
    return decode_attention_plain(q, k_cache, v_cache, valid_lens, n_heads)[0]


def decode_attention_grouped_plain(q, k_cache, v_cache, valid_lens, n_heads: int,
                                   group: int, k_scale=None, v_scale=None):
    """K4b's plain PyTorch version: (out (B * G, D), amax (B * G,))."""
    rows, d = q.shape
    b = rows // group
    out, amax = _attend_plain(q.reshape(b, group, n_heads, d // n_heads), k_cache,
                              v_cache, valid_lens, n_heads, k_scale, v_scale)
    return out.reshape(rows, d).to(q.dtype), amax.reshape(rows)


def _check(q, k_cache, v_cache, valid_lens, n_heads, group, k_scale, v_scale):
    """Validate shapes and types; returns True for the CPU (plain) route."""
    if q.dim() != 2 or k_cache.dim() != 3 or v_cache.shape != k_cache.shape:
        raise ValueError(f"q must be (rows, D) and k/v (B, T, Dk); got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, "
                         f"{tuple(v_cache.shape)}")
    b, _, dk = k_cache.shape
    rows, d = q.shape
    if n_heads <= 0 or d % n_heads:
        raise ValueError(f"query width {d} is no multiple of n_heads={n_heads}")
    dh = d // n_heads
    n_kv = dk // dh
    if dk % dh or n_kv < 1 or n_heads % n_kv:
        raise ValueError(f"cache width {dk} must be n_kv * {dh} (Dh) with n_kv "
                         f"dividing n_heads={n_heads}")
    if group < 1 or rows != b * group:
        raise ValueError(f"q has {rows} rows for {b} cache rows and group {group}")
    if valid_lens.shape != (b,):
        raise ValueError(f"valid_lens must be ({b},), got {tuple(valid_lens.shape)}")
    if (k_scale is None) != (v_scale is None):
        raise ValueError("give both k_scale and v_scale, or neither")
    if q.dtype not in _DTYPES:
        raise TypeError(f"q dtype {q.dtype} not in {_DTYPES}")
    if k_scale is not None:
        if k_cache.dtype != torch.int8 or v_cache.dtype != torch.int8:
            raise TypeError("scaled caches must be int8")
        if dk != d:
            raise ValueError("int8 caches are MHA only (the JAX kernels assert it): "
                             f"cache width {dk} differs from the query width {d}")
        for sc in (k_scale, v_scale):
            if sc.shape != (b, d) or sc.dtype != torch.float32:
                raise ValueError(f"scales must be ({b}, {d}) float32")
    elif k_cache.dtype != q.dtype or v_cache.dtype != q.dtype:
        raise TypeError(f"cache dtype {k_cache.dtype} differs from q's {q.dtype}")
    tensors = [q, k_cache, v_cache, valid_lens] + (
        [k_scale, v_scale] if k_scale is not None else [])
    if all(x.device.type == "cpu" for x in tensors):
        return True
    if q.device.type != "cuda" or any(x.device != q.device for x in tensors):
        raise ValueError("all inputs must lie on one CUDA device")
    if valid_lens.dtype != torch.int32:
        raise TypeError("valid_lens must be int32")
    if not all(x.is_contiguous() for x in tensors):
        raise ValueError("inputs must be contiguous")
    return False


@functools.lru_cache(maxsize=256)
def _workspace_floats(group: int, t: int, d: int, n_heads: int) -> int:
    """Score-workspace floats per query row that a launch at this shape
    needs (H * T), or 0 where the scores fit in shared memory."""
    return int(_build.load().nd_decode_attention_workspace(group, t, d, n_heads))


def _launch(wrapper, q, k_cache, v_cache, valid_lens, n_heads, group, k_scale,
            v_scale):
    b, t, _dk = k_cache.shape
    d = q.shape[1]
    out = torch.empty_like(q)
    amax = torch.empty((q.shape[0],), dtype=torch.int32, device=q.device)
    if b and t:
        quantized = k_scale is not None
        lib = _build.load()
        # Where one query row's H x T f32 scores overflow a block's shared
        # memory, the scalar kernel keeps them in this workspace.
        ws_floats = _workspace_floats(group, t, d, n_heads)
        ws = torch.empty((q.shape[0], ws_floats), dtype=torch.float32,
                         device=q.device) if ws_floats else None
        stream = torch.cuda.current_stream(q.device).cuda_stream
        _build.check(lib.nd_decode_attention(
            q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
            valid_lens.data_ptr(), k_scale.data_ptr() if quantized else None,
            v_scale.data_ptr() if quantized else None, out.data_ptr(),
            amax.data_ptr(), ws.data_ptr() if ws is not None else None, b, group, t,
            d, k_cache.shape[2], n_heads, int(q.dtype == torch.bfloat16),
            int(quantized), 1.0 / math.sqrt(d // n_heads), stream,
            ctypes.byref(_launched)),
            f"decode attention kernel at {n_heads} heads x T {t}")
        wrapper.launches += 1
        if _launched.value == _SCALAR_KERNEL:
            wrapper.scalar_launches += 1
    return out, amax


def decode_attention(q, k_cache, v_cache, valid_lens, n_heads: int,
                     k_scale=None, v_scale=None):
    """K4a.  q: (B, D) float32/bfloat16; k/v: (B, T, Dk) in q's dtype
    (Dk = D, or n_kv * Dh for GQA/MQA), or int8 (Dk = D) with (B, D) f32
    k_scale/v_scale; valid_lens: (B,) int32.
    Returns (out (B, D) in q's dtype, amax (B,) int32)."""
    if _check(q, k_cache, v_cache, valid_lens, n_heads, 1, k_scale, v_scale):
        return decode_attention_plain(q, k_cache, v_cache, valid_lens, n_heads,
                                      k_scale, v_scale)
    return _launch(decode_attention, q, k_cache, v_cache, valid_lens, n_heads, 1,
                   k_scale, v_scale)


def decode_attention_grouped(q, k_cache, v_cache, valid_lens, n_heads: int,
                             group: int, k_scale=None, v_scale=None):
    """K4b.  q: (B * group, D), rows b * group .. + group - 1 against cache
    row b; otherwise as decode_attention.  Returns (out (B * group, D),
    amax (B * group,) int32)."""
    if _check(q, k_cache, v_cache, valid_lens, n_heads, group, k_scale, v_scale):
        return decode_attention_grouped_plain(q, k_cache, v_cache, valid_lens,
                                              n_heads, group, k_scale, v_scale)
    return _launch(decode_attention_grouped, q, k_cache, v_cache, valid_lens,
                   n_heads, group, k_scale, v_scale)


decode_attention.launches = decode_attention.scalar_launches = 0
decode_attention_grouped.launches = decode_attention_grouped.scalar_launches = 0
