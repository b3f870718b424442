"""Encoder self-attention (kernels K1, K5 and K6).

  * `flash_encoder_attention_qkv` (K1) takes the lean encoder's (B, S, 3D)
    QKV projection, with Q, K and V as column slices at offsets 0, D and
    2D, and returns the (B, S, D) attention output with heads concatenated;
  * `flash_encoder_attention_nld` (K5) takes separate (B, S, D) q, k and v,
    as the unfolded encoder projects them;
  * `flash_encoder_attention` (K6) takes the (B, S, H, Dh) layout and
    returns it.

Per batch row and head: f32 logits q.k/sqrt(Dh), keys at positions >=
lengths[b] set to -1e9 (a length-0 padding row gets uniform attention,
not NaN), f32 softmax, probabilities cast to the input dtype, P.V
accumulated in f32 and cast to the input dtype.

On a CUDA tensor each wrapper launches the hand-written kernels in
`csrc/encoder_attention.cu` (one kernel family for all three layouts,
given three pointers and a row stride: tensor cores in bf16, register-
tiled CUDA cores in exact f32, any S in both) and counts its own
launches; on a CPU tensor it runs the plain PyTorch version below.
Nothing falls back from one to the other.  The fast kernels are built
for head dims 32, 64, 128 and 256; for any other Dh under 256 the
wrapper pads q, k and v with zero lanes up to the next of them and drops
the pad from the output (zero lanes add nothing to a score or to P.V,
and the scale stays 1/sqrt(Dh) of the true Dh).  Head dims over 256 and
operands that are not 16-byte aligned (a view at an odd element offset)
run a scalar kernel of the same math and rounding points, which loops
over Dh in slices; each wrapper counts those launches apart in
`.scalar_launches`.  Any B and any number of heads run (the kernels
loop over grid y and z past 65535).

The kernels have no backward: each wrapper raises when grad mode is on
and an input requires grad, on every device, rather than return an
output that autograd would treat as a constant.  Training takes the
differentiable `attention_core` instead (`models.encoder` with
`train=True`).
"""

from __future__ import annotations

import ctypes
import math

import torch

from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.ops import _build

KERNEL_HEAD_DIMS = (32, 64, 128, 256)  # instantiated; others are padded up
_DTYPES = (torch.float32, torch.bfloat16)


_SCALAR_KERNEL = 1            # nd_encoder_attention's report of the scalar kernel
_launched = ctypes.c_int(-1)  # the kernel the last launch ran


def kernel_head_dim(dh: int) -> int:
    """The head dim a head dim of dh runs at: the next instantiated one up
    to 256, dh itself beyond (the scalar kernel)."""
    return next((w for w in KERNEL_HEAD_DIMS if w >= dh), dh)


def encoder_attention_heads_plain(q, k, v, lengths):
    """K6's plain PyTorch version: q/k/v (B, S, H, Dh) -> (B, S, H, Dh),
    attention_core with a key-length mask."""
    mask = nn.length_mask(lengths, k.shape[1])[:, None, None, :]
    out, _ = nn.attention_core(q, k, v, mask)
    return out


def encoder_attention_plain(qkv: torch.Tensor, lengths: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """K1's plain PyTorch version, on the sliced QKV slab."""
    d = qkv.shape[2] // 3
    q, k, v = (nn._split_heads(qkv[..., i * d:(i + 1) * d], heads) for i in range(3))
    return nn._merge_heads(encoder_attention_heads_plain(q, k, v, lengths))


def encoder_attention_nld_plain(q, k, v, lengths, heads: int) -> torch.Tensor:
    """K5's plain PyTorch version."""
    return nn._merge_heads(encoder_attention_heads_plain(
        *(nn._split_heads(x, heads) for x in (q, k, v)), lengths))


def _refuse_autograd(name: str, *xs: torch.Tensor) -> None:
    """Raise when autograd would need a gradient through the kernel."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in xs):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on inputs "
            f"that do not require grad (a training pass takes the differentiable "
            f"attention_core route, models.encoder with train=True)")


def _check(x: torch.Tensor, lengths: torch.Tensor, b: int, dh: int) -> bool:
    """Validate a kernel operand; returns True for the CPU (plain) route."""
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda" or lengths.device != x.device:
        raise ValueError("inputs and lengths must lie on one CUDA device")
    if dh <= 0:
        raise ValueError(f"head dim {dh} must be positive")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not in {_DTYPES}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not (x.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("inputs and lengths must be contiguous")
    return False


def _launch(wrapper, q_ptr: int, k_ptr: int, v_ptr: int, lengths: torch.Tensor,
            out: torch.Tensor, heads: int, ld: int, dh: int) -> torch.Tensor:
    """Run the kernel into out (B, S, heads * kernel Dh); q/k/v_ptr address
    position 0 of batch row 0, positions `ld` elements apart; dh is the
    true head dim, which sets the scale."""
    b, s, d = out.shape
    if b and s:
        lib = _build.load()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.check(lib.nd_encoder_attention(
            q_ptr, k_ptr, v_ptr, lengths.data_ptr(), out.data_ptr(), b, s, heads,
            d // heads, ld, int(out.dtype == torch.bfloat16), 1.0 / math.sqrt(dh),
            stream, ctypes.byref(_launched)), "encoder attention kernel")
        wrapper.launches += 1
        if _launched.value == _SCALAR_KERNEL:
            wrapper.scalar_launches += 1
    return out


def _padded(dh: int) -> bool:
    """Whether a head dim runs padded: under 256 and not instantiated."""
    return kernel_head_dim(dh) != dh


def _launch_padded(wrapper, q, k, v, lengths, heads: int) -> torch.Tensor:
    """The kernel on (B, S, H, Dh) views whose Dh (under 256) has no
    instantiation: q, k and v padded with zero lanes to the next kernel
    head dim, the pad dropped from the (B, S, H, Dh) result."""
    b, s, _h, dh = q.shape
    dp = kernel_head_dim(dh)
    qp, kp, vp = (torch.nn.functional.pad(x, (0, dp - dh)).contiguous() for x in (q, k, v))
    out = torch.empty((b, s, heads * dp), dtype=q.dtype, device=q.device)
    _launch(wrapper, qp.data_ptr(), kp.data_ptr(), vp.data_ptr(), lengths, out, heads,
            heads * dp, dh)
    return out.view(b, s, heads, dp)[..., :dh]


def flash_encoder_attention_qkv(qkv: torch.Tensor, lengths: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """K1.  qkv: (B, S, 3D), D = heads * Dh, float32 or bfloat16; lengths:
    (B,) int32 valid key counts.  Returns (B, S, D) in qkv's dtype."""
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % heads:
        raise ValueError(f"qkv must be (B, S, 3*heads*Dh), got {tuple(qkv.shape)}"
                         f" with heads={heads}")
    _refuse_autograd("flash_encoder_attention_qkv (K1)", qkv)
    b, s, d3 = qkv.shape
    d = d3 // 3
    dh = d // heads
    if _check(qkv, lengths, b, dh):
        return encoder_attention_plain(qkv, lengths, heads)
    if _padded(dh):
        return _launch_padded(flash_encoder_attention_qkv,
                              *(nn._split_heads(qkv[..., i * d:(i + 1) * d], heads)
                                for i in range(3)), lengths, heads).reshape(b, s, d)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    p, step = qkv.data_ptr(), d * qkv.element_size()
    return _launch(flash_encoder_attention_qkv, p, p + step, p + 2 * step, lengths,
                   out, heads, d3, dh)


def flash_encoder_attention_nld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """K5.  q/k/v: (B, S, D) of one dtype, D = heads * Dh.  Returns (B, S, D)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape or q.shape[2] % heads:
        raise ValueError(f"q/k/v must be one (B, S, heads*Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    _refuse_autograd("flash_encoder_attention_nld (K5)", q, k, v)
    b, s, d = q.shape
    if _check(q, lengths, b, d // heads):
        return encoder_attention_nld_plain(q, k, v, lengths, heads)
    for x in (k, v):
        _check(x, lengths, b, d // heads)
    if _padded(d // heads):
        return _launch_padded(flash_encoder_attention_nld,
                              *(nn._split_heads(x, heads) for x in (q, k, v)), lengths,
                              heads).reshape(b, s, d)
    out = torch.empty_like(q)
    return _launch(flash_encoder_attention_nld, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), lengths, out, heads, d, d // heads)


def flash_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """K6.  q/k/v: (B, S, H, Dh) of one dtype.  Returns (B, S, H, Dh)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be one (B, S, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    _refuse_autograd("flash_encoder_attention (K6)", q, k, v)
    b, s, h, dh = q.shape
    if _check(q, lengths, b, dh):
        return encoder_attention_heads_plain(q, k, v, lengths)
    for x in (k, v):
        _check(x, lengths, b, dh)
    if _padded(dh):
        return _launch_padded(flash_encoder_attention, q, k, v, lengths, h).contiguous()
    out = torch.empty_like(q)
    _launch(flash_encoder_attention, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths, out.view(b, s, h * dh), h, h * dh, dh)
    return out


flash_encoder_attention_qkv.launches = flash_encoder_attention_qkv.scalar_launches = 0
flash_encoder_attention_nld.launches = flash_encoder_attention_nld.scalar_launches = 0
flash_encoder_attention.launches = flash_encoder_attention.scalar_launches = 0
