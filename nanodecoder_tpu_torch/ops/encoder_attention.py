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
tiled CUDA cores in exact f32) and counts its own launches; on a CPU
tensor it runs the plain PyTorch version below.  Nothing falls back from
one to the other: a CUDA input the kernels do not take raises.  The f32
kernel keeps a (32, S) score strip in shared memory, which bounds S
(`f32_max_seq`); the bf16 kernel takes any S.
"""

from __future__ import annotations

import math

import torch

from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)
_MAX_SMEM = 227 * 1024  # shared memory one block may use on the H100


def f32_max_seq(dh: int) -> int:
    """The longest S the f32 kernel takes at head dim dh: its shared
    memory holds Q (32 rows) and K/V (64 rows) tiles of Dh + 4 floats and
    the (32, S) score strip, S rounded up to 32 plus 8 (csrc smem32)."""
    return ((_MAX_SMEM // 4 - 96 * (dh + 4)) // 32 - 8) // 32 * 32


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


def _check(x: torch.Tensor, lengths: torch.Tensor, b: int, dh: int) -> bool:
    """Validate a kernel operand; returns True for the CPU (plain) route."""
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if x.device.type == "cpu":
        return True
    if x.device.type != "cuda" or lengths.device != x.device:
        raise ValueError("inputs and lengths must lie on one CUDA device")
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if x.dtype not in _DTYPES:
        raise TypeError(f"dtype {x.dtype} not in {_DTYPES}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not (x.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("inputs and lengths must be contiguous")
    if x.data_ptr() % 16:
        raise ValueError("the kernels read 16-byte rows: inputs must be 16-byte aligned")
    if x.dtype == torch.float32 and x.shape[1] > f32_max_seq(dh):
        raise ValueError(f"the f32 kernel keeps a (32, S) score strip in shared memory "
                         f"and takes S <= {f32_max_seq(dh)} at head dim {dh}; got S "
                         f"{x.shape[1]} (the bf16 kernel takes any S)")
    return False


def _launch(wrapper, q_ptr: int, k_ptr: int, v_ptr: int, lengths: torch.Tensor,
            out: torch.Tensor, heads: int, ld: int) -> torch.Tensor:
    """Run the kernel into out (B, S, D); q/k/v_ptr address position 0 of
    batch row 0, positions `ld` elements apart."""
    b, s, d = out.shape
    if b and s:
        dh = d // heads
        lib = _build.load()
        stream = torch.cuda.current_stream(out.device).cuda_stream
        _build.check(lib.nd_encoder_attention(
            q_ptr, k_ptr, v_ptr, lengths.data_ptr(), out.data_ptr(), b, s, heads, dh,
            ld, int(out.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), stream),
            "encoder attention kernel")
        wrapper.launches += 1
    return out


def flash_encoder_attention_qkv(qkv: torch.Tensor, lengths: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """K1.  qkv: (B, S, 3D), D = heads * Dh, float32 or bfloat16; lengths:
    (B,) int32 valid key counts.  Returns (B, S, D) in qkv's dtype."""
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % heads:
        raise ValueError(f"qkv must be (B, S, 3*heads*Dh), got {tuple(qkv.shape)}"
                         f" with heads={heads}")
    b, s, d3 = qkv.shape
    d = d3 // 3
    if _check(qkv, lengths, b, d // heads):
        return encoder_attention_plain(qkv, lengths, heads)
    out = torch.empty((b, s, d), dtype=qkv.dtype, device=qkv.device)
    p, step = qkv.data_ptr(), d * qkv.element_size()
    return _launch(flash_encoder_attention_qkv, p, p + step, p + 2 * step, lengths,
                   out, heads, d3)


def flash_encoder_attention_nld(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                                lengths: torch.Tensor, heads: int) -> torch.Tensor:
    """K5.  q/k/v: (B, S, D) of one dtype, D = heads * Dh.  Returns (B, S, D)."""
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape or q.shape[2] % heads:
        raise ValueError(f"q/k/v must be one (B, S, heads*Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    b, s, d = q.shape
    if _check(q, lengths, b, d // heads):
        return encoder_attention_nld_plain(q, k, v, lengths, heads)
    for x in (k, v):
        _check(x, lengths, b, d // heads)
    out = torch.empty_like(q)
    return _launch(flash_encoder_attention_nld, q.data_ptr(), k.data_ptr(),
                   v.data_ptr(), lengths, out, heads, d)


def flash_encoder_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            lengths: torch.Tensor) -> torch.Tensor:
    """K6.  q/k/v: (B, S, H, Dh) of one dtype.  Returns (B, S, H, Dh)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must be one (B, S, H, Dh) shape, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("q, k and v must share a dtype")
    b, s, h, dh = q.shape
    if _check(q, lengths, b, dh):
        return encoder_attention_heads_plain(q, k, v, lengths)
    for x in (k, v):
        _check(x, lengths, b, dh)
    out = torch.empty_like(q)
    _launch(flash_encoder_attention, q.data_ptr(), k.data_ptr(), v.data_ptr(),
            lengths, out.view(b, s, h * dh), h, h * dh)
    return out


flash_encoder_attention_qkv.launches = 0
flash_encoder_attention_nld.launches = 0
flash_encoder_attention.launches = 0
