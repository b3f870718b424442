"""Encoder self-attention over the fused QKV slab (kernel K1).

`flash_encoder_attention_qkv` takes the lean encoder's (B, S, 3D) QKV
projection, with Q, K and V as column slices at offsets 0, D and 2D,
and returns the (B, S, D) attention output with heads concatenated.
Per batch row and head: f32 logits q.k/sqrt(Dh), keys at positions >=
lengths[b] set to -1e9 (a length-0 padding row gets uniform attention,
not NaN), f32 softmax, probabilities cast to the input dtype, P.V
accumulated in f32 and cast to the input dtype.

On a CUDA tensor the wrapper launches the hand-written kernel in
`csrc/encoder_attention.cu`; on a CPU tensor it runs the plain PyTorch
version below.  Nothing falls back from one to the other.
"""

from __future__ import annotations

import math

import torch

from nanodecoder_tpu_torch.models import modules as nn
from nanodecoder_tpu_torch.ops import _build

SUPPORTED_HEAD_DIMS = (32, 64, 128)
_DTYPES = (torch.float32, torch.bfloat16)


def encoder_attention_plain(qkv: torch.Tensor, lengths: torch.Tensor,
                            heads: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: attention_core on the sliced
    QKV slab with a key-length mask."""
    b, s, d3 = qkv.shape
    d = d3 // 3
    q = nn._split_heads(qkv[..., :d], heads)
    k = nn._split_heads(qkv[..., d:2 * d], heads)
    v = nn._split_heads(qkv[..., 2 * d:], heads)
    mask = nn.length_mask(lengths, s)[:, None, None, :]
    out, _ = nn.attention_core(q, k, v, mask)
    return nn._merge_heads(out)


def flash_encoder_attention_qkv(qkv: torch.Tensor, lengths: torch.Tensor,
                                heads: int) -> torch.Tensor:
    """qkv: (B, S, 3D), D = heads * Dh, float32 or bfloat16; lengths:
    (B,) int32 valid key counts.  Returns (B, S, D) in qkv's dtype."""
    if qkv.dim() != 3 or qkv.shape[2] % 3 or (qkv.shape[2] // 3) % heads:
        raise ValueError(f"qkv must be (B, S, 3*heads*Dh), got {tuple(qkv.shape)}"
                         f" with heads={heads}")
    b, s, d3 = qkv.shape
    if lengths.shape != (b,):
        raise ValueError(f"lengths must be ({b},), got {tuple(lengths.shape)}")
    if qkv.device.type == "cpu":
        return encoder_attention_plain(qkv, lengths, heads)
    if qkv.device.type != "cuda" or lengths.device != qkv.device:
        raise ValueError("qkv and lengths must lie on one CUDA device")
    dh = d3 // 3 // heads
    if dh not in SUPPORTED_HEAD_DIMS:
        raise ValueError(f"head dim {dh} not in {SUPPORTED_HEAD_DIMS}")
    if qkv.dtype not in _DTYPES:
        raise TypeError(f"qkv dtype {qkv.dtype} not in {_DTYPES}")
    if lengths.dtype != torch.int32:
        raise TypeError("lengths must be int32")
    if not (qkv.is_contiguous() and lengths.is_contiguous()):
        raise ValueError("qkv and lengths must be contiguous")
    out = torch.empty((b, s, d3 // 3), dtype=qkv.dtype, device=qkv.device)
    if b and s:
        lib = _build.load()
        stream = torch.cuda.current_stream(qkv.device).cuda_stream
        _build.check(lib.nd_encoder_attention_qkv(
            qkv.data_ptr(), lengths.data_ptr(), out.data_ptr(), b, s, heads,
            dh, int(qkv.dtype == torch.bfloat16), 1.0 / math.sqrt(dh), stream),
            "encoder attention kernel")
        flash_encoder_attention_qkv.launches += 1
    return out


flash_encoder_attention_qkv.launches = 0
