"""Shared neural modules as plain functions over parameter dicts.

The port's counterpart of `nanodecoder_tpu.models.modules`, with the
same semantics:
  * params are nested dicts of float32 tensors; a dense `w` is (in, out);
  * initializers take a threefry key (`nanodecoder_tpu_torch.prng`), split
    it as the JAX package splits it and draw `jax.random`'s numbers from
    it on the given device: the same seed gives the JAX package's params
    (glorot arrays bit for bit, normal ones within a few ulps);
  * dropout draws the JAX package's masks from the caller's key (kernel
    R1 on the card);
  * activations run in the compute dtype, with layer-norm statistics
    and softmax in float32;
  * masks fill with -1e9, never -inf, so a row with no valid key gives
    uniform attention instead of NaN;
  * shapes are batch-major (B, T, D).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from nanodecoder_tpu_torch import prng

NEG_INF = -1e9  # additive mask value; avoids NaN-producing -inf in softmax


def glorot(key, shape, device: torch.device | str = "cpu") -> torch.Tensor:
    """Glorot-uniform over `shape` with the JAX package's fan rule:
    fan_in, fan_out = shape[-2], shape[-1] (a (W, I, O) conv weight leaves
    the kernel width out)."""
    fan_in, fan_out = shape[-2], shape[-1]
    scale = math.sqrt(6.0 / (fan_in + fan_out))
    return prng.uniform(key, shape, -scale, scale, device=device)


def normal_init(key, shape, stddev: float, device: torch.device | str = "cpu"
                ) -> torch.Tensor:
    return prng.normal(key, shape, device=device) * stddev


def init_dense(key, in_dim: int, out_dim: int, use_bias: bool = True,
               device: torch.device | str = "cpu"):
    p = {"w": glorot(key, (in_dim, out_dim), device)}
    if use_bias:
        p["b"] = torch.zeros((out_dim,), dtype=torch.float32, device=device)
    return p


def init_layer_norm(dim: int, device: torch.device | str = "cpu"):
    return {"scale": torch.ones((dim,), dtype=torch.float32, device=device),
            "bias": torch.zeros((dim,), dtype=torch.float32, device=device)}


def init_embedding(key, vocab: int, dim: int, device: torch.device | str = "cpu"):
    return {"table": normal_init(key, (vocab, dim), 1.0 / math.sqrt(dim), device)}


def init_mha(key, d_model: int, n_heads: int, kv_heads: int | None = None,
             device: torch.device | str = "cpu"):
    """q and o are (D, D); k and v project to kv_heads * head_dim (GQA/MQA
    when kv_heads < n_heads).  The key splits in four, one per matrix."""
    dk = d_model // n_heads * (kv_heads or n_heads)
    kq, kk, kv, ko = prng.split(key, 4)
    return {"q": init_dense(kq, d_model, d_model, device=device),
            "k": init_dense(kk, d_model, dk, device=device),
            "v": init_dense(kv, d_model, dk, device=device),
            "o": init_dense(ko, d_model, d_model, device=device)}


def init_ffn(key, d_model: int, ffn_dim: int, device: torch.device | str = "cpu"):
    k1, k2 = prng.split(key)
    return {"in": init_dense(k1, d_model, ffn_dim, device=device),
            "out": init_dense(k2, ffn_dim, d_model, device=device)}


def init_lstm_cell(key, in_dim: int, hidden: int, device: torch.device | str = "cpu"):
    """One LSTM cell: wx (in, 4H), wh (H, 4H) glorot, one zero bias (4H,);
    gate order i, f, g, o.  (Here rather than in `encoder`, since both the
    biLSTM encoder and the RNN decoder use it.)"""
    k1, k2 = prng.split(key)
    return {"wx": glorot(k1, (in_dim, 4 * hidden), device),
            "wh": glorot(k2, (hidden, 4 * hidden), device),
            "b": torch.zeros((4 * hidden,), dtype=torch.float32, device=device)}


def lstm_gates(gates: torch.Tensor, c: torch.Tensor):
    """The LSTM update from the pre-activation gates (..., 4H), order
    i, f, g, o: returns (h, c), both in the gates' dtype."""
    i, f, g, o = gates.chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def lstm_cell(p, x_t: torch.Tensor, h: torch.Tensor, c: torch.Tensor):
    """Standard LSTM cell, the weights cast to x_t's dtype: gates =
    x_t @ wx + h @ wh + b, then `lstm_gates`.  Returns (h, c)."""
    dt = x_t.dtype
    gates = x_t @ p["wx"].to(dt) + h @ p["wh"].to(dt) + p["b"].to(dt)
    return lstm_gates(gates, c)


def dense(p, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def layer_norm(p, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    # Reduce in f32 regardless of compute dtype.
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    y = (xf - mean) * torch.rsqrt(var + eps)
    y = y * p["scale"] + p["bias"]
    return y.to(x.dtype)


def embed(p, ids: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return p["table"].to(dtype)[ids]


def sinusoidal_positions(max_len: int, dim: int,
                         device: torch.device | str = "cpu") -> torch.Tensor:
    """(max_len, dim) f32 sinusoidal table, sin and cos interleaved
    (sin in even columns, cos in odd ones)."""
    pos = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32, device=device)
                    * (-math.log(10000.0) / dim))
    ang = pos * div  # (max_len, dim/2)
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(ang)
    pe[:, 1::2] = torch.cos(ang)
    return pe


def dropout_mask(rng, rate: float, shape, device: torch.device | str,
                 row0: int = 0) -> torch.Tensor | None:
    """The keep mask of the JAX package's dropout, bernoulli(rng, 1 - rate,
    shape), for a (rows, ...) tensor that holds rows row0.. of the array
    JAX draws (a data-parallel rank's share); None where dropout does
    nothing (no key, or rate 0).  Masks of one key are equal for any two
    shapes of one flat count and row length, so one draw may serve both."""
    if rng is None or rate <= 0.0:
        return None
    return prng.bernoulli(rng, 1.0 - rate, shape, device=device,
                          offset=row0 * math.prod(tuple(shape)[1:]))


def dropout(x: torch.Tensor, rate: float, rng, train: bool, row0: int = 0,
            mask: torch.Tensor | None = None) -> torch.Tensor:
    """Inverted dropout as the JAX package's: where(keep mask, x / keep, 0)
    with keep = 1 - rate, the mask drawn from `rng` (`dropout_mask`, or
    `mask`, drawn so for x's flat count).  As in JAX, keep is a weakly
    typed constant, so it is first rounded to x's dtype (bf16(0.9) is
    0.8984375); XLA then compiles the division into a float32 multiply by
    that constant's reciprocal.  The identity unless training with a
    positive rate and a key."""
    if not train or rate <= 0.0 or rng is None:
        return x
    if mask is None:
        mask = dropout_mask(rng, rate, x.shape, x.device, row0)
    keep = torch.tensor(1.0 - rate, dtype=x.dtype).item()
    inv_keep = float(np.float32(1.0) / np.float32(keep))
    return torch.where(mask.reshape(x.shape), x * inv_keep,
                       torch.zeros((), dtype=x.dtype, device=x.device)).to(x.dtype)


def _split_heads(x: torch.Tensor, n_heads: int) -> torch.Tensor:
    b, t, d = x.shape
    return x.reshape(b, t, n_heads, d // n_heads)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    b, t, h, dh = x.shape
    return x.reshape(b, t, h * dh)


def attention_core(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                   mask: torch.Tensor | None = None):
    """Scaled dot-product attention.

    q: (B, Tq, H, Dh), k/v: (B, Tk, Hk, Dh) with Hk dividing H (GQA:
    each KV head serves a contiguous group of H/Hk query heads); mask
    broadcastable to (B, H, Tq, Tk), True = keep.  Logits are
    accumulated and the softmax taken in float32; the probabilities are
    cast to v's dtype for the value product.  Returns (out (B, Tq, H,
    Dh), probs (B, H, Tq, Tk) f32)."""
    b, tq, hq, dh = q.shape
    hk = k.shape[2]
    tk = k.shape[1]
    scale = 1.0 / math.sqrt(dh)
    qf, kf = q.to(torch.float32), k.to(torch.float32)
    if hk == hq:
        logits = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    else:
        g = hq // hk
        qg = qf.reshape(b, tq, hk, g, dh)
        logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, kf) * scale
        logits = logits.reshape(b, hq, tq, tk)
    if mask is not None:
        # A Python scalar takes the logits' dtype without a copy to the device.
        logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    pv = probs.to(v.dtype)
    if hk == hq:
        out = torch.einsum("bhqk,bkhd->bqhd", pv, v)
    else:
        g = hq // hk
        pg = pv.reshape(b, hk, g, tq, tk)
        out = torch.einsum("bhgqk,bkhd->bqhgd", pg, v).reshape(b, tq, hq, dh)
    return out, probs


def mha(p, n_heads: int, query: torch.Tensor, key_value: torch.Tensor,
        mask: torch.Tensor | None = None, dropout_rate: float = 0.0,
        rng=None, train: bool = False, kv_heads: int | None = None,
        drop_mask: torch.Tensor | None = None):
    """Full (non-incremental) multi-head attention; differentiable.
    query: (B, Tq, D); key_value: (B, Tk, D).  Dropout (when training)
    falls on the attention output before the o projection, not on the
    probabilities, with `rng`'s mask (or `drop_mask`; `dropout`).  Returns
    (out (B, Tq, D), probs (B, H, Tq, Tk) f32)."""
    q = _split_heads(dense(p["q"], query), n_heads)
    k = _split_heads(dense(p["k"], key_value), kv_heads or n_heads)
    v = _split_heads(dense(p["v"], key_value), kv_heads or n_heads)
    out, probs = attention_core(q, k, v, mask)
    out = dropout(out, dropout_rate, rng, train, mask=drop_mask)
    return dense(p["o"], _merge_heads(out)), probs


def mha_project_kv(p, n_heads: int, key_value: torch.Tensor,
                   kv_heads: int | None = None):
    """Cross-attention K/V, projected once per chunk batch:
    (B, Tk, Hk, Dh) each."""
    k = _split_heads(dense(p["k"], key_value), kv_heads or n_heads)
    v = _split_heads(dense(p["v"], key_value), kv_heads or n_heads)
    return k, v


def mha_step(p, n_heads: int, query_1: torch.Tensor, k: torch.Tensor,
             v: torch.Tensor, mask: torch.Tensor | None = None):
    """One-token attention against precomputed K/V.
    query_1: (B, 1, D); k/v: (B, Tk, Hk, Dh); mask: (B, 1, 1, Tk)."""
    q = _split_heads(dense(p["q"], query_1), n_heads)
    out, probs = attention_core(q, k, v, mask)
    return dense(p["o"], _merge_heads(out)), probs


def ffn(p, x: torch.Tensor, dropout_rate: float = 0.0, rng=None,
        train: bool = False, row0: int = 0) -> torch.Tensor:
    """Position-wise feed-forward: dense, ReLU, dropout (when training),
    dense."""
    h = dropout(torch.relu(dense(p["in"], x)), dropout_rate, rng, train, row0)
    return dense(p["out"], h)


def length_mask(lengths: torch.Tensor, max_len: int) -> torch.Tensor:
    """(B,) lengths -> (B, max_len) bool validity mask."""
    pos = torch.arange(max_len, device=lengths.device)[None, :]
    return pos < lengths[:, None]


def causal_mask(t: int, device: torch.device | str = "cpu") -> torch.Tensor:
    """(1, 1, t, t) lower-triangular bool mask, True = keep."""
    return torch.tril(torch.ones((t, t), dtype=torch.bool, device=device))[None, None]
