"""The yardstick's arithmetic: the H100's peaks, the model's operations
from its shapes, and the work bounds of kernels K1 and K4a.

Peaks are NVIDIA's data-sheet figures for one H100 SXM at 700 W: 989
TFLOP/s dense bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35
TB/s of HBM.  A multiply-add counts two operations.  Serving counts the
work the chunks needed: the encoder over every real chunk's 256
positions (attention over each chunk's valid positions), the cross K/V
projection once a chunk, and the decoder once for each served token.
Training counts the forward pass over the whole batch shape (causal self
attention over its lower triangle) and twice that for the backward pass.
"""

from __future__ import annotations

import numpy as np

PEAK_BF16 = 989e12
PEAK_F32 = 67e12
HBM = 3.35e12


def enc_positions(model: dict, samples: int) -> int:
    s = samples
    for stride in model["conv_strides"]:
        s = -(-s // stride)
    return s


def enc_lengths(model: dict, lengths: np.ndarray) -> np.ndarray:
    out = np.asarray(lengths, np.int64)
    for stride in model["conv_strides"]:
        out = -(-out // stride)
    return out


def encoder_flops(model: dict, samples: int, lengths: np.ndarray) -> float:
    """The conv front-end, projection and transformer body over chunks of
    `samples` samples with these valid lengths (one per chunk)."""
    d, f = model["d_model"], model["enc_ffn_dim"]
    n = len(lengths)
    per_chunk = 0.0
    s, cin = samples, 1
    for ch, ker, stride in zip(model["conv_channels"], model["conv_kernels"],
                               model["conv_strides"]):
        s = -(-s // stride)
        per_chunk += 2.0 * s * ker * cin * ch
        cin = ch
    per_chunk += 2.0 * s * cin * d
    per_chunk += model["enc_layers"] * s * (2.0 * 4 * d * d + 2.0 * 2 * d * f)
    keys = enc_lengths(model, lengths)
    keys = np.where(keys > 0, keys, s).astype(np.float64)
    attn = model["enc_layers"] * 4.0 * s * d * keys.sum()
    return n * per_chunk + attn


def decoder_token_flops(model: dict, t: np.ndarray, mem: np.ndarray) -> float:
    """Decoder steps at positions t (0-based) over memories of `mem` valid
    positions, the generator included: summed over the arrays."""
    d, f, v = model["d_model"], model["dec_ffn_dim"], model["vocab_size"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    t = np.asarray(t, np.float64)
    mem = np.asarray(mem, np.float64)
    dense = model["dec_layers"] * (2.0 * d * (d + 2 * dk) + 3 * 2.0 * d * d
                                   + 2.0 * 2 * d * f) + 2.0 * d * v
    attn = model["dec_layers"] * 4.0 * d * ((t + 1) + mem)
    return float(dense * t.size + attn.sum())


def cross_kv_flops(model: dict, samples: int, n_chunks: int) -> float:
    d = model["d_model"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    return model["dec_layers"] * 2.0 * enc_positions(model, samples) * d * 2 * dk * n_chunks


def serve_batch_flops(model: dict, samples: int, lengths: np.ndarray,
                      decoded: np.ndarray) -> float:
    """One greedy batch's needed operations: `lengths` of its real chunks
    and the served tokens of each."""
    mem = enc_lengths(model, lengths)
    total = encoder_flops(model, samples, lengths) + cross_kv_flops(model, samples, len(lengths))
    t = np.concatenate([np.arange(n) for n in decoded]) if len(decoded) else np.zeros(0)
    m = np.repeat(mem, decoded)
    return total + decoder_token_flops(model, t, m)


def train_step_flops(model: dict, batch: int, samples: int, tmax: int) -> float:
    """Forward and backward of one step at the batch shape."""
    s = enc_positions(model, samples)
    lengths = np.full(batch, samples)
    fwd = encoder_flops(model, samples, lengths) + cross_kv_flops(model, samples, batch)
    d, f, v = model["d_model"], model["dec_ffn_dim"], model["vocab_size"]
    dk = d // model["dec_heads"] * (model["dec_kv_heads"] or model["dec_heads"])
    per_tok = model["dec_layers"] * (2.0 * d * (d + 2 * dk) + 3 * 2.0 * d * d
                                     + 2.0 * 2 * d * f) + 2.0 * d * v
    causal = model["dec_layers"] * 4.0 * d * (tmax * (tmax + 1) / 2)
    cross = model["dec_layers"] * 4.0 * d * tmax * s
    fwd += batch * (per_tok * tmax + causal + cross)
    return 3.0 * fwd


def bound_s(nbytes: float, flops: float, peak: float) -> float:
    return max(nbytes / HBM, flops / peak)


def k1_bound_s(model: dict, samples: int, rows: int, lengths: np.ndarray,
               elem: int = 2) -> float:
    """One batch's K1 calls (one a layer) on (rows, S, 3D) qkv: qkv read
    once, the (rows, S, D) output written once, the lengths; every query
    against the keys up to its row's length, 4 operations a lane."""
    s, d = enc_positions(model, samples), model["d_model"]
    keys = np.zeros(rows, np.float64)
    keys[:len(lengths)] = enc_lengths(model, lengths)
    keys = np.where(keys > 0, keys, s)
    nbytes = rows * s * 4 * d * elem + rows * 4
    flops = 4.0 * s * d * keys.sum()
    return model["enc_layers"] * bound_s(nbytes, flops, PEAK_BF16)


def k4a_bound_s(model: dict, samples: int, rows: int, lengths: np.ndarray, steps: int,
                elem: int = 2) -> float:
    """One batch's K4a calls (one a layer and step) on MHA cross caches:
    the cache rows below each chunk's length read once for its query,
    q read and the output written, lengths and positions; 4 operations a
    query lane and row."""
    s, d = enc_positions(model, samples), model["d_model"]
    keys = np.zeros(rows, np.float64)
    keys[:len(lengths)] = enc_lengths(model, lengths)
    n_eff = float(np.where(keys > 0, keys, s).sum())
    nbytes = 2 * n_eff * d * elem + 2 * rows * d * elem + rows * 8
    return model["dec_layers"] * steps * bound_s(nbytes, 4.0 * n_eff * d, PEAK_BF16)
