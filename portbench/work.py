"""The yardstick's shared arithmetic: the H100's peaks, the conv
front-end's operations and positions, and the work bounds of kernels K1
and K4a.  Each family's operations a step or a batch sit with its plain
reference (`reference.model`, `reference.rnn`: `train_step_flops`,
`serve_batch_flops`).

Peaks are NVIDIA's data-sheet figures for one H100 SXM at 700 W: 989
TFLOP/s dense bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35
TB/s of HBM.  A multiply-add counts two operations.
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


def frontend_flops(model: dict, samples: int) -> float:
    """The conv front-end and its projection to d_model over one chunk of
    `samples` samples, which every family shares."""
    per_chunk = 0.0
    s, cin = samples, 1
    for ch, ker, stride in zip(model["conv_channels"], model["conv_kernels"],
                               model["conv_strides"]):
        s = -(-s // stride)
        per_chunk += 2.0 * s * ker * cin * ch
        cin = ch
    return per_chunk + 2.0 * s * cin * model["d_model"]


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
