"""Length and coverage penalties for beam scoring.

The port's counterpart of `nanodecoder_tpu.decode.penalties`:
"wu" (GNMT) and "avg" length normalization, and the coverage penalties
"wu" and "summary".

`length_penalty` divides candidate scores inside the beam advance
kernel, so it must come out as the same f32 value as the JAX package's
compiled program gives, to the last bit.  XLA compiles
`((5 + length) / 6) ** alpha` into a multiply by the f32 reciprocal of
6 followed by an f32 power that is correctly rounded at these lengths;
the port computes exactly that (the power in float64, rounded once).
"""

from __future__ import annotations

import numpy as np
import torch


def length_penalty(length, kind: str = "none", alpha: float = 0.6) -> torch.Tensor:
    """Divisor applied to a cumulative log-prob at `length` tokens, as an
    f32 tensor (0-dim for an int `length`).

    "wu":  ((5 + length) / 6) ** alpha   (GNMT)
    "avg": max(length, 1)                 (per-token average)
    "none": 1
    """
    length = torch.as_tensor(length).to(torch.float32)
    if kind == "wu":
        base = (length + 5.0) * torch.tensor(np.float32(1.0) / np.float32(6.0))
        return torch.pow(base.double(), float(np.float32(alpha))).to(torch.float32)
    if kind == "avg":
        return torch.clamp_min(length, 1.0)
    if kind == "none":
        return torch.ones_like(length)
    raise ValueError(f"unknown length penalty {kind!r}")


def coverage_penalty(attn_sums: torch.Tensor, kind: str = "none",
                     beta: float = 0.0) -> torch.Tensor:
    """Penalty SUBTRACTED from a hypothesis score, over its accumulated
    cross-attention mass attn_sums (..., S).  "wu": -beta * sum(log(
    min(a, 1))); "summary": beta * (sum(max(a, 1)) - S); "none" or
    beta 0: zeros."""
    if kind == "none" or beta == 0.0:
        return torch.zeros(attn_sums.shape[:-1], dtype=torch.float32,
                           device=attn_sums.device)
    a = attn_sums.to(torch.float32)
    if kind == "wu":
        return -beta * torch.log(torch.clamp(a, 1e-10, 1.0)).sum(dim=-1)
    if kind == "summary":
        return beta * (torch.clamp_min(a, 1.0).sum(dim=-1) - a.shape[-1])
    raise ValueError(f"unknown coverage penalty {kind!r}")
