"""Device selection for the port's entry points.

Every entry point takes `device=` and defaults to the card.  A caller
that wants the CPU says so with `device="cpu"`; a missing card is an
error, never a quiet fall-back to the CPU.
"""

from __future__ import annotations

import torch


def resolve_device(device: str | torch.device = "cuda") -> torch.device:
    """`device` as a torch.device; raises when it names CUDA and no
    CUDA device is present."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
