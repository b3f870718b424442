"""Shared CLI plumbing: loading params and config."""

from __future__ import annotations

import os
from typing import Any

import torch

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.train.checkpoint import load_params_npz


def load_params_and_config(ckpt: str, device: str | torch.device = "cuda"
                           ) -> tuple[dict[str, Any], Config]:
    """(params on `device`, config) from a `.npz` params export with its
    `config.json` beside it."""
    if not ckpt.endswith(".npz"):
        raise ValueError(f"checkpoint directories are not ported; pass an .npz "
                         f"params export with config.json beside it (got {ckpt!r})")
    cfg_path = os.path.join(os.path.dirname(os.path.abspath(ckpt)), "config.json")
    with open(cfg_path) as f:
        config = Config.from_json(f.read())
    return load_params_npz(ckpt, config.model, device=device), config
