"""Shared CLI plumbing: loading params and config."""

from __future__ import annotations

import os
from typing import Any

import torch

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.train.checkpoint import (CheckpointManager, load_config,
                                                    load_params_npz)


def load_params_and_config(ckpt: str, device: str | torch.device = "cuda"
                           ) -> tuple[dict[str, Any], Config]:
    """(params on `device`, config) from a `.npz` params export with its
    `config.json` beside it, or from the latest step of a checkpoint
    directory that the port's trainer wrote."""
    if ckpt.endswith(".npz"):
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(ckpt)), "config.json")
        with open(cfg_path) as f:
            config = Config.from_json(f.read())
        return load_params_npz(ckpt, config.model, device=device), config
    orbax = ("JAX orbax checkpoint directories are not ported: export their params "
             "with the JAX package's save_params_npz")
    if not os.path.isfile(os.path.join(ckpt, "config.json")):
        raise ValueError(f"{ckpt!r} is neither an .npz params export nor a checkpoint "
                         f"directory of the port's trainer (no config.json); {orbax}")
    config = load_config(ckpt)
    mgr = CheckpointManager(ckpt, config)
    step = mgr.latest_step()
    if step is None:
        if any(n.isdigit() for n in os.listdir(ckpt)):
            raise ValueError(f"{ckpt!r} holds steps, none in the port's format; {orbax}")
        raise FileNotFoundError(f"no checkpoints in {ckpt}")
    path = os.path.join(mgr.directory, str(step), CheckpointManager.PARAMS)
    return load_params_npz(path, config.model, device=device), config
