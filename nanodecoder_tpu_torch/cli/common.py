"""Shared CLI plumbing: loading params and config."""

from __future__ import annotations

import os
from typing import Any

import torch

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.train.checkpoint import (CheckpointManager, load_config,
                                                    load_params_npz, read_jax_params)


def load_params_and_config(ckpt: str, device: str | torch.device = "cuda"
                           ) -> tuple[dict[str, Any], Config]:
    """(params on `device`, config) from a `.npz` params export with its
    `config.json` beside it, or from the newest step of a checkpoint
    directory: one the port's trainer wrote, or one the JAX package's
    trainer wrote (orbax; read without JAX), or one that holds both, where
    the highest step wins and, on a tie, the port's."""
    if ckpt.endswith(".npz"):
        cfg_path = os.path.join(os.path.dirname(os.path.abspath(ckpt)), "config.json")
        with open(cfg_path) as f:
            config = Config.from_json(f.read())
        return load_params_npz(ckpt, config.model, device=device), config
    if not os.path.isfile(os.path.join(ckpt, "config.json")):
        raise ValueError(f"{ckpt!r} is neither an .npz params export nor a checkpoint "
                         "directory (no config.json)")
    config = load_config(ckpt)
    mgr = CheckpointManager(ckpt, config)
    newest = mgr.latest()
    if newest is None:
        raise FileNotFoundError(f"no checkpoints of the port's or the JAX package's "
                                f"trainer in {ckpt}")
    step, is_jax = newest
    if is_jax:
        return read_jax_params(ckpt, step, device, config), config
    path = os.path.join(mgr.directory, str(step), CheckpointManager.PARAMS)
    return load_params_npz(path, config.model, device=device), config
