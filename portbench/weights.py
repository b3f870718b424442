"""The float32 parameters a cell runs, by name, as its configuration file's
"params" says: a path (from the checkout's root) to a flat `.npz`, or a
draw from a fixed seed,

    {"draw": "glorot", "seed": 14}

over the names and shapes of the configuration's reference module
(`param_shapes`): matrices glorot-uniform with the port's fan rule
(fan_in, fan_out = shape[-2], shape[-1], so a (W, I, O) conv weight
leaves its width out), biases 0, layer-norm scales 1.

The draw is one `torch.rand` over every matrix, in the order of their
names, from a generator seeded with "seed" on the card (on the CPU
where there is none), then copied to the host once, where program and
reference take it from.  The run's `--seed` keys the data and dropout
alone.  PyTorch's CUDA generator spreads a draw over a grid sized to the
card, so one "seed" gives the same weights on one card model and PyTorch
build, and other weights on another card model or on the CPU.
"""

from __future__ import annotations

import math
import os

import numpy as np
import torch

from portbench import reference


def flat_params(config: dict, root: str) -> dict[str, np.ndarray]:
    params = config["params"]
    if isinstance(params, str):
        with np.load(os.path.join(root, params)) as data:
            return {k: np.asarray(data[k], np.float32) for k in data.files}
    shapes = reference.module(config).param_shapes(config["config"]["model"])
    return draw(params, shapes)


def draw(spec: dict, shapes: dict[str, tuple[int, ...]]) -> dict[str, np.ndarray]:
    if spec["draw"] != "glorot":
        raise ValueError(f"unknown draw {spec['draw']!r}")
    out = {k: np.full(shape, 1.0 if k.endswith("/scale") else 0.0, np.float32)
           for k, shape in shapes.items() if len(shape) < 2}
    mats = sorted(k for k, shape in shapes.items() if len(shape) >= 2)
    sizes = [math.prod(shapes[k]) for k in mats]
    device = "cuda" if torch.cuda.is_available() else "cpu"
    gen = torch.Generator(device=device).manual_seed(int(spec["seed"]))
    parts = torch.rand(sum(sizes), generator=gen, device=device).split(sizes)
    bounds = [math.sqrt(6.0 / (shapes[k][-2] + shapes[k][-1])) for k in mats]
    host = torch.cat([(u * 2.0 - 1.0) * b for u, b in zip(parts, bounds)]).cpu().numpy()
    for k, part in zip(mats, np.split(host, np.cumsum(sizes)[:-1])):
        out[k] = part.reshape(shapes[k])
    return {k: out[k] for k in sorted(out)}
