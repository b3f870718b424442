"""Learning-rate schedules and the optimizer (the port's counterpart of
`nanodecoder_tpu.train.optim`, without optax).

`Optimizer` applies optax's formulas in optax's order: clip by global
norm (`g` when ||g|| < max, else g / ||g|| * max: no epsilon, unlike
`torch.nn.utils.clip_grad_norm_`), then Adam (eps 1e-8, eps_root 0,
optax's bias correction), AdamW (Adam plus 1e-4 * params, optax's default
decay, not torch's 1e-2) or plain SGD, then the step scaled by
-lr(count), the schedule read at the count before the increment (0 at
the first update).  Its state is plain tensors (`count`, and `mu`/`nu`
keyed by param path for Adam and AdamW) that a checkpoint writes to
`.npz`.  A step is `prepare` (on the host: lr(count) and the bias
corrections written into 0-d float32 tensors on the params' device),
`update` (on the device: the clip and the update, reading those tensors,
so a CUDA graph may capture it and replay it under each step's values),
then `advance` (the count, kept on the host).

`host_lr` is the value reports print.  It is the JAX package's separate
formula, whose cosine branch counts steps from 1, unlike optax's
`warmup_cosine_decay_schedule` that `build_schedule` follows for the
update.
"""

from __future__ import annotations

import math
from typing import Callable

import numpy as np
import torch

from nanodecoder_tpu_torch.config import TrainConfig

ADAM_EPS = 1e-8
ADAMW_WEIGHT_DECAY = 1e-4


def noam_schedule(d_model: int, warmup_steps: int, scale: float = 1.0
                  ) -> Callable[[int], float]:
    """lr = scale * d_model^-0.5 * min(s^-0.5, s * warmup^-1.5), s = count + 1."""
    def schedule(count: int) -> float:
        s = float(count) + 1.0
        return scale * d_model ** -0.5 * min(s ** -0.5, s * warmup_steps ** -1.5)
    return schedule


def warmup_cosine_decay_schedule(peak: float, warmup_steps: int, decay_steps: int
                                 ) -> Callable[[int], float]:
    """optax.warmup_cosine_decay_schedule(0, peak, warmup, decay): linear
    from 0 to peak over warmup_steps, then a cosine from peak to 0 over
    decay_steps - warmup_steps."""
    cos_steps = float(decay_steps - warmup_steps)
    if cos_steps <= 0:
        raise ValueError(f"cosine decay needs decay_steps > warmup_steps, got "
                         f"{decay_steps} and {warmup_steps}")

    def schedule(count: int) -> float:
        if count < warmup_steps:
            return peak * (count / warmup_steps)
        c = min(float(count - warmup_steps), cos_steps)
        return peak * 0.5 * (1.0 + math.cos(math.pi * c / cos_steps))
    return schedule


def build_schedule(cfg: TrainConfig, d_model: int) -> Callable[[int], float]:
    if cfg.lr_schedule == "noam":
        return noam_schedule(d_model, cfg.warmup_steps, cfg.learning_rate)
    if cfg.lr_schedule == "constant":
        return lambda count: cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        return warmup_cosine_decay_schedule(
            cfg.learning_rate, cfg.warmup_steps,
            max(cfg.train_steps, cfg.warmup_steps + 1))
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


def host_lr(cfg: TrainConfig, d_model: int, step: int) -> float:
    """The LR reports print for `step` (the JAX package's host formula)."""
    s = float(step) + 1.0
    if cfg.lr_schedule == "noam":
        return cfg.learning_rate * d_model ** -0.5 * min(
            s ** -0.5, s * cfg.warmup_steps ** -1.5)
    if cfg.lr_schedule == "constant":
        return cfg.learning_rate
    if cfg.lr_schedule == "cosine":
        warm, total = cfg.warmup_steps, max(cfg.train_steps, cfg.warmup_steps + 1)
        if s < warm:
            return cfg.learning_rate * s / warm
        frac = min((s - warm) / max(total - warm, 1), 1.0)
        return cfg.learning_rate * 0.5 * (1.0 + math.cos(math.pi * frac))
    raise ValueError(f"unknown lr_schedule {cfg.lr_schedule!r}")


class Optimizer:
    """Clip by global norm, then Adam, AdamW or SGD, then -lr(count), over
    `params` ({param path: leaf tensor}).  `step()` reads each parameter's
    `.grad` (None counts as zero).  `state` is {"count": 0-d int64, and
    for Adam/AdamW "mu", "nu": {param path: tensor}}, the form a
    checkpoint writes."""

    def __init__(self, params: dict[str, torch.Tensor], cfg: TrainConfig, d_model: int):
        if cfg.optimizer not in ("adam", "adamw", "sgd"):
            raise ValueError(f"unknown optimizer {cfg.optimizer!r}")
        self.params = dict(params)
        self.kind = cfg.optimizer
        self.b1, self.b2 = cfg.adam_b1, cfg.adam_b2
        self.grad_clip = cfg.grad_clip
        self.schedule = build_schedule(cfg, d_model)
        self.state: dict = {"count": torch.zeros((), dtype=torch.int64)}  # host: no sync
        if self.kind != "sgd":
            for name in ("mu", "nu"):
                self.state[name] = {k: torch.zeros_like(p, memory_format=torch.contiguous_format)
                                    for k, p in self.params.items()}
        # -lr(count) and the bias corrections of the next update, which
        # `prepare` writes and `update` reads.
        device = next(iter(self.params.values())).device
        self._neg_lr, self._bc1, self._bc2 = torch.zeros(
            3, dtype=torch.float32, device=device).unbind()

    def zero_grad(self) -> None:
        for p in self.params.values():
            p.grad = None

    def _clip(self, grads: list[torch.Tensor]) -> list[torch.Tensor]:
        norm = torch.linalg.vector_norm(torch.stack(torch._foreach_norm(grads)))
        scale = torch.where(norm < self.grad_clip, torch.ones_like(norm),
                            self.grad_clip / norm)
        return torch._foreach_mul(grads, scale)

    @torch.no_grad()
    def prepare(self) -> None:
        """On the host: write -lr(count) and the bias corrections of the next
        update into the device scalars that `update` reads, each rounded to
        float32 (three fills; no read of the device)."""
        count = int(self.state["count"])
        self._neg_lr.fill_(-self.schedule(count))
        if self.kind != "sgd":
            # Bias corrections in float32, as optax computes decay ** count.
            t = np.float32(count + 1)
            self._bc1.fill_(float(np.float32(1) - np.float32(self.b1) ** t))
            self._bc2.fill_(float(np.float32(1) - np.float32(self.b2) ** t))

    @torch.no_grad()
    def update(self) -> None:
        """On the device: the clip and the update under the scalars that
        `prepare` wrote; launches only, with nothing read on the host."""
        params = list(self.params.values())
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        if self.grad_clip > 0:
            grads = self._clip(grads)
        if self.kind == "sgd":
            updates = torch._foreach_mul(grads, self._neg_lr)
        else:
            mu, nu = (list(self.state[name].values()) for name in ("mu", "nu"))
            torch._foreach_mul_(mu, self.b1)
            torch._foreach_add_(mu, grads, alpha=1.0 - self.b1)
            torch._foreach_mul_(nu, self.b2)
            torch._foreach_addcmul_(nu, grads, grads, value=1.0 - self.b2)
            denom = torch._foreach_div(nu, self._bc2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, ADAM_EPS)
            updates = torch._foreach_div(mu, self._bc1)
            torch._foreach_div_(updates, denom)
            if self.kind == "adamw":
                torch._foreach_add_(updates, params, alpha=ADAMW_WEIGHT_DECAY)
            torch._foreach_mul_(updates, self._neg_lr)
        torch._foreach_add_(params, updates)

    def advance(self) -> None:
        self.state["count"] += 1

    def step(self) -> None:
        self.prepare()
        self.update()
        self.advance()

    @torch.no_grad()
    def load_state(self, state: dict) -> None:
        """Copy a `state`-shaped dict (e.g. a restored checkpoint's) into
        this optimizer's tensors, matched by param path."""
        self.state["count"].copy_(torch.as_tensor(state["count"]))
        if self.kind != "sgd":
            for name in ("mu", "nu"):
                for key, dst in self.state[name].items():
                    dst.copy_(state[name][key])


def build_optimizer(cfg: TrainConfig, d_model: int, params: dict[str, torch.Tensor]
                    ) -> tuple[Optimizer, Callable[[int], float]]:
    """(optimizer over `params` ({param path: leaf tensor}), its schedule)."""
    opt = Optimizer(params, cfg, d_model)
    return opt, opt.schedule
