"""The train step, as the reference works it out again: the forward pass
with the trainer's dropout masks, the label-smoothed loss and the
guided-attention penalty, autograd's backward pass, the clip by global
norm and Adam with optax's formulas and the warm-up cosine schedule.

Plain PyTorch over the flat parameters, importing nothing of the
program; the forward pass is the configuration's reference module's.
The keys follow the trainer: PRNGKey(seed); each step splits off a step
key, key, step = split(key), and the one micro-batch takes
split(step, 1)[0] for both the encoder and the decoder.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from portbench.reference import threefry
from portbench.reference.signal import PAD


def smoothed_loss_sum(lp: torch.Tensor, tgt: torch.Tensor, eps: float):
    """(loss sum, tokens): 1 - eps on the gold label, eps spread over the
    V - 2 labels that are neither gold nor PAD, over non-PAD targets."""
    v = lp.shape[-1]
    valid = tgt != PAD
    gold = lp.gather(-1, tgt.long()[..., None])[..., 0]
    rest = lp.sum(dim=-1) - gold - lp[..., PAD]
    per = -((1.0 - eps) * gold + (eps / (v - 2)) * rest)
    return torch.where(valid, per, torch.zeros_like(per)).sum(), valid.sum()


def guided_attention(attn, tgt_len, enc_len, sigma: float):
    _b, _h, t, s = attn.shape
    dev = attn.device
    ti = torch.arange(t, dtype=torch.float32, device=dev)[None, :, None]
    si = torch.arange(s, dtype=torch.float32, device=dev)[None, None, :]
    tl = tgt_len.float().clamp_min(1.0)[:, None, None]
    el = enc_len.float().clamp_min(1.0)[:, None, None]
    w = 1.0 - torch.exp(-(si / el - ti / tl).square() / (2.0 * sigma * sigma))
    valid = ((ti < tl) & (si < el)).float()
    pen = (attn * (w * valid)[:, None]).sum(dim=(2, 3))
    return (pen / valid[:, :, 0].sum(dim=-1).clamp_min(1.0)[:, None]).mean()


def lr_at(train: dict, count: int, d_model: int) -> float:
    """The learning rate of update `count` (from 0): noam, constant, or
    linear warm-up from 0 then a cosine to 0 at train_steps."""
    peak, warm = train["learning_rate"], train["warmup_steps"]
    if train["lr_schedule"] == "noam":
        s = count + 1.0
        return peak * d_model ** -0.5 * min(s ** -0.5, s * warm ** -1.5)
    if train["lr_schedule"] == "constant":
        return peak
    total = max(train["train_steps"], warm + 1)
    if count < warm:
        return peak * count / warm
    c = min(float(count - warm), float(total - warm))
    return peak * 0.5 * (1.0 + math.cos(math.pi * c / (total - warm)))


class RefTrainer:
    """Steps of the reference `ref_cls` (a reference module's `Ref`) from
    float32 `flat` parameters (trained in place).  `half_batch` plants a
    fault for the benchmark's checks: each step trains on the first half
    of the rows only."""

    def __init__(self, ref_cls, flat: dict, model: dict, train: dict, seed: int,
                 half_batch: bool = False):
        self.ref_cls = ref_cls
        self.p = {k: v.clone().requires_grad_(True) for k, v in flat.items()}
        self.model, self.train = model, train
        self.key = threefry.prng_key(seed)
        self.mu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.nu = {k: torch.zeros_like(v) for k, v in self.p.items()}
        self.count = 0
        self.half = half_batch

    def step(self, batch: dict[str, torch.Tensor]):
        """One step; returns (mean smoothed loss, the clipped gradients)."""
        tr = self.train
        self.key, step_key = threefry.split(self.key)
        micro = threefry.split(step_key, 1)[0]
        if self.half:
            batch = {k: v[:v.shape[0] // 2] for k, v in batch.items()}
        ref = self.ref_cls(self.p, self.model, dropout=self.model["dropout"])
        mem, mlen = ref.encode(batch["signal"], batch["sig_lengths"], key=micro)
        lp, attn = ref.decode(batch["tgt_in"].long(), mem, mlen, key=micro)
        loss_sum, n_tok = smoothed_loss_sum(lp, batch["tgt_out"], tr["label_smoothing"])
        loss = loss_sum / n_tok.clamp_min(1).float()
        if tr["guided_attention_weight"] > 0:
            tgt_len = (batch["tgt_out"] != PAD).sum(dim=-1)
            loss = loss + tr["guided_attention_weight"] * guided_attention(
                attn, tgt_len, mlen, tr["guided_attention_sigma"])
        for v in self.p.values():
            v.grad = None
        loss.backward()
        names = list(self.p)
        grads = [self.p[k].grad for k in names]
        norm = torch.linalg.vector_norm(torch.stack([g.norm() for g in grads]))
        if tr["grad_clip"] > 0 and float(norm) >= tr["grad_clip"]:
            grads = [g * (tr["grad_clip"] / norm) for g in grads]
        b1, b2 = tr["adam_b1"], tr["adam_b2"]
        t = np.float32(self.count + 1)
        bc1 = float(np.float32(1) - np.float32(b1) ** t)
        bc2 = float(np.float32(1) - np.float32(b2) ** t)
        lr = lr_at(tr, self.count, self.model["d_model"])
        with torch.no_grad():
            for k, g in zip(names, grads):
                self.mu[k].mul_(b1).add_(g, alpha=1.0 - b1)
                self.nu[k].mul_(b2).addcmul_(g, g, value=1.0 - b2)
                upd = (self.mu[k] / bc1) / ((self.nu[k] / bc2).sqrt() + 1e-8)
                self.p[k].add_(upd, alpha=-lr)
        self.count += 1
        grads = {k: g.detach() for k, g in zip(names, grads)}
        return float(loss_sum.detach() / n_tok.clamp_min(1)), grads
