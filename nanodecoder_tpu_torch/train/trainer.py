"""Trainer: the train step (forward, loss, backward, clip, update), the
eval step, and the host loop with reports, validation, early stopping
and checkpoints (the port's counterpart of
`nanodecoder_tpu.train.trainer`).

The training pass is plain PyTorch under autograd, with no hand-written
kernel: the encoder takes the differentiable attention when `train` is
set, as the JAX package's takes its XLA path.  Validation runs the
unfolded encoder on the master weights without a gradient, so with
`use_pallas` every encoder layer of every validation batch launches
kernel K5.  Gradient accumulation is a Python loop over the A
micro-batches of a step that sums `.grad`; each micro objective is its
token-summed loss over the token count of all A micro-batches (counted
before any backward), plus ga_weight / A times its guided-attention
penalty, so the summed gradient is the one-batch gradient.  Float32
means float32: TF32 is switched off for matmuls and cuDNN.

Data parallelism (`Trainer(mesh_plan=)`, `parallel.mesh.MeshPlan`): every
rank is fed the whole host batch and runs forward and backward on its
rows of each micro-batch; the gradients are summed over the ranks in one
all-reduce before the update, which every rank then applies alike.  The
loss stays the global batch's function: the token count that divides it
is the whole batch's, and a rank's guided-attention mean over its B/W
rows is weighted by (B/W)/B, so the summed gradient is one device's.
Dropout is keyed as the JAX package keys it (`prng`): the trainer's key
is PRNGKey(train.seed), each step splits off a step key and each
micro-batch takes one of split(step key, A); every rank holds the same
keys and draws its rows of the global micro-batch's masks (their counter
offset), so a data-parallel step equals one device's within f32
summation order, with dropout too.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.models.model import (decode_teacher_forced, encode,
                                                named_leaves)
from nanodecoder_tpu_torch.train.loss import guided_attention_loss, loss_and_metrics
from nanodecoder_tpu_torch.train.optim import Optimizer, build_optimizer, host_lr
from nanodecoder_tpu_torch.utils.report import ReportManager
from nanodecoder_tpu_torch.utils.statistics import Statistics
from nanodecoder_tpu_torch.vocab import PAD_ID

METRIC_KEYS = ("loss_sum", "xent_sum", "n_tokens", "n_correct")


class TrainState(NamedTuple):
    params: dict[str, Any]     # nested float32 tensors
    opt_state: dict[str, Any]  # {"count": 0-d int64, "mu"/"nu": {param key: tensor}}
    step: int


def batch_to_device(batch: dict[str, np.ndarray], device: torch.device
                    ) -> dict[str, torch.Tensor]:
    return {k: torch.as_tensor(np.asarray(v)).to(device) for k, v in batch.items()}


def make_train_step(config: Config, optimizer: Optimizer) -> Callable:
    """train_step(params, batch, key, plan=None) -> metrics summed over
    micro-batches (0-d tensors); updates params in place through
    `optimizer`.  Micro-batch i's dropout takes split(key, A)[i], passed to
    the encoder and the decoder alike, as in the JAX package.  With a
    MeshPlan, this rank's rows (their masks drawn at their place in the
    global micro-batch) and summed gradients and metrics.
    batch: tensors with the accumulation axis,
      signal (A, B, S) f32, sig_lengths (A, B) int,
      tgt_in (A, B, T) int, tgt_out (A, B, T) int."""
    mcfg, tcfg = config.model, config.train

    def micro_loss(params, mb, rng, inv_total, inv_accum: float, row0: int):
        mem, mem_len = encode(params, mcfg, mb["signal"], mb["sig_lengths"], rng,
                              train=True, row0=row0)
        log_probs, attn = decode_teacher_forced(params, mcfg, mb["tgt_in"], mem,
                                                mem_len, rng, train=True, row0=row0)
        _loss, metrics = loss_and_metrics(log_probs, mb["tgt_out"],
                                          tcfg.label_smoothing)
        loss = metrics["loss_sum"] * inv_total
        if tcfg.guided_attention_weight > 0.0:
            tgt_lengths = (mb["tgt_out"] != PAD_ID).sum(dim=-1)
            loss = loss + (tcfg.guided_attention_weight * inv_accum) * \
                guided_attention_loss(attn, tgt_lengths, mem_len,
                                      tcfg.guided_attention_sigma)
        return loss, metrics

    def train_step(params, batch: dict[str, torch.Tensor], key, plan=None):
        accum, bsz = batch["signal"].shape[:2]
        # Token counts are data: the total over all micro-batches (and all
        # ranks' rows) is known before the first backward.
        total = torch.clamp((batch["tgt_out"] != PAD_ID).sum(), min=1).to(torch.float32)
        inv_total = 1.0 / total
        rows, share = slice(0, bsz), 1.0
        if plan is not None:
            rows = plan.row_slice(bsz)
            share = (rows.stop - rows.start) / bsz
        optimizer.zero_grad()
        summed = None
        for i, rng in enumerate(prng.split(key, accum)):
            loss, metrics = micro_loss(params, {k: v[i, rows] for k, v in batch.items()},
                                       rng, inv_total, share / accum, rows.start)
            loss.backward()
            metrics = {k: metrics[k].detach() for k in METRIC_KEYS}
            summed = metrics if summed is None else \
                {k: summed[k] + metrics[k] for k in METRIC_KEYS}
        if plan is not None:
            plan.all_reduce_grads(optimizer.params.values())
            summed = plan.sum_metrics(summed)
        optimizer.step()
        return summed

    return train_step


def make_eval_step(config: Config) -> Callable:
    """eval_step(params, batch, plan=None) -> metrics of one (B, ...) batch,
    without a gradient (with a MeshPlan, of this rank's rows, summed over
    the ranks); the encoder takes K5 when `use_pallas` is set."""
    mcfg = config.model

    @torch.no_grad()
    def eval_step(params, batch: dict[str, torch.Tensor], plan=None):
        if plan is not None:
            batch = plan.shard_batch(batch)
        mem, mem_len = encode(params, mcfg, batch["signal"], batch["sig_lengths"])
        log_probs, _ = decode_teacher_forced(params, mcfg, batch["tgt_in"], mem, mem_len)
        _loss, metrics = loss_and_metrics(log_probs, batch["tgt_out"],
                                          config.train.label_smoothing)
        return metrics if plan is None else plan.sum_metrics(metrics)

    return eval_step


def _update_stats(stats: Statistics, metrics) -> None:
    stats.update(float(metrics["xent_sum"]), int(metrics["n_tokens"]),
                 int(metrics["n_correct"]))


class Trainer:
    """Host loop over the train step on the params' device.

    `params` (nested float32 tensors, e.g. from `init_model` or
    `train.checkpoint.params_from_numpy`) are trained in place.
    `train_iter` yields numpy batches with the accumulation axis
    (A, B, ...); `valid_iter_fn` returns a fresh finite iterable of
    (B, ...) batches.  Dropout is keyed from PRNGKey(train.seed), one key
    split off a step; like the JAX package's, the key is not part of a
    checkpoint and a restored trainer starts again from the seed's, so a
    resumed run equals an uninterrupted one only with dropout 0.

    `mesh_plan` (a `parallel.mesh.MeshPlan`): data-parallel steps over its
    ranks (see the module docstring), every rank fed the same batches;
    the params are made rank 0's first."""

    def __init__(self, config: Config, params: dict[str, Any],
                 report: ReportManager | None = None, checkpointer=None,
                 early_stopping=None, mesh_plan=None):
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.config = config
        self.params = params
        self._leaves = named_leaves(params)
        leaves = list(self._leaves.values())
        for t in leaves:
            if not t.is_leaf or t.dtype != torch.float32:
                raise ValueError("params must be float32 leaf tensors")
            t.requires_grad_(True)
        self.device = leaves[0].device
        self.optimizer, self.schedule = build_optimizer(config.train,
                                                        config.model.d_model, self._leaves)
        self.step = 0
        self._train_step = make_train_step(config, self.optimizer)
        self._eval_step = make_eval_step(config)
        if mesh_plan is not None:
            mesh_plan.replicate(params)
            self._train_step = mesh_plan.shard_train_step(self._train_step)
            self._eval_step = mesh_plan.shard_eval_step(self._eval_step)
        self.report = report or ReportManager()
        self.checkpointer = checkpointer
        self.early_stopping = early_stopping
        self.key = prng.PRNGKey(config.train.seed)

    @property
    def state(self) -> TrainState:
        """The live tensors (not copies)."""
        return TrainState(self.params, self.optimizer.state, self.step)

    @state.setter
    def state(self, state: TrainState) -> None:
        """Copy a state (e.g. a restored checkpoint) into this trainer's
        tensors, matched by param key."""
        src = named_leaves(state.params)
        if set(src) != set(self._leaves):
            raise ValueError("the state's params differ from the trainer's")
        with torch.no_grad():
            for key, dst in self._leaves.items():
                dst.copy_(src[key])
        self.optimizer.load_state(state.opt_state)
        self.step = int(state.step)

    def train_step(self, batch: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """One optimizer step on a numpy (A, B, ...) batch, keyed by the next
        step key: self.key, step key = split(self.key)."""
        self.key, step_key = prng.split(self.key)
        metrics = self._train_step(self.params, batch_to_device(batch, self.device),
                                   step_key)
        self.step += 1
        return metrics

    def train(self, train_iter: Iterator, valid_iter_fn: Callable[[], Iterable] | None = None,
              steps: int | None = None) -> TrainState:
        cfg = self.config.train
        steps = steps or cfg.train_steps
        stats = Statistics()
        while self.step < steps:
            metrics = self.train_step(next(train_iter))
            step = self.step
            _update_stats(stats, metrics)
            self.report.report_training(step, stats,
                                        host_lr(cfg, self.config.model.d_model, step - 1))
            if valid_iter_fn is not None and step % cfg.valid_every == 0:
                vstats = self.validate(valid_iter_fn(), step)
                if self.early_stopping is not None and self.early_stopping.update(vstats):
                    self.report.log.info("early stopping at step %d (best %s=%.4f)",
                                         step, self.early_stopping.metric,
                                         self.early_stopping.best)
                    break
            if self.checkpointer is not None and step % cfg.save_every == 0:
                self.checkpointer.save(step, self.state)
        return self.state

    def validate(self, valid_iter: Iterable, step: int) -> Statistics:
        vstats = Statistics()
        for batch in valid_iter:
            _update_stats(vstats, self._eval_step(self.params,
                                                  batch_to_device(batch, self.device)))
        self.report.report_validation(step, vstats)
        return vstats
