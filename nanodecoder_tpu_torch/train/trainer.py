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

On a CUDA device without a mesh plan the trainer captures the whole
step (every micro-batch's forward, loss and backward, the clip and the
update) as one CUDA graph a batch shape and replays it, as the JAX
package compiles its step into one program.  A shape's first step runs
eagerly, on the stream the capture then uses (the warm-up: a real step
with its own key); its second is captured and replayed, and every later
one replayed.  Before a replay the host copies the batch from pinned
staging (two buffers, taken in turn) into the graph's static inputs,
writes the step's dropout keys (`step_draw_keys`, in R1's launch order)
into the graph's key table, which R1's table-keyed kernel reads, and
the optimizer's lr and bias corrections into its device scalars; the
step reads nothing back on the host.  The metrics are returned as
copies that the next replay does not overwrite.  Data-parallel steps
and steps on the CPU stay eager.

While the span recorder of utils/profiling.py is on, each step is a
`train.step` span (with the trainer's step number) holding `train.h2d`
(the batch's copy to the device, or into the graph's inputs), then on
an eager step `train.forward` and `train.backward` (one each a
micro-batch) and `train.update` (the clip and the optimizer's update),
on a captured one `train.capture` (holding the captured step's
forward, backward and update spans) and `train.replay`, and on a
replayed one `train.replay`.  `graph_captures` and `graph_replays`
count them, on the trainer and in utils/profiling's counters.
"""

from __future__ import annotations

from typing import Any, Callable, Iterable, Iterator, NamedTuple

import numpy as np
import torch

from nanodecoder_tpu_torch import prng
from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.models.model import (decode_teacher_forced, dropout_draw_keys,
                                                encode, named_leaves)
from nanodecoder_tpu_torch.ops.threefry import key_words, keys_from_table
from nanodecoder_tpu_torch.train.loss import guided_attention_loss, loss_and_metrics
from nanodecoder_tpu_torch.train.optim import Optimizer, build_optimizer, host_lr
from nanodecoder_tpu_torch.utils.profiling import count, span
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


def step_draw_keys(config: Config, key, accum: int) -> np.ndarray:
    """The key of each dropout draw of a train step under the step key
    `key` with `accum` micro-batches, in launch order: micro-batch i's
    draws under split(key, accum)[i] (`dropout_draw_keys`).  (draws, 2)
    uint32."""
    keys = [k for rng in prng.split(key, accum)
            for k in dropout_draw_keys(config.model, rng)]
    return np.array(keys, dtype=np.uint32).reshape(len(keys), 2)


def make_step_body(config: Config, optimizer: Optimizer) -> Callable:
    """body(params, batch, key, plan=None): a train step's device work, the
    forward and backward of each micro-batch, then (with a MeshPlan) the
    all-reduce, then `optimizer.update()`; it reads nothing on the host,
    so a CUDA graph may capture it.  Returns the metrics summed over
    micro-batches (0-d tensors).  Arguments as `make_train_step`'s."""
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

    def body(params, batch: dict[str, torch.Tensor], key, plan=None):
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
            with span("train.forward"):
                loss, metrics = micro_loss(params, {k: v[i, rows] for k, v in batch.items()},
                                           rng, inv_total, share / accum, rows.start)
            with span("train.backward"):
                loss.backward()
            metrics = {k: metrics[k].detach() for k in METRIC_KEYS}
            summed = metrics if summed is None else \
                {k: summed[k] + metrics[k] for k in METRIC_KEYS}
        if plan is not None:
            plan.all_reduce_grads(optimizer.params.values())
            summed = plan.sum_metrics(summed)
        with span("train.update"):
            optimizer.update()
        return summed

    return body


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
    body = make_step_body(config, optimizer)

    def train_step(params, batch: dict[str, torch.Tensor], key, plan=None):
        optimizer.prepare()
        summed = body(params, batch, key, plan)
        optimizer.advance()
        return summed

    return train_step


class _StepGraph:
    """A train step captured for one batch shape: the static device inputs
    (the batch and the key table), two pinned staging buffers that feed
    them in turn, the graph and its static metrics."""

    def __init__(self, batch: dict[str, np.ndarray], n_keys: int, device: torch.device):
        self.static = batch_to_device(batch, device)
        self.table = torch.zeros((n_keys, 2), dtype=torch.int32, device=device)
        self.staging = [({k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
                          for k, v in self.static.items()},
                         torch.empty((n_keys, 2), dtype=torch.int32, pin_memory=True),
                         torch.cuda.Event()) for _ in range(2)]
        self.turn = 0
        self.graph: torch.cuda.CUDAGraph | None = None
        self.metrics: dict[str, torch.Tensor] = {}

    def load(self, batch: dict[str, np.ndarray], keys: np.ndarray) -> None:
        """Copy a step's batch and keys into the static inputs, through the
        next staging buffer, once the copies that last read it are done."""
        host, table, done = self.staging[self.turn]
        self.turn ^= 1
        done.synchronize()
        for k, v in batch.items():
            np.copyto(host[k].numpy(), v)
            self.static[k].copy_(host[k], non_blocking=True)
        np.copyto(table.numpy(), keys.view(np.int32))
        self.table.copy_(table, non_blocking=True)
        done.record()

    def capture(self, body: Callable, params, key, keys: np.ndarray,
                stream: torch.cuda.Stream) -> None:
        """Capture body(params, the static batch, key) on `stream`, its
        draws keyed by the table's rows; raises if the draws it made were
        not keyed as `keys`, the table the host writes for them."""
        graph = torch.cuda.CUDAGraph()
        with keys_from_table(self.table) as drawn:
            with torch.cuda.graph(graph, stream=stream, capture_error_mode="thread_local"):
                self.metrics = body(params, self.static, key)
        if drawn != [key_words(k) for k in keys]:
            raise RuntimeError(f"the captured step drew {len(drawn)} times under keys other "
                               f"than the {len(keys)} of step_draw_keys")
        self.graph = graph


def _batch_shape(batch: dict[str, np.ndarray]) -> tuple:
    return tuple((k, np.shape(v), np.asarray(v).dtype.str) for k, v in sorted(batch.items()))


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
        self._step_body = make_step_body(config, self.optimizer)
        self._train_step = make_train_step(config, self.optimizer)
        self._eval_step = make_eval_step(config)
        # The captured steps by batch shape (None: seen once, eager so far);
        # None for a trainer whose steps all stay eager.
        self._graphs: dict | None = \
            {} if self.device.type == "cuda" and mesh_plan is None else None
        self._stream: torch.cuda.Stream | None = None
        self.graph_captures = self.graph_replays = 0
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
        step key: self.key, step key = split(self.key).  Eager, or through
        the batch shape's CUDA graph (the module docstring)."""
        self.key, step_key = prng.split(self.key)
        with span("train.step", step=self.step):
            if self._graphs is None:
                metrics = self._eager_step(batch, step_key)
            else:
                metrics = self._graph_step(batch, step_key)
        self.step += 1
        return metrics

    def _eager_step(self, batch: dict[str, np.ndarray], step_key) -> dict[str, torch.Tensor]:
        with span("train.h2d"):
            batch = batch_to_device(batch, self.device)
        return self._train_step(self.params, batch, step_key)

    def _graph_step(self, batch: dict[str, np.ndarray], step_key) -> dict[str, torch.Tensor]:
        shape = _batch_shape(batch)
        if self._stream is None:
            self._stream = torch.cuda.Stream(self.device)
        main = torch.cuda.current_stream(self.device)
        if shape not in self._graphs:  # the warm-up: eager, on the capture's stream
            self._graphs[shape] = None
            self._stream.wait_stream(main)
            with torch.cuda.stream(self._stream):
                metrics = self._eager_step(batch, step_key)
            main.wait_stream(self._stream)
            return metrics
        keys = step_draw_keys(self.config, step_key, np.shape(batch["signal"])[0])
        graph = self._graphs[shape]
        if graph is None:
            graph = self._graphs[shape] = _StepGraph(batch, len(keys), self.device)
        with span("train.h2d"):
            graph.load(batch, keys)
        if graph.graph is None:
            with span("train.capture"):
                graph.capture(self._step_body, self.params, step_key, keys, self._stream)
            self.graph_captures += 1
            count("train.graph_captures")
        with span("train.replay"):
            self.optimizer.prepare()
            graph.graph.replay()
            self.optimizer.advance()
            metrics = {k: v.clone() for k, v in graph.metrics.items()}
        self.graph_replays += 1
        count("train.graph_replays")
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
