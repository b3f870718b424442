"""Data parallelism over torch.distributed (the port's counterpart of
`nanodecoder_tpu.parallel.mesh`).

The JAX package runs one controller over a mesh with one `data` axis:
weights replicated, the batch sharded on its leading axis, and XLA's
collectives (the gradient psum) inserted from the shardings.  PyTorch
runs one process per card, so here the `data` axis is the ranks of a
process group.  The rule that keeps the two alike: every rank sees the
whole host batch, as the JAX controller sees the global array;
`shard_batch` takes this rank's rows (rank r of W holds rows
[r B/W, (r+1) B/W); B must divide by W, as JAX's sharding requires), and
each program's outputs are gathered, so every rank returns the global
result.

  * decode (`shard_decode_fn`): each rank decodes its rows (a row's beams
    stay on its rank) and the outputs are all-gathered, packed as bytes
    into one buffer: one collective a batch, whatever the dtypes (neither
    NCCL nor gloo takes int16), which can carry each rank's stop flag
    (the streaming engine's, so that every rank leaves on the same batch);
  * training (`shard_train_step`): forward and backward on this rank's
    rows of every micro-batch, one all-reduce (sum) of the gradients
    flattened into one buffer, then the same optimizer update on every
    rank; the loss stays the global batch's function (see
    `train.trainer.make_train_step`), and the metrics are summed;
  * validation (`shard_eval_step`): metrics summed over the ranks.

Random draws follow the same rule: every rank holds the same threefry
keys (the JAX package replicates its key) and draws its rows of the
global array, the dropout masks of a micro-batch or the sampling noise
of a batch, at their counter offset (`prng`), as JAX's partitionable
threefry draws one array whatever the sharding.

Without a process group (one process) every collective is the identity,
so a plan there runs as one device; in a group of one rank the
collectives run (NCCL or gloo copies).  Each rank holds one device (the
card `cuda:LOCAL_RANK`, or the CPU): the plan's collectives run on the
tensors where they lie, NCCL on cards, gloo on the CPU and where ranks
share a card (gloo takes CUDA tensors for broadcast, all-reduce and
all-gather, staging them through host memory).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Iterable

import torch
import torch.distributed as dist

from nanodecoder_tpu_torch.config import MeshConfig
from nanodecoder_tpu_torch.models.model import named_leaves


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    return t.contiguous().view(-1).view(torch.uint8)


@dataclasses.dataclass
class MeshPlan:
    """The `data` axis as the ranks of `group` (None: the default group)."""

    data_axis: str = "data"
    group: Any = None

    @property
    def _active(self) -> bool:
        return dist.is_available() and dist.is_initialized()

    @property
    def n_devices(self) -> int:
        return dist.get_world_size(self.group) if self._active else 1

    @property
    def rank(self) -> int:
        return dist.get_rank(self.group) if self._active else 0

    # --- shardings ------------------------------------------------------

    def row_slice(self, n: int) -> slice:
        """This rank's rows of a batch of `n`."""
        w = self.n_devices
        if n % w:
            raise ValueError(f"a batch of {n} rows does not shard over {w} ranks "
                             f"on the {self.data_axis!r} axis")
        per = n // w
        return slice(self.rank * per, (self.rank + 1) * per)

    def shard_batch(self, batch: Any) -> Any:
        """This rank's rows (leading axis) of an array, or of every array of
        a dict (a host batch)."""
        if isinstance(batch, dict):
            return {k: self.shard_batch(v) for k, v in batch.items()}
        return batch[self.row_slice(batch.shape[0])]

    @torch.no_grad()
    def replicate(self, params: Any) -> Any:
        """Make every tensor of a params tree equal to rank 0's, in place
        (one broadcast per dtype); returns `params`."""
        if not self._active:
            return params
        by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
        for t in named_leaves(params).values():
            by_dtype.setdefault(t.dtype, []).append(t)
        for ts in by_dtype.values():
            buf = torch.cat([t.reshape(-1) for t in ts])
            src = 0 if self.group is None else dist.get_global_rank(self.group, 0)
            dist.broadcast(buf, src=src, group=self.group)
            for t, part in zip(ts, buf.split([t.numel() for t in ts])):
                t.copy_(part.view_as(t))
        return params

    # --- collectives ----------------------------------------------------

    @torch.no_grad()
    def gather_rows(self, outs: Any, stop: bool | None = None) -> Any:
        """All-gather the rows of a tensor or a tuple of tensors (each with
        the same shape on every rank), in rank order: one collective on
        all outputs packed as bytes.  With `stop` (this rank's flag), one
        more byte rides in the same collective and the result is
        (gathered, whether any rank's flag was set): ranks that stop on
        it all leave after the same collective."""
        single = isinstance(outs, torch.Tensor)
        parts = (outs,) if single else tuple(outs)
        if not self._active:
            return outs if stop is None else (outs, stop)
        w = self.n_devices
        raw = [_as_bytes(t) for t in parts]
        flag = [] if stop is None else [torch.full((1,), int(stop), dtype=torch.uint8,
                                                   device=raw[0].device)]
        buf = torch.cat(raw + flag)
        every = [torch.empty_like(buf) for _ in range(w)]
        dist.all_gather(every, buf, group=self.group)
        every = torch.stack(every)
        gathered, start = [], 0
        for t, r in zip(parts, raw):
            cols = every[:, start:start + r.numel()]
            start += r.numel()
            # A copy each: a rank's row starts at any byte offset.
            rows = [c.clone().view(t.dtype).view(t.shape) for c in cols]
            gathered.append(torch.cat(rows))
        result = gathered[0] if single else tuple(gathered)
        return result if stop is None else (result, bool(every[:, -1].any()))

    @torch.no_grad()
    def all_reduce_grads(self, params: Iterable[torch.Tensor]) -> None:
        """Sum every parameter's `.grad` (None counts as zero) over the
        ranks: one all-reduce of the gradients flattened into one buffer."""
        params = list(params)
        if not self._active:
            return
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        buf = torch.cat([g.reshape(-1) for g in grads])
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        for p, part in zip(params, buf.split([g.numel() for g in grads])):
            p.grad = part.view_as(p)

    @torch.no_grad()
    def sum_metrics(self, metrics: dict[str, torch.Tensor]) -> dict[str, torch.Tensor]:
        """Each 0-d metric summed over the ranks (one all-reduce in f64,
        exact for counts), back in its own dtype."""
        if not self._active:
            return metrics
        keys = list(metrics)
        vec = torch.stack([metrics[k].to(torch.float64) for k in keys])
        dist.all_reduce(vec, op=dist.ReduceOp.SUM, group=self.group)
        return {k: vec[i].to(metrics[k].dtype) for i, k in enumerate(keys)}

    # --- sharded programs -------------------------------------------------

    def shard_decode_fn(self, fn: Callable) -> Callable:
        """`fn(signal, lengths, *extra, rows=slice)` decodes rows `rows` of
        the batch it is given (in sample mode with the whole batch's noise)
        and returns a tensor or a tuple of tensors of those rows.  The
        result takes the whole host batch, decodes this rank's rows and
        returns every rank's, gathered; given `stop=` (this rank's flag),
        it returns (gathered, any rank's flag), as `gather_rows`."""
        def sharded(signal, lengths, *extra, stop: bool | None = None):
            return self.gather_rows(fn(signal, lengths, *extra,
                                       rows=self.row_slice(len(signal))), stop=stop)
        return sharded

    def shard_train_step(self, step_fn: Callable) -> Callable:
        """`step_fn(params, batch, key, plan=)` from
        `train.trainer.make_train_step`, run on this rank's rows of the
        whole host batch with the gradients summed over the ranks."""
        return functools.partial(step_fn, plan=self)

    def shard_eval_step(self, eval_fn: Callable) -> Callable:
        """`eval_fn(params, batch, plan=)` from
        `train.trainer.make_eval_step`, with the metrics summed."""
        return functools.partial(eval_fn, plan=self)


def make_mesh_plan(cfg: MeshConfig | None = None, group=None) -> MeshPlan:
    """The plan over `group` (None: the default group, or one process when
    none was started).  `cfg.num_devices`, when set, must equal the
    group's size."""
    cfg = cfg or MeshConfig()
    plan = MeshPlan(data_axis=cfg.data_axis, group=group)
    if cfg.num_devices and cfg.num_devices != plan.n_devices:
        raise ValueError(f"mesh.num_devices is {cfg.num_devices} but the process "
                         f"group has {plan.n_devices} ranks")
    return plan

