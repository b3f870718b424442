"""Training cells: the program's trainer stepping for a fixed window on
simulated batches, and the comparison that decides `correct`.

Set-up builds one `Trainer` on the card from the configuration's weights (the
configuration's train section, the batch of the traffic file, the
dropout keyed from the run's seed) and feeds it the seed's batches
through the program's `prefetch_batches`.  Its first three steps, which
also warm every shape up, are read: each step's mean smoothed loss, the
first clipped gradient as Adam holds it after one step (its first moment
over 1 - b1), and the parameters after the third step.  The window then
steps the same trainer on the same feed.

After the window the reference (`reference.train`) follows the first
three steps from the same weights, batches and keys, and the run is
judged by the worst of: each step's loss against the reference's
(`loss_gap`); each leaf's gradient norm against the reference's, over
that leaf's reference norm or the median leaf's, whichever is larger
(`grad_gap`); each leaf's change over the three steps likewise
(`change_gap`), leaving out the leaves whose reference gradient norm is
under a thousandth of the median leaf's, which move by rounding alone.
"""

from __future__ import annotations

import dataclasses
import json
import time

import numpy as np
import torch

from portbench import sim

READ_STEPS = 3


def batches(seed: int, traffic: dict, config: dict, first: int = 0):
    """The seed's batches from step `first` on, with the trainer's
    accumulation axis (one micro-batch)."""
    m, s = config["config"]["model"], config["config"]["signal"]
    levels = sim.level_table()
    step = first
    while True:
        b = sim.train_batch(seed, step, traffic["batch"], s["chunk_len"],
                            m["max_decode_len"], m["kmer_k"], levels, s)
        yield {k: v[None] for k, v in b.items()}
        step += 1


class TrainCell:
    def __init__(self, config: dict, traffic: dict, flat: dict, device, seed: int):
        from nanodecoder_tpu_torch.config import Config
        from nanodecoder_tpu_torch.train.checkpoint import params_from_numpy
        from nanodecoder_tpu_torch.train.data import prefetch_batches
        from nanodecoder_tpu_torch.train.trainer import Trainer

        cfg = Config.from_json(json.dumps(config["config"]))
        self.cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, batch_size=traffic["batch"], seed=int(seed)))
        self.config, self.traffic, self.flat, self.seed = config, traffic, flat, seed
        self.device = torch.device(device)
        self.trainer = Trainer(self.cfg, params_from_numpy(flat, self.cfg.model, self.device))
        self.feed = prefetch_batches(batches(seed, traffic, config), depth=traffic["prefetch"])
        self.data_wait_s = 0.0
        self.losses: list[float] = []
        self.grad1: dict[str, np.ndarray] = {}
        self.params3: dict[str, np.ndarray] = {}

    def step(self):
        t0 = time.perf_counter()
        batch = next(self.feed)
        self.data_wait_s += time.perf_counter() - t0
        return self.trainer.train_step(batch)

    def read_first_steps(self) -> None:
        from nanodecoder_tpu_torch.train.checkpoint import params_to_numpy

        b1 = self.cfg.train.adam_b1
        for i in range(READ_STEPS):
            m = self.step()
            self.losses.append(float(m["loss_sum"]) / max(float(m["n_tokens"]), 1.0))
            if i == 0:
                mu = self.trainer.optimizer.state["mu"]
                self.grad1 = {k: (v / (1.0 - b1)).cpu().numpy() for k, v in mu.items()}
        self.params3 = {k: v.copy() for k, v in params_to_numpy(self.trainer.params).items()}

    def window(self, seconds: float, tracer=None, trace_steps: range = range(0)):
        """Steps until `seconds` have passed, then waits for the card:
        (steps, seconds from the first step to the card's last op)."""
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        self.data_wait_s = 0.0
        n = 0
        t0 = time.perf_counter()
        while True:
            if tracer is not None and n == trace_steps.start:
                tracer.start()
            if tracer is not None and n == trace_steps.stop:
                tracer.stop()
            self.step()
            n += 1
            if time.perf_counter() - t0 >= seconds and (tracer is None or tracer.trace):
                break
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return n, time.perf_counter() - t0

    def free(self) -> None:
        self.trainer = None
        self.feed.close()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()


def reference_readings(config: dict, traffic: dict, flat: dict, seed: int, device,
                       tf32: bool = False, half_batch: bool = False):
    """The reference's three steps: (losses, first clipped gradients,
    parameters after three steps), as numpy by flat name."""
    from portbench import reference
    from portbench.reference.train import RefTrainer

    m, tr = config["config"]["model"], config["config"]["train"]
    prev = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        flat_t = {k: torch.from_numpy(np.asarray(v, np.float32)).to(device)
                  for k, v in flat.items()}
        rt = RefTrainer(reference.module(config).Ref, flat_t, m, tr, seed,
                        half_batch=half_batch)
        losses, grad1 = [], {}
        it = batches(seed, traffic, config)
        for i in range(READ_STEPS):
            b = {k: torch.from_numpy(v[0]).to(device) for k, v in next(it).items()}
            loss, grads = rt.step(b)
            losses.append(loss)
            if i == 0:
                grad1 = {k: g.cpu().numpy() for k, g in grads.items()}
        params3 = {k: v.detach().cpu().numpy() for k, v in rt.p.items()}
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = prev
    return losses, grad1, params3


def gaps(prog, ref, flat: dict) -> dict[str, float]:
    """The three compared numbers of a run `prog` against the reference
    `ref`, each (losses, first gradients, parameters after three steps)."""
    (pl, pg, pp), (rl, rg, rp) = prog, ref
    loss_gap = max(abs(a - b) / abs(b) for a, b in zip(pl, rl))
    keys = sorted(rg)
    gn = {k: float(np.linalg.norm(rg[k])) for k in keys}
    med_g = float(np.median(list(gn.values())))
    grad_gap = max(abs(float(np.linalg.norm(pg[k])) - gn[k]) / max(gn[k], med_g)
                   for k in keys)
    moved = [k for k in keys if gn[k] >= 1e-3 * med_g]
    rd = {k: float(np.linalg.norm(rp[k] - flat[k])) for k in moved}
    med_d = float(np.median(list(rd.values())))
    change_gap = max(abs(float(np.linalg.norm(pp[k] - flat[k])) - rd[k]) / max(rd[k], med_d)
                     for k in moved)
    return {"loss_gap": loss_gap, "grad_gap": grad_gap, "change_gap": change_gap}
