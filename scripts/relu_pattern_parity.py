"""Card-vs-CPU gradients of chip_smoke.py phase 13 (a)'s parity steps, held
as that phase holds them, and again with the CPU's FFN ReLUs given the
card's pattern (input > 0, recorded in the card's step), to tell a
difference of arithmetic from a ReLU input within rounding of 0 taking
the other side.

The flagship params (bench_results/flagship_params.npz), batch 8, f32
without TF32, Adam at a constant lr 4e-5, each step from the card's
state; at dropout 0.1 (keyed masks, drawn with R1 on the card) and then
at dropout 0.  Prints `parity_gradients`'s line for each step and side,
and FAILS where its gates do not hold; exits 0 either way.  Needs a CUDA
card; imports no JAX:

    python scripts/relu_pattern_parity.py [--steps 3]
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import os
import sys

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402
from nanodecoder_tpu_torch.models import modules  # noqa: E402


@contextlib.contextmanager
def relu_pattern(store: list, replay: bool):
    """While active, every FFN records its ReLU pattern into `store` (one
    bool tensor an FFN call, on the host), or with `replay` takes the
    recorded ones in order in place of its own."""
    real = modules.ffn
    recorded = iter(list(store))

    def ffn(p, x, dropout_rate=0.0, rng=None, train=False, row0=0):
        pre = modules.dense(p["in"], x)
        if replay:
            keep = next(recorded).to(pre.device)
        else:
            keep = (pre > 0).detach()
            store.append(keep.cpu())
        h = torch.where(keep, pre, torch.zeros((), dtype=pre.dtype, device=pre.device))
        return modules.dense(p["out"], modules.dropout(h, dropout_rate, rng, train, row0))

    modules.ffn = ffn
    try:
        yield
    finally:
        modules.ffn = real


def main() -> int:
    from nanodecoder_tpu_torch.train.checkpoint import load_params_npz
    from nanodecoder_tpu_torch.train.data import synthetic_batches

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=3)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("relu_pattern_parity: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    for dropout in (0.1, 0.0):
        cfg = cs.train_config(cs.PARITY_BATCH, dropout=dropout)
        cfg = dataclasses.replace(cfg, train=dataclasses.replace(
            cfg.train, optimizer="adam", lr_schedule="constant",
            learning_rate=cs.PARITY_LR))
        it = synthetic_batches(cfg, seed=0)
        card, cpu, pinned = (cs.quiet_trainer(cfg, load_params_npz(cs.NPZ, cfg.model,
                                                                   device=d))
                             for d in (dev, "cpu", "cpu"))
        for i in range(args.steps):
            batch = next(it)
            cpu.state = pinned.state = card.state
            pattern: list = []
            with relu_pattern(pattern, replay=False):
                card.train_step(batch)
            cpu.train_step(batch)
            with relu_pattern(pattern, replay=True):
                pinned.train_step(batch)
            gg = cs.host_leaves(card.params, grad=True)
            for label, other in (("CPU", cpu), ("CPU with the card's ReLU pattern", pinned)):
                try:
                    cs.parity_gradients(i + 1, gg, cs.host_leaves(other.params, grad=True),
                                        f"dropout {dropout}, card vs {label}")
                except cs.SmokeError as e:
                    print(f"  FAILS: {e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
