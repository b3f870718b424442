"""Training CLI (the port's counterpart of `nanodecoder_tpu.cli.train`).

    python -m nanodecoder_tpu_torch.cli.train --ckpt-dir ckpts --steps 5000 \
        [--config config.json] [--data shards/] [--resume] [--cpu]

Trains on the CUDA card; --cpu is the only way onto the CPU, and without
a card and without --cpu the command fails.  Params start from
`init_model(PRNGKey(train.seed))`, the JAX package's own init (drawn on
the CPU, so the card and the CPU start alike) or from --init-npz.  Batches come from preprocessed shards
(--data) or from the simulator, one producer thread behind a queue or
--data-workers seeded streams interleaved; with the simulator, the run
validates every `valid_every` steps on 4 simulated batches (the encoder
through kernel K5 when `use_pallas` is set).  Checkpoints go to
--ckpt-dir every `save_every` steps and at the end, also on SIGTERM or
Ctrl-C; --resume continues from the latest one, the port's or the JAX
package's (an orbax step, read without JAX; later saves go beside it and
never replace it).  --metrics appends JSON
records and --tensorboard writes TensorBoard scalars.

Data-parallel training over more than one rank (one process per card):

    torchrun --nproc_per_node 4 -m nanodecoder_tpu_torch.cli.train \
        --ckpt-dir ckpts --data shards/

Every rank reads the same batches and trains on its rows of each
(`parallel.mesh.MeshPlan`, the config's `mesh` section; batch_size must
divide by the ranks), the gradients summed over the ranks before each
update; rank 0 alone reports to --metrics / --tensorboard and writes the
checkpoints.  --data-workers above 1 is refused there (its interleaved
streams have no fixed order, so ranks would see different batches).
"""

from __future__ import annotations

import argparse
import dataclasses
import signal
import sys

import torch

from nanodecoder_tpu_torch.config import Config
from nanodecoder_tpu_torch.models.model import init_model, param_count, params_to
from nanodecoder_tpu_torch.parallel.mesh import make_mesh_plan
from nanodecoder_tpu_torch.prng import PRNGKey
from nanodecoder_tpu_torch.parallel.multihost import (initialize_multihost, local_device,
                                                      shutdown_multihost)
from nanodecoder_tpu_torch.train.checkpoint import CheckpointManager, load_params_npz
from nanodecoder_tpu_torch.train.data import (interleave_batches, prefetch_batches,
                                              synthetic_batches, synthetic_valid_batches)
from nanodecoder_tpu_torch.train.shards import shard_batches
from nanodecoder_tpu_torch.train.trainer import Trainer
from nanodecoder_tpu_torch.utils.logging import get_logger
from nanodecoder_tpu_torch.utils.report import ReportManager


def build_argparser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description="Train the basecaller on a CUDA card")
    ap.add_argument("--ckpt-dir", required=True)
    ap.add_argument("--config", default="", help="JSON config (default: flagship)")
    ap.add_argument("--steps", type=int, default=0, help="override train_steps")
    ap.add_argument("--data", default="", help="preprocessed .npz shard dir "
                    "(default: synthetic simulator)")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--init-npz", default="",
                    help="initialize params from a save_params_npz export "
                         "(shapes must match --config)")
    ap.add_argument("--cpu", action="store_true", help="train on the CPU")
    ap.add_argument("--metrics", default="", help="JSONL metrics path")
    ap.add_argument("--tensorboard", default="",
                    help="TensorBoard event-file dir (a second sink beside "
                         "--metrics; skipped with a warning where tensorboard is "
                         "not installed)")
    ap.add_argument("--report-every", type=int, default=50)
    ap.add_argument("--data-workers", type=int, default=1,
                    help="simulator threads (1 = one deterministic producer "
                         "behind a queue; >1 interleaves per-seed streams)")
    ap.add_argument("--dist-init", default="",
                    help="rendezvous of a multi-rank run (tcp://host:port or "
                         "file:///shared/path; default: torchrun's MASTER_ADDR and "
                         "MASTER_PORT); rank and world size from RANK and WORLD_SIZE")
    return ap


def _interrupt(*_):
    raise KeyboardInterrupt


def main(argv=None) -> int:
    args = build_argparser().parse_args(argv)
    device = local_device(args.cpu)  # raises without a card unless --cpu
    rank, world = initialize_multihost(args.dist_init or None,
                                       backend="gloo" if args.cpu else None, device=device)
    try:
        return _train(args, device, rank, world)
    finally:
        shutdown_multihost()


def _train(args, device: torch.device, rank: int, world: int) -> int:
    log = get_logger("train-cli")
    config = Config()
    if args.config:
        with open(args.config) as f:
            config = Config.from_json(f.read())
    if args.steps:
        config = dataclasses.replace(
            config, train=dataclasses.replace(config.train, train_steps=args.steps))
    if world > 1 and args.data_workers > 1 and not args.data:
        log.error("--data-workers > 1 interleaves its streams in no fixed order, so "
                  "%d ranks would train on different batches", world)
        return 2
    if args.init_npz:
        params = load_params_npz(args.init_npz, config.model, device)
        log.info("initialized params from %s", args.init_npz)
    else:
        params = params_to(init_model(PRNGKey(config.train.seed), config.model), device)
    log.info("model: %.2fM params on %s", param_count(params) / 1e6, device)

    lead = rank == 0
    report = ReportManager(report_every=args.report_every,
                           metrics_path=(args.metrics or None) if lead else None,
                           tensorboard_dir=(args.tensorboard or None) if lead else None)
    ckpt = CheckpointManager(args.ckpt_dir, config,
                             max_to_keep=config.train.keep_checkpoints)
    plan = make_mesh_plan(config.mesh) if world > 1 else None
    trainer = Trainer(config, params, report=report, checkpointer=ckpt if lead else None,
                      mesh_plan=plan)
    restored = None
    if args.resume and ckpt.latest() is not None:
        trainer.state = ckpt.restore(device=device)
        restored = trainer.step
        log.info("resumed at step %d", trainer.step)

    if args.data:
        if args.data_workers > 1:
            log.warning("--data-workers=%d is ignored with --data (shards are read "
                        "by one producer behind a queue)", args.data_workers)
        train_iter = prefetch_batches(shard_batches(args.data, config))
        valid_fn = None
    else:
        if args.data_workers > 1:
            seeds = tuple(config.train.seed + i for i in range(args.data_workers))
            train_iter = interleave_batches(config, seeds)
        else:
            train_iter = prefetch_batches(synthetic_batches(config,
                                                            seed=config.train.seed))
        valid = synthetic_valid_batches(config)
        valid_fn = lambda: iter(valid)  # noqa: E731

    # SIGTERM -> KeyboardInterrupt, so a terminated run still writes its
    # final checkpoint.
    signal.signal(signal.SIGTERM, _interrupt)
    try:
        trainer.train(train_iter, valid_iter_fn=valid_fn)
    except KeyboardInterrupt:
        log.info("interrupted: saving the checkpoint of step %d", trainer.step)
    # The final save, unless this run already saved this step or restored
    # it and trained no further (it may be a JAX step, which save refuses).
    if lead and trainer.step not in (ckpt.last_saved, restored):
        ckpt.save(trainer.step, trainer.state)
    report.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
