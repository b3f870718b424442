"""Multi-process bootstrap and per-rank work partitioning (the port's
counterpart of `nanodecoder_tpu.parallel.multihost`).

One process per card, as torch.distributed runs: `torchrun` (or a
launcher that sets the same variables) starts the ranks, and
`initialize_multihost` joins them into the default process group.
Basecalling is share-nothing: each rank owns a static, strided slice of
the sorted input files and writes its own FASTQ shard
(`out.fastq.shard00003`); after a barrier, rank 0 concatenates the
shards into the output.  Data-parallel training uses the group through
`parallel.mesh.MeshPlan`.
"""

from __future__ import annotations

import os

import torch
import torch.distributed as dist

from nanodecoder_tpu_torch.device import resolve_device
from nanodecoder_tpu_torch.utils.logging import get_logger

log = get_logger("multihost")


def _env_int(name: str, default: int) -> int:
    value = os.environ.get(name)
    return default if value is None or value == "" else int(value)


def local_device(cpu: bool = False) -> torch.device:
    """This rank's device: the CPU when asked, else card LOCAL_RANK of this
    host (modulo the cards present, so ranks that outnumber the cards
    share them); raises without a card."""
    if cpu:
        return torch.device("cpu")
    resolve_device("cuda")
    return torch.device("cuda", _env_int("LOCAL_RANK", 0) % torch.cuda.device_count())


def _default_backend(device: torch.device) -> str:
    """gloo for the CPU and for ranks that share a card (NCCL refuses two
    ranks on one device), else NCCL."""
    if device.type != "cuda":
        return "gloo"
    local_ranks = _env_int("LOCAL_WORLD_SIZE", 1)
    if local_ranks > torch.cuda.device_count():
        log.warning("%d ranks share %d card(s): gloo, which stages each collective "
                    "through host memory, in place of NCCL", local_ranks,
                    torch.cuda.device_count())
        return "gloo"
    return "nccl"


def initialize_multihost(coordinator: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None,
                         backend: str | None = None,
                         device: torch.device | None = None) -> tuple[int, int]:
    """Join the default process group when running multi-process (or when
    given a `coordinator`); a no-op in one process.  Returns (rank, world
    size).

    The rank and world size come from the arguments or from RANK and
    WORLD_SIZE (set by torchrun); the rendezvous from `coordinator`
    ("host:port", or any init URL such as tcp://host:port or
    file:///shared/path) or else from MASTER_ADDR and MASTER_PORT.
    `backend` defaults to NCCL on `device` (default `local_device()`,
    which raises without a card), or gloo where it is the CPU or where
    ranks share a card; with NCCL, `device` becomes this process's
    current card before the group starts."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    world = num_processes if num_processes is not None else _env_int("WORLD_SIZE", 1)
    if world <= 1 and coordinator is None:
        return 0, 1
    rank = process_id if process_id is not None else _env_int("RANK", 0 if world == 1 else -1)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}: set RANK "
                         f"(torchrun does) or pass process_id")
    init = coordinator or "env://"
    if "://" not in init:
        init = f"tcp://{init}"
    kwargs = {}
    if backend != "gloo":
        device = device if device is not None else local_device()
        backend = backend or _default_backend(device)
    if backend == "nccl":
        torch.cuda.set_device(device)
        kwargs["device_id"] = device
    dist.init_process_group(backend, init_method=init, rank=rank, world_size=world,
                            **kwargs)
    log.info("rank %d / %d: %s", rank, world, backend)
    return rank, world


def shutdown_multihost() -> None:
    """Leave the process group (where one was joined)."""
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def _rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def _world() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def partition_files_for_host(files: list[str], process_index: int | None = None,
                             process_count: int | None = None) -> list[str]:
    """Static strided partition of the (sorted) input file list: every
    rank basecalls a disjoint subset, deterministic given the list."""
    pid = _rank() if process_index is None else process_index
    pcount = _world() if process_count is None else process_count
    return files[pid::pcount]


def host_shard_path(out_path: str, process_index: int | None = None) -> str:
    """Per-rank output shard name: out.fastq -> out.fastq.shard00003."""
    pid = _rank() if process_index is None else process_index
    return f"{out_path}.shard{pid:05d}"


def merge_host_shards(out_path: str, process_count: int | None = None,
                      process_index: int | None = None) -> None:
    """Rank 0 concatenates the shards into `out_path`, in rank order, and
    deletes them with their done logs (call after `barrier`); the other
    ranks return at once."""
    from nanodecoder_tpu_torch.io.fastx import merge_fastx_shards

    pid = _rank() if process_index is None else process_index
    if pid != 0:
        return
    pcount = _world() if process_count is None else process_count
    shards = [host_shard_path(out_path, i) for i in range(pcount)]
    shards = [s for s in shards if os.path.exists(s)]
    merge_fastx_shards(shards, out_path, delete_shards=True)
    for s in shards:
        if os.path.exists(s + ".done"):
            os.unlink(s + ".done")
    log.info("merged %d shards -> %s", len(shards), out_path)


def barrier(name: str = "barrier") -> None:
    """Wait for every rank (a no-op in one process)."""
    if _world() == 1:
        return
    log.debug("barrier %s", name)
    dist.barrier()
