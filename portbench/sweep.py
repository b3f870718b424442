"""The engine's rate against its batch, to fix a serving cell's batch.

    python3 -m portbench.sweep --workload <name> --batches 512,1024,... \
        [--seconds 10] [--seed 5]

For each batch (chunks a device batch), in one process: the cell's
engine built at that batch, warmed up, and run for one window over the
cell's traffic; prints the basecall rate, the decode steps a batch, the
engine's dispatch share and the peak device memory, one JSON line each.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import run


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--batches", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--seed", type=int, default=5)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    from portbench import serve

    spec = run.cell_spec(args.workload)
    flat = run.load_flat(spec["config"])
    for b in (int(x) for x in args.batches.split(",")):
        torch.cuda.reset_peak_memory_stats()
        traffic = dict(spec["traffic"], batch_chunks=b)
        cell = serve.ServeCell(spec["config"], traffic, flat, "cuda")
        cell.warm()
        win = cell.window(args.seed, args.seconds)
        st = win.stages
        samples, window_s = win.rate_window()
        print(json.dumps({
            "batch_chunks": b,
            "ksamples_per_s": samples / window_s / 1e3,
            "batches": len(win.batches),
            "steps_per_batch": sum(x[2] for x in win.batches) / max(len(win.batches), 1),
            "dispatch_share": st["dispatch"]["total_sec"] / st["wall"]["total_sec"],
            "ingest_wait_share": st["ingest-wait"]["total_sec"] / st["wall"]["total_sec"],
            "memory_peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)
        cell.free()
        del cell
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    stop_ingest_processes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
