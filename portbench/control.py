"""The readings that the limits of `correct` are set from.

    python3 -m portbench.control --workload <name> --seeds 1,2,3 [--seconds 4]
        [--route kernels|plain] [--config <name>|<path>.json] [--control float8|tf32]
        [--fault state_unchanged|token_altered|half_batch]

For each seed, in one process (one set-up for a serving cell): the
numbers the cell compares, as a run of the program gives them, and with
--control the same numbers of the reference put in the program's place
at the precision below the configuration's (serving: float8, the gap of
the token it puts first; training: TF32).  A serving window here is
short, at the cell's load: the stream runs on until it has given the
compared reads.  --route plain runs the program with use_pallas false;
--config runs another configuration on the cell's traffic and limits: a
name under portbench/configs/ (the MHA diagnosis: the same function in
MQA form), or the path of a configuration file from the checkout's root
(one that BENCHMARK.json does not list yet).  --fault plants one of the
faults the checks must catch, in the program (serving) or in the
reference put in its place (training's half batch).  One JSON line a
seed.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import sys
import time

from portbench import run


@contextlib.contextmanager
def serving_fault(engine, name: str | None):
    """Plant a fault in the serving cell's timed path: a decode step that
    returns its state unchanged, one token of every batch altered where
    the batch's program produces it, or half of every batch left out
    (its rows given the other half's outputs)."""
    if name is None:
        yield
        return
    import torch

    from nanodecoder_tpu_torch.decode import greedy

    saved = []
    if name == "state_unchanged":
        step = greedy.decode_step

        def stuck(params, cfg, tokens, state, *a, **k):
            out = step(params, cfg, tokens, state, *a, **k)
            return (*out[:-1], state)

        saved.append((greedy, "decode_step", step))
        greedy.decode_step = stuck
    elif name in ("token_altered", "half_batch"):
        prog = engine._program

        def broken(wire, lengths, *a, **k):
            tokens, tlens, lps, scores, pos = prog(wire, lengths, *a, **k)
            if name == "token_altered":
                tokens = tokens.clone()
                tokens[0, 0] = 4 + (tokens[0, 0] - 3) % 340
            else:
                h = tokens.shape[0] // 2
                tokens, tlens, lps = (torch.cat([x[:h], x[:tokens.shape[0] - h]])
                                      for x in (tokens, tlens, lps))
            return tokens, tlens, lps, scores, pos

        saved.append((engine, "_program", prog))
        engine._program = broken
    else:
        raise ValueError(f"unknown fault {name!r}")
    try:
        yield
    finally:
        for owner, attr, val in saved:
            setattr(owner, attr, val)


def serve_readings(spec, seeds, seconds, route, control, fault, device="cuda"):
    import torch

    from portbench import serve

    config = spec["config"]
    if route == "plain":
        config = dict(config, serving={
            "model": dict(config["serving"]["model"], use_pallas=False),
            "decode": dict(config["serving"]["decode"], use_pallas=False)})
    cell = serve.ServeCell(config, spec["traffic"], run.load_flat(config), device)
    with serving_fault(cell.engine, fault):
        cell.warm()
        for seed in seeds:
            t0 = time.perf_counter()
            win = cell.window(seed, seconds, plan=cell.plan(seed))
            checks, identity, ctl, extra = serve.judge(cell, win, config, device, control)
            yield {"seed": seed, "checks": checks, "control": ctl, "identity": identity,
                   "correct": all(checks[k] <= v for k, v in spec["limits"].items()),
                   "compared": extra, "wall_s": time.perf_counter() - t0,
                   "reads": win.given}
            if device == "cuda":
                torch.cuda.empty_cache()


def train_readings(spec, seeds, control, fault, device="cuda"):
    from portbench import train

    config, traffic = spec["config"], spec["traffic"]
    flat = run.load_flat(config)
    for seed in seeds:
        t0 = time.perf_counter()
        cell = train.TrainCell(config, traffic, flat, device, seed)
        cell.read_first_steps()
        prog = (cell.losses, cell.grad1, cell.params3)
        cell.free()
        ref = train.reference_readings(config, traffic, flat, seed, device)
        out = {"seed": seed, "checks": train.gaps(prog, ref, flat)}
        if control == "tf32":
            out["control"] = train.gaps(train.reference_readings(
                config, traffic, flat, seed, device, tf32=True), ref, flat)
        if fault == "half_batch":
            out["fault"] = train.gaps(train.reference_readings(
                config, traffic, flat, seed, device, half_batch=True), ref, flat)
        out["correct"] = all(out["checks"][k] <= v for k, v in spec["limits"].items())
        out["wall_s"] = time.perf_counter() - t0
        yield out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=4.0)
    ap.add_argument("--route", choices=["kernels", "plain"], default="kernels")
    ap.add_argument("--config", default=None)
    ap.add_argument("--control", choices=["float8", "bfloat16", "tf32"], default=None)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    spec = run.cell_spec(args.workload)
    if args.config and args.config.endswith(".json"):
        spec["config"] = run.load_json(run.ROOT, args.config)
    elif args.config:
        spec["config"] = run.load_json(run.BENCH, "configs", args.config + ".json")
    seeds = [int(s) for s in args.seeds.split(",")]
    head = {"workload": args.workload, "route": args.route,
            "config": spec["config"]["name"], "fault": args.fault}
    print(json.dumps(head), flush=True)
    if spec["traffic"]["kind"] == "serve":
        lines = serve_readings(spec, seeds, args.seconds, args.route, args.control, args.fault)
    else:
        lines = train_readings(spec, seeds, args.control, args.fault)
    for line in lines:
        print(json.dumps(line), flush=True)
    if spec["traffic"]["kind"] == "serve":
        from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

        stop_ingest_processes()
    return 0


if __name__ == "__main__":
    sys.exit(main())
