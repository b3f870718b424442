"""Run one cell of the port's benchmark once and print its result line.

    python3 -m portbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

The cell is looked up by name in BENCHMARK.json; its configuration
(portbench/configs/<config>.json), traffic mix
(portbench/traffic/<traffic>.json), limits (portbench/limits/<workload>.json)
and, with --trace 1, the per-layer metrics BENCHMARK.json lists for it
(portbench/metrics/<name>.py, or for a name `<stem>.<part>` without a
file of its own the shared portbench/metrics/<stem>.py; each a
`read(ctx)` that returns a number or None) are found by name.  The
configuration file names its reference module ("reference", default
`reference/model.py`) and its weights ("params": an `.npz` or a draw,
`portbench/weights.py`).  With --trace 1 the program's span recorder runs
from before set-up to the window's end, and the readers get its spans.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result.  After the window it exits with code 3
and no result where JAX or the JAX package was loaded into this process.

The last line of standard output is the result: correct, attempted,
failed, metrics (the cell's end-to-end metrics, or with --trace 1 its
per-layer ones), device, with --trace 1 a breakdown of the device trace,
and last the checks, each number compared with its limit (also the last
lines of standard error).
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.dirname(os.path.abspath(__file__))
FORBIDDEN = ("jax", "jaxlib", "flax", "nanodecoder_tpu")


def process_age_s() -> float:
    """Seconds since this process started (Linux: /proc)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/uptime") as f:
        uptime = float(f.read().split()[0])
    return uptime - start_ticks / os.sysconf("SC_CLK_TCK")


def load_json(*parts: str) -> dict:
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def cell_spec(workload: str) -> dict:
    bench = load_json(ROOT, "BENCHMARK.json")
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise SystemExit(f"no workload {workload!r} in BENCHMARK.json")
    w = cells[workload]
    conf = {c["name"]: c for c in bench["configs"]}[w["config"]]

    def mine(metrics):
        return [m for m in metrics if workload in m.get("workloads", [workload])]

    return {"workload": w, "config": load_json(ROOT, conf["file"]),
            "traffic": load_json(BENCH, "traffic", w["traffic"] + ".json"),
            "limits": load_json(BENCH, "limits", workload + ".json"),
            "end_to_end": mine(bench["end_to_end"]), "per_layer": mine(bench["per_layer"])}


def metric_reader(name: str):
    path = os.path.join(BENCH, "metrics", name + ".py")
    if not os.path.exists(path) and "." in name:
        path = os.path.join(BENCH, "metrics", name.rsplit(".", 1)[0] + ".py")
    spec = importlib.util.spec_from_file_location("portbench_metric_" + name.replace(".", "_"),
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def set_cache_dirs() -> None:
    """Every build and kernel cache at a fixed path inside the checkout."""
    os.environ["NANODECODER_TORCH_BUILD_DIR"] = os.path.join(ROOT, "nanodecoder_tpu_torch",
                                                             "_build")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(BENCH, "_build", "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(BENCH, "_build", "triton")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def forbidden_modules() -> list[str]:
    return sorted({n.split(".")[0] for n in list(sys.modules)} & set(FORBIDDEN))


def load_flat(config: dict) -> dict:
    from portbench.weights import flat_params

    return flat_params(config, ROOT)


def run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str = "cuda",
             control: str | None = None) -> dict:
    """One run of a cell: set-up, window, the comparison; the result line
    as a dict.  `device` "cpu" serves the benchmark's own tests.  With
    `trace` the program's span recorder runs from before set-up to the
    window's end, and is off again however the run ends."""
    from nanodecoder_tpu_torch.utils import profiling

    if trace:
        profiling.enable()
    try:
        return _run_cell(spec, seed, seconds, trace, device, control)
    finally:
        if trace:
            profiling.disable()


def _run_cell(spec: dict, seed: int, seconds: float, trace: bool, device: str,
              control: str | None) -> dict:
    import torch

    from nanodecoder_tpu_torch.utils import profiling
    from portbench import reference
    from portbench.trace import Tracer

    config, traffic, limits = spec["config"], spec["traffic"], spec["limits"]
    flat = load_flat(config)
    tracer = Tracer() if trace else None
    ctx: dict = {"kind": traffic["kind"], "reference": reference.module(config)}
    t_start = time.perf_counter() - process_age_s()
    if traffic["kind"] == "serve":
        from portbench import serve

        cell = serve.ServeCell(config, traffic, flat, device)
        t_warm = time.perf_counter()
        cell.warm()
        ctx["warmup_s"] = time.perf_counter() - t_warm
        plan = cell.plan(seed)
        t_window = time.perf_counter()
        win = cell.window(seed, seconds, tracer=tracer,
                          trace_batches=range(*traffic["trace_batches"]) if trace else range(0),
                          plan=plan)
        profiling.disable()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        cell.free()
        checks, identity, ctl, extra = serve.judge(cell, win, config, device, control)
        samples, window_s = win.rate_window()
        e2e = {"read_identity": identity}
        extra["basecall_ksamples_per_s"] = samples / window_s / 1e3
        attempted, failed = win.given, checks["reads_not_once"]
        batches = [{"lengths": lens[lens > 0], "steps": steps,
                    "decoded": host[1][:int((lens > 0).sum())].astype("int64")}
                   for host, lens, steps, *_t in win.batches]
        extra["batch_dispatch_s"] = [round(b - a, 4) for *_x, a, b in win.batches]
        ctx.update(model=cell.model, stages=win.stages, batches=batches,
                   traced_batches=[batches[i] for i in win.traced if i < len(batches)],
                   samples=cell.cfg.signal.chunk_len, batch_rows=cell.cfg.decode.batch_chunks_engine)
    else:
        from portbench import train

        cell = train.TrainCell(config, traffic, flat, device, seed)
        cell.read_first_steps()
        t_window = time.perf_counter()
        steps, window_s = cell.window(seconds, tracer=tracer,
                                      trace_steps=range(*traffic["trace_steps"]) if trace
                                      else range(0))
        profiling.disable()
        peak = torch.cuda.max_memory_allocated() if device == "cuda" else 0
        prog = (cell.losses, cell.grad1, cell.params3)
        data_wait = cell.data_wait_s
        cell.free()
        ref = train.reference_readings(config, traffic, flat, seed, device)
        checks = train.gaps(prog, ref, flat)
        ctl = extra = None
        samples = steps * traffic["batch"] * config["config"]["signal"]["chunk_len"]
        e2e = {"train_ksamples_per_s": samples / window_s / 1e3}
        attempted = steps + train.READ_STEPS
        failed = sum(1 for x in prog[0] if x != x)
        ctx.update(model=config["config"]["model"], samples=config["config"]["signal"][
            "chunk_len"], batch_rows=traffic["batch"], window_s=window_s,
                   data_wait_s=data_wait,
                   steps_traced=len(range(*traffic["trace_steps"])) if trace else 0)
    e2e["setup_s"] = t_window - t_start
    units = {m["name"]: m["unit"] for m in spec["end_to_end"] + spec["per_layer"]}
    if trace:
        ctx.update(trace=tracer.trace, spans=profiling.drain())
        metrics = {}
        for m in spec["per_layer"]:
            v = metric_reader(m["name"])(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": e2e[m["name"]], "unit": units[m["name"]]}
                   for m in spec["end_to_end"]}
    dev = {"platform": "gpu" if device == "cuda" else device,
           "kind": torch.cuda.get_device_name(0) if device == "cuda" else device,
           "count": spec["workload"]["chips"], "memory_peak_bytes": int(peak)}
    result = {"correct": all(checks[k] <= limits[k] for k in limits), "attempted": attempted,
              "failed": failed, "metrics": metrics, "device": dev}
    if trace and tracer.trace is not None:
        dev["busy_s"] = tracer.trace.busy_s
        dev["window_s"] = tracer.trace.window_s
        result["breakdown"] = tracer.trace.breakdown()
    result["checks"] = {k: {"value": checks[k], "limit": limits[k]} for k in limits}
    if control or extra:
        result["_control"], result["_extra"] = ctl, extra
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=[0, 1], default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    spec = cell_spec(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < spec["workload"]["chips"]:
        print(f"needs {spec['workload']['chips']} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = run_cell(spec, args.seed, args.seconds, bool(args.trace))
    result.pop("_control", None)
    extra = result.pop("_extra", None)
    found = forbidden_modules()
    if found:
        print(f"loaded in this process: {', '.join(found)}", file=sys.stderr)
        return 3
    if extra:
        print("compared: " + json.dumps(extra), file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})", file=sys.stderr)
    if spec["traffic"]["kind"] == "serve":
        from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

        stop_ingest_processes()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
