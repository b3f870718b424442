"""Run one cell traced, with the program's span recorder on, and print its
result line with the span metrics beside the cell's listed ones.

    python3 -m portbench.spanrun --workload <name> --seed <n> --seconds <s> [--recorder 0|1]

`portbench.run --trace 1` as it stands leaves the recorder
(`nanodecoder_tpu_torch.utils.profiling`) off and hands its readers no
spans, and its `Trace` carries neither the device's busy intervals nor
the profiler's clock.  This runs the same `run.run_cell` with three
differences: the recorder enabled before set-up (unless `--recorder 0`),
`ClockedTracer` in place of `trace.Tracer`, and `SPAN_METRICS` read
after the cell's listed metrics with `ctx["spans"]` set to the
recorder's spans.  Folding these into `run.py` and `trace.py`, and
`SPAN_METRICS` into BENCHMARK.json's `per_layer`, makes them part of
every traced run.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from portbench import run, spans, trace

# The entries BENCHMARK.json's `per_layer` would list.
SERVE, TRAIN = ["mqa.greedy", "mha.greedy"], ["mqa.train"]
SPAN_METRICS = [
    {"name": name, "unit": unit, "better": better, "source": source, "layer": layer,
     "moves": "read_identity" if cells is SERVE else "train_ksamples_per_s",
     "workloads": cells}
    for name, unit, better, source, layer, cells in [
        ("decode.host_ms_per_step", "ms/step", "lower", "program_span", "decode loop", SERVE),
        ("decode.step_cpu_share", "%", "higher", "program_span", "decode loop", SERVE),
        ("device_idle.serve_launch", "%", "lower", "device_trace", "device", SERVE),
        ("device_idle.serve_between", "%", "lower", "device_trace", "device", SERVE),
        ("engine.copy_wait_cores", "cores", "lower", "program_span", "engine", SERVE),
        ("ingest.cpu_ms_per_read", "ms/read", "lower", "program_span", "engine", SERVE),
        ("train.feed_wait_share", "%", "lower", "program_span", "train step", TRAIN),
        ("train.h2d_ms_per_step", "ms/step", "lower", "program_span", "train step", TRAIN),
        ("train.host_ms_per_step", "ms/step", "lower", "program_span", "train step", TRAIN),
    ]]


class ClockedTracer(trace.Tracer):
    """`trace.Tracer` whose `Trace` also holds `t0_ns` and `t1_ns` (the
    profiled window on `time.perf_counter_ns`), `offset_ns` (the profiler's
    event clock, in ns, less `perf_counter_ns`) and `busy_ns` (the merged
    device intervals on `perf_counter_ns`).  The offset is measured, not
    assumed: at the start one CPU-only op (`aten::gcd`, which the program
    never runs) is bracketed by two `perf_counter_ns` reads and found among
    the profiler's events; the bracket is the offset's error."""

    def start(self) -> None:
        x, y = torch.tensor([6]), torch.tensor([4])
        torch.gcd(x, y)
        super().start()
        self._brackets = []
        for _ in range(3):
            a = time.perf_counter_ns()
            torch.gcd(x, y)
            self._brackets.append((a, time.perf_counter_ns()))

    def stop(self) -> None:
        prof, t0 = self._prof, self._t0
        super().stop()
        events = prof.events()
        marks = [e for e in events if e.name == "aten::gcd"]
        (a, b), mark = min(zip(self._brackets, marks), key=lambda bm: bm[0][1] - bm[0][0])
        offset = round((mark.time_range.start + mark.time_range.end) * 500 - (a + b) / 2)
        busy = spans.merge((round(e.time_range.start * 1000) - offset,
                            round(e.time_range.end * 1000) - offset)
                           for e in events if e.device_type == trace.DeviceType.CUDA)
        tr = self.trace
        tr.t0_ns = round(t0 * 1e9)
        tr.t1_ns = tr.t0_ns + round(tr.window_s * 1e9)
        tr.offset_ns, tr.bracket_ns, tr.busy_ns = offset, b - a, busy


def run_with_spans(spec: dict, seed: int, seconds: float, recorder: bool = True,
                   device: str = "cuda") -> dict:
    """`run.run_cell(spec, seed, seconds, trace=True)` as the module
    docstring says: the result line as a dict."""
    from nanodecoder_tpu_torch.utils import profiling

    listed = {m["name"] for m in spec["per_layer"]}
    spec = dict(spec, per_layer=spec["per_layer"] + [
        m for m in SPAN_METRICS
        if spec["workload"]["name"] in m["workloads"] and m["name"] not in listed])
    seen: dict = {}
    plain_reader = run.metric_reader

    def reader(name):
        read = plain_reader(name)

        def with_spans(ctx):
            if "spans" not in seen:
                seen["spans"], seen["trace"] = profiling.drain(), ctx.get("trace")
            ctx["spans"] = seen["spans"]
            return read(ctx)
        return with_spans

    saved = trace.Tracer
    trace.Tracer, run.metric_reader = ClockedTracer, reader
    if recorder:
        profiling.enable()
    try:
        result = run.run_cell(spec, seed, seconds, True, device)
    finally:
        profiling.disable()
        trace.Tracer, run.metric_reader = saved, plain_reader
    tr = seen.get("trace")
    result["clock"] = {"spans": len(seen.get("spans", [])),
                       "n_device_ops": tr.n_device_ops if tr else None,
                       "offset_ns": getattr(tr, "offset_ns", None),
                       "bracket_ns": getattr(tr, "bracket_ns", None)}
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--recorder", type=int, choices=[0, 1], default=1)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    spec = run.cell_spec(args.workload)
    if not torch.cuda.is_available():
        print("needs a CUDA card", file=sys.stderr)
        return 2
    result = run_with_spans(spec, args.seed, args.seconds, bool(args.recorder))
    result.pop("_control", None)
    extra = result.pop("_extra", None)
    if extra:
        print("compared: " + json.dumps(extra), file=sys.stderr)
    if spec["traffic"]["kind"] == "serve":
        from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

        stop_ingest_processes()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
