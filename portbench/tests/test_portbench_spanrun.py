"""`spanrun` on the CPU at a tiny size: with the program's span recorder
on, the span metrics a CPU run can give are read (the device's need a
card's trace); with it off, none."""

import pytest

from portbench import spanrun
from portbench.tests.helpers import tiny_spec

SEED = 2**35 + 17
HOST = {"mqa.greedy": {"decode.host_ms_per_step", "decode.step_cpu_share",
                       "ingest.cpu_ms_per_read"},
        "mqa.train": {"train.feed_wait_share", "train.h2d_ms_per_step",
                      "train.host_ms_per_step"}}


@pytest.fixture(scope="module", autouse=True)
def stop_pool():
    yield
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    stop_ingest_processes()


@pytest.mark.parametrize("workload", ["mqa.greedy", "mqa.train"])
def test_span_metrics_with_the_recorder_on_and_off(workload):
    names = {m["name"] for m in spanrun.SPAN_METRICS if workload in m["workloads"]}
    on = spanrun.run_with_spans(tiny_spec(workload), SEED, 3.0, device="cpu")
    assert on["correct"] and on["clock"]["spans"] > 0
    assert set(on["metrics"]) & names == HOST[workload]
    assert all(on["metrics"][n]["value"] > 0 for n in HOST[workload])
    off = spanrun.run_with_spans(tiny_spec(workload), SEED, 3.0, recorder=False, device="cpu")
    assert off["correct"] and off["clock"]["spans"] == 0
    assert not set(off["metrics"]) & names
