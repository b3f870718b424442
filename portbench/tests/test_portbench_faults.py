"""Runs of the harness on the CPU, the card's look skipped, at a tiny
size: a sound run is correct, the float8 control reads above the limit,
and each fault a cell can have, planted under the timed path, makes
`correct` false."""

import numpy as np
import pytest

from portbench import control, run, train
from portbench.tests.helpers import tiny_spec

SEED = 2**35 + 17


@pytest.fixture(scope="module", autouse=True)
def stop_pool():
    yield
    from nanodecoder_tpu_torch.io.pipeline import stop_ingest_processes

    stop_ingest_processes()


@pytest.mark.parametrize("workload", ["mqa.greedy", "mha.greedy"])
def test_sound_run_is_correct_and_control_is_not(workload):
    spec = tiny_spec(workload)
    res = run.run_cell(spec, SEED, 3.0, False, device="cpu", control="float8")
    assert res["correct"], res["checks"]
    assert res["attempted"] > 0 and res["failed"] == 0
    ctl = res["_control"]
    assert any(ctl[k] > spec["limits"][k] for k in ctl), (ctl, spec["limits"])
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]


@pytest.mark.parametrize("fault", ["state_unchanged", "token_altered", "half_batch"])
def test_serving_fault_is_not_correct(fault):
    spec = tiny_spec("mqa.greedy")
    (line,) = control.serve_readings(spec, [SEED], 3.0, "kernels", None, fault, device="cpu")
    assert not line["correct"], line["checks"]


def test_training_faults_are_not_correct():
    spec = tiny_spec("mqa.train")
    (line,) = control.train_readings(spec, [SEED], None, "half_batch", device="cpu")
    assert line["correct"], line["checks"]
    lim = spec["limits"]
    assert any(line["fault"][k] > lim[k] for k in lim), line["fault"]
    # a step that returns its state unchanged: the parameters never move
    flat = run.load_flat(spec["config"])
    ref = train.reference_readings(spec["config"], spec["traffic"], flat, SEED, "cpu")
    stuck = (ref[0], ref[1], {k: np.array(v) for k, v in flat.items()})
    assert train.gaps(stuck, ref, flat)["change_gap"] > lim["change_gap"]


def test_traced_run_reads_its_metrics():
    spec = tiny_spec("mqa.greedy")
    res = run.run_cell(spec, SEED, 3.0, True, device="cpu")
    assert res["correct"]
    listed = {m["name"] for m in spec["per_layer"]}
    # the CPU's trace holds no device operation: the host's readers read
    read = {"engine.warmup_s", "engine.dispatch_share", "engine.ingest_wait_share",
            "decode.steps_per_batch"}
    assert read <= listed and set(res["metrics"]) == read
    assert res["device"]["window_s"] > 0
