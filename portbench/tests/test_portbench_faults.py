"""Runs of the harness on the CPU, the card's look skipped, at a tiny
size: a sound run is correct, the float8 control reads above the limit,
and each fault a cell can have, planted under the timed path, makes
`correct` false."""

import numpy as np
import pytest

from portbench import control, run, train
from portbench.tests.helpers import tiny_spec

SEED = 2**35 + 17
# What the transformer reference read on these tiny runs when it was the
# only reference: a configuration that names none is judged as before.
# Serving's number is a gap between two of the reference's log-probs
# (about 0.37), and training's are the reference's own losses and the
# norms of its first gradient and of its change over three steps; a BLAS
# that sums in another order moves each by a few ulps, the change (a
# difference of parameters that moved by about 1e-6 each) by more, hence
# the tolerances.  The program's gaps are differences of nearly equal
# numbers and are not pinned: rounding alone moves them by their size.
READINGS = {"mqa.greedy": 0.3695363998413086, "mha.greedy": 0.3695363998413086}
REF_LOSSES = [1.5082565546035767, 1.5516667366027832, 1.535560965538025]
REF_GRAD_NORM, REF_CHANGE_NORM = 2.5019923527644843, 0.0027792959083950165


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
    assert res["checks"]["token_gap_max"]["value"] == pytest.approx(READINGS[workload], rel=1e-5)
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
    assert ref[0] == pytest.approx(REF_LOSSES, rel=1e-6)
    assert norm(ref[1].values()) == pytest.approx(REF_GRAD_NORM, rel=1e-6)
    assert norm(ref[2][k] - flat[k] for k in flat) == pytest.approx(REF_CHANGE_NORM, rel=1e-4)
    stuck = (ref[0], ref[1], {k: np.array(v) for k, v in flat.items()})
    assert train.gaps(stuck, ref, flat)["change_gap"] > lim["change_gap"]


def norm(leaves) -> float:
    return float(np.sqrt(sum(float((v.astype(np.float64) ** 2).sum()) for v in leaves)))


# What a traced CPU run reads: its trace holds no device operation, so the
# host's readers and those of the program's spans.
HOST_READS = {"mqa.greedy": {"engine.warmup_s", "engine.dispatch_share",
                             "engine.ingest_wait_share", "decode.steps_per_batch",
                             "decode.host_ms_per_step", "decode.step_cpu_share",
                             "ingest.cpu_ms_per_read"},
              "mqa.train": {"train.data_wait_share", "train.feed_wait_share",
                            "train.h2d_ms_per_step", "train.host_ms_per_step"}}


@pytest.mark.parametrize("workload", sorted(HOST_READS))
def test_traced_run_reads_its_metrics(workload):
    from nanodecoder_tpu_torch.utils import profiling

    spec = tiny_spec(workload)
    res = run.run_cell(spec, SEED, 3.0, True, device="cpu")
    assert res["correct"]
    listed = {m["name"] for m in spec["per_layer"]}
    read = HOST_READS[workload]
    assert read <= listed and set(res["metrics"]) == read
    assert all(res["metrics"][n]["value"] > 0 for n in read - {"train.data_wait_share"})
    assert res["device"]["window_s"] > 0
    # the recorder was on for the run alone, and kept no span of it
    with profiling.span("after the run"):
        pass
    assert profiling.drain() == []
