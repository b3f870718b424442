"""On the card, at the cells' own sizes: the program's readings within the
limits and the controls above them, on three seeds (`-m cuda`)."""

import pytest

from portbench import control, run

SEEDS = [2**31 + 11, 3 * 10**9 + 7, 123456789]


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["mqa.greedy", "mha.greedy"])
def test_serving_control_fails(card, workload):
    spec = run.cell_spec(workload)
    for line in control.serve_readings(spec, SEEDS, 4.0, "kernels", "float8", None):
        assert line["correct"], line
        assert any(v > spec["limits"][k] for k, v in line["control"].items()), line


@pytest.mark.cuda
def test_training_control_and_fault_fail(card):
    spec = run.cell_spec("mqa.train")
    lim = spec["limits"]
    for line in control.train_readings(spec, SEEDS, "tf32", "half_batch"):
        assert line["correct"], line
        assert any(line["control"][k] > lim[k] for k in lim), line
        assert any(line["fault"][k] > lim[k] for k in lim), line
