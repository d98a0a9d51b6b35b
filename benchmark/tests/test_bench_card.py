"""On the card, at each cell's own size: the control (the reference with
fp8 convolution operands put in the program's place) and each planted
fault fail the cell's correctness limits. Run on the card with
``python -m pytest benchmark/tests -q -m card``; skips without one."""

import time

import pytest

from benchmark import calibrate, harness

SEED = 2 ** 31 + 77
CELLS = [w["name"] for w in harness.manifest()["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_and_faults_fail_at_the_cells_size(card, cell):
    spec, conf, traffic = harness.load_cell(cell)
    run = harness.Run(spec, conf, traffic, SEED, 1.0, False, card,
                      time.perf_counter())
    readings = []
    train = traffic["driver"] == "train"
    (calibrate.train_controls if train else calibrate.serve_controls)(
        run, readings.append)
    limits = conf["limits"]["train" if train else "serve"]
    for r in readings:
        failed = [k for k in limits if k in r and r[k] > limits[k]]
        if r["reading"] == "reference_itself":
            assert not failed, r
        else:
            assert failed, r
