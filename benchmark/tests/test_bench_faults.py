"""A whole run of each cell, cut to a size the CPU holds and past the
harness's look for a card, held to the cell's own limits: correct as it
stands, and not correct with the timed path broken underneath (a step that
leaves the state unchanged; half of the batch left out of the loss) or with
the control, the reference with its products in float8, in the program's
place."""

import pytest

from benchmark import calibrate, compare, faults, harness
from benchmark.drivers import train
from tiny_cell import tiny

WORKLOADS = ["cascade_a.train", "cascade_b.train"]


def cells():
    return [tiny("cascade_a.train"), tiny("cascade_b.train")]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_sound_run_is_correct(which, seed):
    out = train.run(cells()[which], seed, 0.2, False, "cpu")
    assert harness.is_correct(out["checks"]), out["checks"]
    assert out["attempted"] >= 2 and out["failed"] == 0


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("fault", [faults.unchanged_state, faults.half_batch])
def test_broken_step_is_not_correct(which, fault):
    with fault():
        out = train.run(cells()[which], 3, 0.2, False, "cpu")
    assert not harness.is_correct(out["checks"]), out["checks"]


@pytest.mark.parametrize("which", [0, 1])
@pytest.mark.parametrize("seed", [3, 4, 5])
def test_float8_control_is_not_correct(which, seed):
    cell = cells()[which]
    drv = harness.driver(cell["traffic"])
    ref = calibrate.reference_readings(drv, cell, seed, "cpu")
    low = calibrate.reference_readings(drv, cell, seed, "cpu", "fp8")
    values = compare.readings({"losses": low["losses"], "grad1": low["grads"][0], "change": low["change"]}, ref)
    assert not harness.is_correct(compare.checks(values, cell["limits"])), values
