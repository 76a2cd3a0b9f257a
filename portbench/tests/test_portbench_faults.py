"""The check of every cell comes out false for its control and for each
fault of its timed path, and true for the sound program, at a CPU test's
size.  The harness's look for a card is skipped (``device="cpu"``); each
fault is planted underneath the timed path by patching the program."""

import pytest

import portbench_tiny as tiny
from portbench import faults

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("faults"))


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(base, cell, kind):
    undo = faults.plant(cell, kind, tiny.bench(), base)
    try:
        out = tiny.run(base, cell)
    finally:
        undo()
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_sound_program_is_correct(base, cell):
    out = tiny.run(base, cell)
    assert out["correct"] is True, out["checks"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(base, cell):
    """The reference itself in bfloat16 in the program's place fails the
    cell's limits; in float32 it passes them."""
    from portbench import control, spec

    got = control.readings(cell, 2**31 + 5, True, device="cpu", bench=tiny.bench(), base=base)
    limits = spec.limits(cell, base)
    assert all(v <= limits[k] for k, v in got["sound"].items()), got["sound"]
    assert any(v > limits[k] for k, v in got["control"].items()), got["control"]


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("cell", [c for c in CELLS if c.endswith(".predict")])
def test_a_broken_fit_fails_the_prediction_cell(base, cell, kind):
    """The fit that set-up trains is followed by the reference too: the
    training call's faults, planted under a prediction cell, fail it."""
    undo = faults.plant(cell, kind, tiny.bench(), base, call="train")
    try:
        out = tiny.run(base, cell)
    finally:
        undo()
    assert out["correct"] is False, out["checks"]
    assert any(k.startswith("fit_") and c["value"] > c["limit"]
               for k, c in out["checks"].items()), out["checks"]
