"""Every cell at a test's size on the card: the kernels' path is correct and
its control is not.  Needs an NVIDIA GPU; skips without one.  Run on the
card with ``python -m pytest -m cuda portbench/tests/test_portbench_card.py``."""

import pytest
import torch

import portbench_tiny as tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return tiny.copy(tmp_path_factory.mktemp("card"))


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_on_the_card(base, cell):
    from portbench import control, run, spec

    out = run.run_cell(cell, 2**31 + 3, 0.5, True, device="cuda", bench=tiny.bench(),
                       base=base)
    assert out["correct"] is True, out["checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["memory_peak_bytes"] > 0
    got = control.readings(cell, 2**31 + 4, True, device="cuda", bench=tiny.bench(), base=base)
    limits = spec.limits(cell, base)
    assert all(v <= limits[k] for k, v in got["sound"].items()), got["sound"]
    assert any(v > limits[k] for k, v in got["control"].items()), got["control"]
