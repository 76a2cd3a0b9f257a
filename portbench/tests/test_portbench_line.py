"""The result line of every cell, untraced and traced, at a CPU test's size."""

import json

import pytest

import portbench_tiny as tiny

CELLS = [w["name"] for w in tiny.bench()["workloads"]]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    return tiny.copy(tmp_path_factory.mktemp("line"))


@pytest.mark.parametrize("trace", [False, True], ids=["plain", "traced"])
@pytest.mark.parametrize("cell", CELLS)
def test_result_line(base, cell, trace):
    from portbench import spec

    bench = tiny.bench()
    out = tiny.run(base, cell, trace=trace)
    json.loads(json.dumps(out))  # one JSON object
    assert list(out)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(out)[-1] == "checks"
    assert out["correct"] is True, out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= set(out["device"])
    w = spec.workload(bench, cell)
    want = spec.cell_metrics(bench, w, "per_layer" if trace else "end_to_end")
    units = {m["name"]: m["unit"] for m in want}
    for name, m in out["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if trace:
        assert {"busy_s", "window_s"} <= set(out["device"])
        for key in ("device_ops", "idle_gaps"):
            assert len(out["breakdown"][key]) <= 10
    else:
        assert set(out["metrics"]) == set(units)
    limits = spec.limits(cell)
    assert set(out["checks"]) == set(limits)
    for c in out["checks"].values():
        assert set(c) == {"value", "limit"}
