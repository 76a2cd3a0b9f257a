"""BENCHMARK.json against the benchmark's contract, and discovery by name."""

import json
import re

import pytest

import portbench_tiny as tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return tiny.bench()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert bench["command"][:3] == ["python3", "-m", "portbench.run"]
    assert bench["paths"] == ["portbench"]
    assert isinstance(bench["run_seconds"], int) and 1 <= bench["run_seconds"] <= 51
    assert len((tiny.CHECKOUT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = [x["name"] for part in ("configs", "workloads", "end_to_end", "per_layer")
             for x in bench[part]]
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.match(name), name
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        for text in (c["source"], c["why"]):
            assert 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_every_cell_reports_setup_an_end_to_end_and_a_layer_metric(bench):
    from portbench import spec

    assert "setup_s" in {m["name"] for m in bench["end_to_end"]}
    for w in bench["workloads"]:
        e2e = {m["name"] for m in spec.cell_metrics(bench, w, "end_to_end")}
        assert "setup_s" in e2e and len(e2e) >= 2
        layer = spec.cell_metrics(bench, w, "per_layer")
        assert layer
        for m in layer:
            assert m["moves"] in e2e, (w["name"], m["name"])


def test_files_of_every_part_exist(bench):
    from portbench import spec

    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    for c in bench["configs"]:
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert json.loads((tiny.CHECKOUT / c["file"]).read_text())["reduced"] == c["reduced"]
    for w in bench["workloads"]:
        spec.traffic(w["traffic"])
        spec.limits(w["name"])
    for m in bench["per_layer"]:
        assert hasattr(spec.metric_reader(m["name"]), "read")


def test_a_new_config_mix_and_metric_are_found_by_name(tmp_path):
    """A cell added by new files and BENCHMARK.json entries alone runs, and
    its new metric is read, with no edit to a file that is there."""
    base = tiny.copy(tmp_path)
    cfg = json.loads((base / "configs" / "llda_d3.json").read_text())
    cfg["model_args"]["alpha"] = 0.2
    (base / "configs" / "dummy_cfg.json").write_text(json.dumps(cfg))
    mix = json.loads((base / "traffic" / "train_50x25.json").read_text())
    mix["iters"] = 5
    (base / "traffic" / "dummy_mix.json").write_text(json.dumps(mix))
    (base / "limits" / "dummy_cfg.dummy_mix.json").write_text(
        (base / "limits" / "llda_d3.train.json").read_text())
    (base / "metrics" / "dummy.metric.py").write_text(
        "def read(trace):\n    return 42.0 + trace.calls * 0\n")
    bench = tiny.bench()
    bench["configs"].append({"name": "dummy_cfg", "source": "test", "reduced": [],
                             "file": "portbench/configs/dummy_cfg.json", "why": "test"})
    bench["workloads"].append({"name": "dummy_cfg.dummy_mix", "config": "dummy_cfg",
                               "traffic": "dummy_mix", "chips": 1, "why": "test"})
    for m in bench["end_to_end"]:
        if "workloads" in m and "llda_d3.train" in m["workloads"]:
            m["workloads"].append("dummy_cfg.dummy_mix")
    bench["per_layer"].append({"name": "dummy.metric", "unit": "x", "better": "higher",
                               "source": "program_counter", "layer": "test",
                               "moves": "train_tokens_per_s",
                               "workloads": ["dummy_cfg.dummy_mix"]})
    out = tiny.run(base, "dummy_cfg.dummy_mix", trace=True, bench_spec=bench)
    assert out["metrics"]["dummy.metric"] == {"value": 42.0, "unit": "x"}
    assert out["correct"] is True
    from portbench import faults

    makers, call = faults.makers("dummy_cfg.dummy_mix", bench, base)
    assert call == "train" and "train" in makers


@pytest.mark.parametrize("cell", [w["name"] for w in tiny.bench()["workloads"]])
def test_a_traced_run_wraps_only_the_spans_its_metrics_read(bench, cell):
    from portbench import spec

    w = spec.workload(bench, cell)
    readers = [spec.metric_reader(m["name"]) for m in spec.cell_metrics(bench, w, "per_layer")]
    wrapped = spec.spans(readers)
    read = {name for r in readers for name in getattr(r, "SPANS", {})}
    assert set(wrapped) == read
    call = spec.traffic(w["traffic"])["call"]
    if call == "predict":
        assert set(wrapped) == {"foldin_sweep"}
    assert all(":" in target for target in wrapped.values())
