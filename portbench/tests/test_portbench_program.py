"""The readers of the program's own spans and counters, on a ``Trace`` of
synthetic events: device idle within spans (nested and overlapping spans
counted once, clipped to the window), each new reader, and nothing read
where the program records no span or counter."""

import json

import pytest
from torch.autograd import DeviceType

import portbench_tiny as tiny  # noqa: F401  (puts the checkout on the path)
from lda_thesis_tpu_torch.utils import tracing
from portbench import program, spec
from portbench.trace import Trace

MS = 1_000_000  # ns


class _Event:
    def __init__(self, name, start, end, device=False, annotation=False, corr=0):
        self._n, self._s, self._e = name, start, end
        self._dev, self._ann, self._corr = device, annotation, corr

    def name(self):
        return self._n

    def start_ns(self):
        return self._s

    def duration_ns(self):
        return self._e - self._s

    def device_type(self):
        return DeviceType.CUDA if self._dev else DeviceType.CPU

    def is_user_annotation(self):
        return self._ann

    def correlation_id(self):
        return self._corr


def _span(name, start, end):
    return _Event(name, start * MS, end * MS, annotation=True)


def _kernel(start, end):
    return _Event("kernel", start * MS, end * MS, device=True, corr=1)


def _trace(spans, busy, calls=((0, 100),)):
    """Calls ``portbench/call`` over ``calls`` (ms), program spans
    ``(name, start, end)`` and device records over ``busy``."""
    events = [_span("portbench/call", s, e) for s, e in calls]
    events += [_span(tracing.PREFIX + n, s, e) for n, s, e in spans]
    events += [_kernel(s, e) for s, e in busy]
    return Trace(events, {}, len(calls), 1.0)


def test_idle_in_counts_nested_and_overlapping_spans_once():
    tr = _trace([("a", 10, 40), ("a.eager", 20, 30), ("b", 35, 50), ("c", 90, 130)],
                busy=[(0, 15), (25, 38), (95, 97)])
    # a ∪ b is 10..50 (40 ms), of which 10..15 and 25..38 busy: 22 ms idle
    assert program.idle_in(tr, ["a", "a.eager", "b"]) == pytest.approx((40 - 5 - 13) / 1e3)
    assert program.idle_in(tr, ["a.eager"]) == pytest.approx(5 / 1e3)  # 20..25
    # c clipped to the window's end (100): 90..100 less 95..97
    assert program.idle_in(tr, ["c"]) == pytest.approx(8 / 1e3)
    assert program.idle_in(tr, ["missing"]) is None
    assert program.spans(tr)["a"] == [(10 * MS, 40 * MS)]


def _reader(name):
    return spec.metric_reader(name)


def _request_trace():
    """Two requests of 100 ms each: set-up 0..30 (idle 0..10 and 20..30),
    a replay span 40..42 (idle 41..42, read by neither reader), a tail
    80..100 (idle 90..100)."""
    spans, busy = [], []
    for base in (0, 100):
        spans += [("predict.prepare", base, base + 5), ("foldin.init", base + 5, base + 20),
                  ("foldin.sweeps", base + 20, base + 80),
                  ("foldin_sweep", base + 20, base + 30),
                  ("foldin_sweep.eager", base + 20, base + 30),
                  ("foldin_sweep", base + 38, base + 43),
                  ("foldin_sweep.replay", base + 40, base + 42),
                  ("predict.scores", base + 80, base + 85), ("predict.rank", base + 85, base + 100)]
        busy += [(base + 10, base + 20), (base + 30, base + 41), (base + 42, base + 90)]
    return _trace(spans, busy, calls=((0, 100), (100, 200)))


@pytest.mark.parametrize("name, want", [("foldin_setup_idle_ms", 20.0),
                                        ("predict_tail_idle_ms", 10.0)])
def test_each_idle_reader_reads_per_call(name, want):
    reader = _reader(name)
    assert reader.read(_request_trace()) == pytest.approx(want)
    assert reader.read(_trace([], busy=[(0, 50)])) is None  # a program that records no span


def test_captures_per_request_reads_the_traced_blocks_counter():
    reader = _reader("foldin_captures_per_request")  # takes the counters at load
    tr = _trace([], [], calls=((0, 50), (50, 100)))
    assert reader.read(tr) is None  # no fold-in sweep counted since
    tracing.count("foldin_sweep.eager", 2)
    assert reader.read(tr) == 0.0  # the CPU: sweeps ran, none captured
    tracing.count("foldin_sweep.capture", 2)
    tracing.count("foldin_sweep.replay", 398)
    assert reader.read(tr) == 1.0
    assert _reader("foldin_captures_per_request").read(tr) is None  # loaded after the block


def test_captures_per_request_reads_nothing_without_the_programs_counters(monkeypatch):
    monkeypatch.delattr(tracing, "counts")
    reader = _reader("foldin_captures_per_request")
    monkeypatch.undo()
    tracing.count("foldin_sweep.capture")
    assert reader.read(_trace([], [])) is None


def test_captures_per_request_counts_the_traced_block_alone(monkeypatch, tmp_path):
    """A traced run of a prediction cell through ``run_cell``, with every
    eager fold-in sweep also counted as a capture (the CPU captures none):
    the reader, which takes the counters when it is loaded, reads the
    traced requests' sweeps alone, not the window's before them."""
    from lda_thesis_tpu_torch.ops import gibbs

    def count(name, n=1):
        tracing.count(name, n)
        if name == "foldin_sweep.eager":
            tracing.count("foldin_sweep.capture", n)

    monkeypatch.setattr(gibbs, "count", count)
    base = tiny.copy(tmp_path)
    cell = "llda_d3.predict"
    traffic = spec.workload(tiny.bench(), cell)["traffic"]
    sweeps = json.loads((base / "traffic" / f"{traffic}.json").read_text())["it"]
    out = tiny.run(base, cell, trace=True)
    assert out["attempted"] >= 1  # the window ran requests before the traced block
    assert out["metrics"]["foldin_captures_per_request"]["value"] == sweeps
