"""The port's spans and counters (``utils/tracing``), with no JAX import.

``annotate(name)`` is a ``record_function`` scope ``lda/<name>`` while a
profiler runs and one shared null context otherwise; ``count``/``counts``
keep the process's counters.  The replay runners (``ops/gibbs._Replayed``)
record each call's phase as ``<layer>.eager``/``.capture``/``.replay`` in
both, the four measured runners a span ``<layer>`` around a whole call, and
a prediction request its steps ``predict.prepare``, ``foldin.init``,
``foldin.sweeps``, ``predict.scores`` and ``predict.rank``, and a
LocalLDA training call its landing ``local_lda.land``.  A merge block
counts the table entries its gather reads (``merge_block.table_entries``;
a replay adds what its captured body read) and those of live positions on
valid slots (``.live_table_entries``).  Here, on the CPU: no scope is
entered without a profiler, a profiler changes no output bit, each model's
request and training call record exactly their spans, nested as stated,
and the counters count each phase and entry; stand-in graphs take the
card's replay rule.  The ``cuda`` cases count a request's phases and a
LocalLDA call's blocks, route and entries on a card:

    LDA_TESTS_KEEP_PLATFORM=1 python -m pytest -m cuda tests/test_torch_tracing.py
"""

import contextlib

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import chip_smoke
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.models.hslda import HSLDA
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
from lda_thesis_tpu_torch.models.local_lda import LocalLDA
from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.utils import tracing

ALPHA, BETA = 0.1, 0.01
SMALL = dict(n_train=40, n_test=8, V=200, max_types=20, mean_types=8)
IT, THIN = 6, 2  # a request's fold-in sweeps and their thinning
STEPS = ["predict.prepare", "foldin.init", "foldin.sweeps", "predict.scores", "predict.rank"]
MODELS = ["labeled", "hslda"]


class _StandIn:
    """A captured body: a CUDA capture runs nothing, and each replay runs
    the body again on the runner's static buffers."""

    def __init__(self, fn):
        self._fn = fn

    def replay(self):
        self._fn()


@pytest.fixture
def graphed(monkeypatch):
    """Runners made inside follow the card's replay rule with stand-in
    graphs: each key's first call eager, the second captured, later ones
    replayed."""
    real = tgibbs._Replayed.__init__

    def init(self, device):
        real(self, device)
        self._graphed = True

    monkeypatch.setattr(tgibbs._Replayed, "__init__", init)
    monkeypatch.setattr(tgibbs, "capture_graph", lambda fn, device: _StandIn(fn))


def _model(kind, device="cpu"):
    if kind == "labeled":
        c = planted_corpus(2, **SMALL)
        m = LabeledLDA(c.train_docs, c.train_labs, c.labelset, Dictionary(c.train_docs),
                       ALPHA, BETA, seed=1, device=device)
        return m, c.test_docs
    docs, labs, labelset = chip_smoke.hslda_small_problem(4)
    return HSLDA(docs[8:], labs[8:], labelset, k=8, seed=1, device=device), docs[:8]


def _train(kind, m):
    if kind == "labeled":
        m.run_training(10, 5, perplexity=False, total_iters=40)  # two blocks of M = 5
    else:
        m.run_training(4, 2)


def _request(kind, m, docs):
    """One prediction request as a caller makes it: the scores, then each
    document's top-3 labels."""
    if kind == "labeled":
        th = m.run_test(docs, IT, THIN)
        return th, m.get_preds(th, 3)
    probs = m.run_tests(docs, IT, THIN)
    return probs, [m.label_predictions(row)[:3] for row in probs]


def _spans(prof):
    """The program's spans of a profile: (name without ``lda/``, start, end),
    in order of start."""
    out = [(e.name()[len(tracing.PREFIX):], e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.is_user_annotation() and e.name().startswith(tracing.PREFIX)]
    return sorted(out, key=lambda s: (s[1], -s[2]))


def _inside(a, b):
    return b[1] <= a[1] and a[2] <= b[2]


def _named(spans, name):
    return [s for s in spans if s[0] == name]


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, _spans(prof)


def _delta(before):
    return {k: n - before.get(k, 0) for k, n in tracing.counts().items()
            if n != before.get(k, 0)}


def _entries(m, blocks):
    """The merge-block counters of ``blocks`` blocks of ``m``, from its
    layout: each document's positions times its slots, and its live
    positions times its valid slots."""
    total = live = 0
    for tf, lv in zip(m.buckets.tok_f, m.lab_valid_t):
        total += tf.size * lv.shape[1]
        live += int(((tf > 0).sum(axis=1) * (lv.cpu().numpy() > 0).sum(axis=1)).sum())
    return {"merge_block.table_entries": blocks * total,
            "merge_block.live_table_entries": blocks * live}


def _trained_counts(kind, m, phase):
    """The counters of ``_train``: each runner call's phase, and for
    Labeled LDA the entries of its 2 blocks."""
    if kind == "labeled":
        return {f"merge_block.{phase}": 2, f"save_step.{phase}": 2, **_entries(m, 2)}
    return {f"hslda_cycle.{phase}": 4, f"save_step.{phase}": 2}


def test_annotate_is_one_null_context_without_a_profiler():
    assert tracing.annotate("a") is tracing.annotate("b")
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.annotate("outer"):
            with tracing.annotate("inner"):
                torch.ones(3).sum()
    outer, inner = _spans(prof)
    assert (outer[0], inner[0]) == ("outer", "inner") and _inside(inner, outer)


@pytest.mark.parametrize("kind", MODELS)
def test_no_scope_is_entered_without_a_profiler(monkeypatch, kind):
    entered = []

    def counting(name):
        entered.append(name)
        return torch.profiler.record_function(name)

    monkeypatch.setattr(tracing, "record_function", counting)
    m, docs = _model(kind)
    _train(kind, m)
    _request(kind, m, docs)
    assert entered == []
    with profile(activities=[ProfilerActivity.CPU]):
        _request(kind, m, docs)
    assert "lda/foldin_sweep" in entered  # the stand-in sits where the spans are made


def _same(a, b):
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    return a == b


@pytest.mark.parametrize("call", ["train", "request"])
@pytest.mark.parametrize("kind", MODELS)
def test_a_profiler_changes_no_output_bit(kind, call):
    def run(traced):
        m, docs = _model(kind)
        with profile(activities=[ProfilerActivity.CPU]) if traced else contextlib.nullcontext():
            _train(kind, m)
            out = _request(kind, m, docs) if call == "request" else None
        if call == "train":
            state = (m.counts.n_vk, m.counts.n_k) if kind == "labeled" else (
                m._n_vk, m.eta, m.beta)
            out = (tuple(np.asarray(t.cpu()) for t in state),
                   np.asarray(m.ph_hat.cpu()) if kind == "labeled" else m.ph)
        return out

    plain, traced = run(False), run(True)
    if call == "request":
        assert _same(plain[0], traced[0]) and plain[1] == traced[1]
    else:
        assert all(_same(a, b) for a, b in zip(plain[0], traced[0], strict=True))
        assert _same(plain[1], traced[1])


@pytest.mark.parametrize("kind", MODELS)
def test_a_request_records_its_steps_nested(kind):
    m, docs = _model(kind)
    _train(kind, m)
    _, spans = _profiled(lambda: _request(kind, m, docs))
    assert {s[0] for s in spans} == {*STEPS, "foldin_sweep", "foldin_sweep.eager"}
    steps = [s for s in spans if s[0] in STEPS]
    ranks = 1 if kind == "labeled" else len(docs)
    assert [s[0] for s in steps] == STEPS[:-1] + ["predict.rank"] * ranks
    assert all(a[2] <= b[1] for a, b in zip(steps, steps[1:]))  # one after another
    sweeps = _named(spans, "foldin_sweep")
    assert len(sweeps) == IT and all(_inside(s, steps[2]) for s in sweeps)
    eager = _named(spans, "foldin_sweep.eager")
    assert len(eager) == IT and all(_inside(e, s) for e, s in zip(eager, sweeps))


@pytest.mark.parametrize("kind", MODELS)
def test_training_records_its_runner_spans(kind):
    m, _ = _model(kind)
    _, spans = _profiled(lambda: _train(kind, m))
    layers = ["merge_block", "save_step"] if kind == "labeled" else ["hslda_cycle", "save_step"]
    assert {s[0] for s in spans} == {n for la in layers for n in (la, f"{la}.eager")}
    for layer in layers:
        outer, eager = _named(spans, layer), _named(spans, f"{layer}.eager")
        assert len(outer) == len(eager) >= 1
        assert all(_inside(e, o) for e, o in zip(eager, outer))


@pytest.mark.parametrize("kind", MODELS)
def test_cpu_counts_each_runner_call_eager(kind):
    m, docs = _model(kind)
    before = tracing.counts()
    _train(kind, m)
    # one merge block per save for Labeled LDA, one cycle per call for HSLDA
    assert _delta(before) == _trained_counts(kind, m, "eager")
    before = tracing.counts()
    _request(kind, m, docs)
    assert _delta(before) == {"foldin_sweep.eager": IT}


@pytest.mark.parametrize("kind", MODELS)
def test_replay_rule_counts_and_records_each_phase(graphed, kind):
    m, docs = _model(kind)
    _train(kind, m)
    for _ in range(2):  # each request captures its own fold-in graph
        before = tracing.counts()
        _, spans = _profiled(lambda: _request(kind, m, docs))
        assert _delta(before) == {"foldin_sweep.eager": 1, "foldin_sweep.capture": 1,
                                  "foldin_sweep.replay": IT - 1}
        sweeps = _named(spans, "foldin_sweep")
        phases = [s for s in spans if s[0].startswith("foldin_sweep.")]
        assert [s[0] for s in phases] == (["foldin_sweep.eager", "foldin_sweep.capture"]
                                          + ["foldin_sweep.replay"] * (IT - 1))
        assert all(any(_inside(p, s) for s in sweeps) for p in phases)
    before = tracing.counts()
    _train(kind, m)  # the training graphs were captured by the first call
    assert _delta(before) == _trained_counts(kind, m, "replay")


def test_runner_layers():
    from lda_thesis_tpu_torch.models.hslda import CycleStep
    from lda_thesis_tpu_torch.ops.gibbs_fused import FusedBlocks

    layers = {cls: cls._layer for cls in (
        FusedBlocks, tgibbs.SaveStep, CycleStep, tgibbs.FoldinSweep, tgibbs.ExactSweep,
        tgibbs.CompactSweep, tgibbs.CascadeSweep, tgibbs.LogLikelihood)}
    assert list(layers.values()) == ["merge_block", "save_step", "hslda_cycle", "foldin_sweep",
                                     "exact_sweep", "compact_sweep", "cascade_sweep",
                                     "log_likelihood"]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", MODELS)
def test_a_request_on_a_card_counts_one_capture(kind):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m, docs = _model(kind, device="cuda")
    _train(kind, m)
    for _ in range(2):
        before = tracing.counts()
        _request(kind, m, docs)
        torch.cuda.synchronize()
        assert _delta(before) == {"foldin_sweep.eager": 1, "foldin_sweep.capture": 1,
                                  "foldin_sweep.replay": IT - 1}


def _local(K, device="cpu"):
    c = planted_corpus(3, n_train=30, n_test=0, V=120, max_types=16, mean_types=6)
    texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) for d in c.train_docs]
    return LocalLDA(texts, ALPHA, BETA, K=K, seed=1, device=device)


@pytest.mark.parametrize("K", [20, 300])
def test_a_merge_block_counts_its_table_entries(K):
    """LocalLDA's identity slots: D·U·A entries a block, and the live
    positions' K valid slots (A = 304 at K = 300: 4 pad slots)."""
    m = _local(K)
    before = tracing.counts()
    m.run_training(6, 3)  # M = 1: six blocks of one sweep
    assert m.A == -(-K // 8) * 8
    got = _delta(before)
    assert {k: got[k] for k in _entries(m, 6)} == _entries(m, 6)
    (tf,) = m.buckets.tok_f
    assert got["merge_block.live_table_entries"] == 6 * int((tf > 0).sum()) * K
    assert got["merge_block.table_entries"] == 6 * tf.size * m.A


def test_a_replayed_block_counts_what_its_gather_read(graphed):
    """The gather's entries are counted where it reads them: by the eager
    call, once by the capturing call, and by each replay (the stand-in
    replay runs the body, as a card's replay reads the table)."""
    m = _local(20)
    before = tracing.counts()
    m.run_training(6, 3)
    got = _delta(before)
    assert (got["merge_block.eager"], got["merge_block.capture"], got["merge_block.replay"]) \
        == (1, 1, 5)
    assert {k: got[k] for k in _entries(m, 6)} == _entries(m, 6)


def test_a_local_lda_call_records_its_landing():
    """The landing holds the means' copy to the host and their guards
    (``_check_ph_hat``), after both saves."""
    m = _local(20)
    real = m._check_ph_hat

    def check():
        with tracing.annotate("check"):
            real()

    m._check_ph_hat = check
    _, spans = _profiled(lambda: m.run_training(6, 3))
    (land,) = _named(spans, "local_lda.land")
    saves = _named(spans, "save_step")
    assert len(saves) == 2 and all(s[2] <= land[1] for s in saves)
    (check,) = _named(spans, "check")
    assert _inside(check, land)
    assert {s[0] for s in spans} == {"merge_block", "merge_block.eager", "save_step",
                                     "save_step.eager", "local_lda.land", "check"}


@pytest.mark.cuda
def test_a_local_lda_call_on_a_card_counts_its_routes():
    """K = 300 takes the wide route: every block, eager, captured or
    replayed, is one wide launch (the wrapper's counters) and counts its
    gather's D·U·A entries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    m = _local(300, device="cuda")
    for _ in range(2):
        before = tracing.counts()
        launches = (fbc.launches, fbc.wide_launches)
        m.run_training(6, 3)
        torch.cuda.synchronize()
        assert (fbc.launches - launches[0], fbc.wide_launches - launches[1]) == (6, 6)
        got = _delta(before)
        assert {k: got[k] for k in _entries(m, 6)} == _entries(m, 6)
