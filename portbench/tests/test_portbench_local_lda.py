"""LocalLDA's cell at a CPU test's size: the plain reference follows one
(20; 10) call of the program draw for draw at K = 20 (24 slots, the staged
route's shape) and at K = 300 (304 identity slots, 4 of them pad slots:
the wide route's), checks the program's layout against the corpus text,
and its check catches each fault and the bfloat16 control.  And
``cv_live_share`` reads the program's counters of the traced block alone."""

import json

import pytest

import portbench_tiny as tiny
from lda_thesis_tpu_torch.utils import tracing
from portbench import control, faults, spec
from portbench.reference import local_lda as ref

CELL = "locallda_k300.train"
SEED = 2**31 + 21
KS = [20, 300]


@pytest.fixture(scope="module")
def base(tmp_path_factory):
    """A cut-down copy with the mix's own (20; 10) call of a (100; 10) run."""
    base = tiny.copy(tmp_path_factory.mktemp("local_lda"))
    (base / "traffic" / "train_20x10.json").write_text(
        (tiny.PORTBENCH / "traffic" / "train_20x10.json").read_text())
    return base


def _cell(base, K):
    """The benchmark and the LocalLDA cell at ``K`` topics: the
    configuration's own at K = 300, a copy of it at another K."""
    bench = tiny.bench()
    if K == 300:
        return bench, CELL
    name = f"locallda_k{K}"
    cfg = json.loads((base / "configs" / "locallda_k300.json").read_text())
    cfg["model_args"]["K"] = K
    (base / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    (base / "limits" / f"{name}.train.json").write_text(
        (base / "limits" / f"{CELL}.json").read_text())
    bench["configs"].append({"name": name, "source": "test", "reduced": [], "why": "test",
                             "file": f"portbench/configs/{name}.json"})
    bench["workloads"].append({"name": f"{name}.train", "config": name,
                               "traffic": "train_20x10", "chips": 1, "why": "test"})
    for m in bench["end_to_end"] + bench["per_layer"]:
        if CELL in m.get("workloads", []):
            m["workloads"].append(f"{name}.train")
    return bench, f"{name}.train"


def _job(base, bench, cell):
    """The cell's job after its window: set up, the checked call made."""
    w = spec.workload(bench, cell)
    job = spec.model("local_lda").build(spec.config(w["config"], base),
                                        spec.traffic(w["traffic"], base), SEED, "cpu")
    job.after_window()
    job.free()
    return job


@pytest.mark.parametrize("K", KS)
def test_the_reference_follows_a_call_draw_for_draw(base, K):
    bench, cell = _cell(base, K)
    job = _job(base, bench, cell)
    (b,) = job.layout
    A = -(-K // 8) * 8
    assert b.lab_ids.shape[1] == A and (b.lab_valid[:, K:] == 0).all()
    assert job._checked["start"].n_vk.shape[1] == (384 if K == 300 else 128)
    got = job.check()
    assert got == {"start_counts_off": 0, "z_off_share": 0.0, "counts_off_share": 0.0,
                   "phi_hat_rel_gap": 0.0, "theta_hat_gap": 0.0}
    control_got = job.check(control=True)
    limits = spec.limits(cell, base)
    assert any(v > limits[k] for k, v in control_got.items()), control_got


@pytest.mark.parametrize("kind", faults.KINDS)
@pytest.mark.parametrize("K", KS)
def test_the_check_catches_each_fault(base, K, kind):
    bench, cell = _cell(base, K)
    undo = faults.plant(cell, kind, bench, base)
    try:
        got = control.readings(cell, SEED, False, device="cpu", bench=bench, base=base)
    finally:
        undo()
    limits = spec.limits(cell, base)
    assert any(v > limits[k] for k, v in got["sound"].items()), got["sound"]


@pytest.mark.parametrize("what", ["words", "slots"])
def test_the_layout_check_refuses_a_layout_unlike_the_corpus(base, what):
    bench, cell = _cell(base, 20)
    job = _job(base, bench, cell)
    if what == "words":  # two words' ids swapped
        job.words[0], job.words[1] = job.words[1], job.words[0]
    else:  # a pad slot made valid
        job.layout[0].lab_valid[:, -1] = 1
    with pytest.raises(ValueError):
        job.check()


def test_documents_keep_sentences_of_two_words_or_more():
    assert ref.documents(["qbcd qbcf. qbcg, qbch qbch - qbcj qbck qbcj!"]) == [
        ["qbcd", "qbcf"], ["qbcj", "qbck", "qbcj"]]


def test_cv_live_share_reads_the_traced_blocks_counters():
    reader = spec.metric_reader("cv_live_share")  # takes the counters at load
    assert reader.read(None) is None  # nothing counted since
    tracing.count("merge_block.table_entries", 400)
    tracing.count("merge_block.live_table_entries", 140)
    assert reader.read(None) == pytest.approx(35.0)
    assert spec.metric_reader("cv_live_share").read(None) is None  # loaded after the block


def test_cv_live_share_counts_the_traced_block_alone(monkeypatch, tmp_path):
    """A traced run through ``run_cell`` in which every merge block outside
    the profiler counts its table entries twice: the reader, loaded right
    before the traced block, reads the layout's own share, not the
    window's."""
    from torch._C._autograd import _profiler_enabled

    from lda_thesis_tpu_torch.ops import gibbs_fused

    made = []
    real_init = gibbs_fused.FusedBlocks.__init__

    def init(self, *a, **k):
        real_init(self, *a, **k)
        made.append(self)

    def count(name, n=1):
        tracing.count(name, n if _profiler_enabled() or not name.endswith(".table_entries")
                      else 2 * n)

    monkeypatch.setattr(gibbs_fused.FusedBlocks, "__init__", init)
    monkeypatch.setattr(gibbs_fused, "count", count)
    base = tiny.copy(tmp_path)
    out = tiny.run(base, CELL, trace=True)
    assert out["attempted"] >= 1  # the window ran calls before the traced block
    (run,) = made
    tok_v, _, lab_ids, _ = run._inputs
    entries = sum(tv.numel() * li.shape[1] for tv, li in zip(tok_v, lab_ids))
    want = 100.0 * run._live_entries / entries
    assert out["metrics"]["cv_live_share"]["value"] == pytest.approx(want)
