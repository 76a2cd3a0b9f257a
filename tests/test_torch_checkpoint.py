"""Checkpoint/resume, the elastic loop and progress reporting of the port.

Built on the ``DOCS``/``LABS`` corpus of ``tests/test_checkpoint_resume.py``,
on the CPU.  Within the port a save, restore and continue is bitwise equal
to the uninterrupted chunked run for every sampler, because the generator's
state is part of the checkpoint; a checkpoint that the JAX package wrote
loads its arrays exactly and warns that the draw stream does not carry over.
"""

import os
import pickle
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from lda_thesis_tpu.data.vocab import prune_dict as jax_prune_dict
from lda_thesis_tpu.models.cascade_lda import CascadeLDA as JaxCascadeLDA
from lda_thesis_tpu.models.labeled_lda import LabeledLDA as JaxLabeledLDA
from lda_thesis_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from lda_thesis_tpu.utils.checkpoint import save_model as jax_save_model
from lda_thesis_tpu_torch.data.synthetic import jel_corpus, planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary, prune_dict
from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
from lda_thesis_tpu_torch.ops.gibbs_fused import SAMPLER_FORMULA_VERSION
from lda_thesis_tpu_torch.utils import tracing
from lda_thesis_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_model,
    save_checkpoint,
    save_model,
)
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs, elastic_train
from test_checkpoint_resume import DOCS, LABELSET, LABS

SWEEPS = ["fused", "dense", "compact"]
PLANTED_SMALL = dict(n_train=60, n_test=10, V=120, n_labels=6, max_labels=3,
                     mean_types=12, max_types=30, words_per_label=10)
JEL_SMALL = dict(n_train=60, n_test=8, V=150, n_l2=12, n_l3=20, mean_types=10,
                 max_types=25, words_per_code=5)


def _model(sweep="fused", seed=7, **kw):
    dicti = prune_dict(DOCS, lower=0, upper=1)
    return LabeledLDA(DOCS, LABS, LABELSET, dicti, alpha=0.1, beta=0.01, seed=seed,
                      k_pad=8, sweep=sweep, device="cpu", **kw)


def _arrays(model, path) -> dict:
    """Every array of ``model``'s checkpoint (counts, means, generator)."""
    save_model(path, model)
    return load_checkpoint(path)[0]


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def _train(model, chunks, iters, thinning, total):
    for i in range(chunks):
        model.run_training(iters, thinning, continue_avg=i > 0, total_iters=total)
    return model


@pytest.mark.parametrize("sweep", SWEEPS)
def test_resume_bit_identical(tmp_path, sweep):
    ckpt = str(tmp_path / "ck")
    ref = _train(_model(sweep), 2, 8, 4, 16)

    m1 = _train(_model(sweep), 1, 8, 4, 16)
    save_model(ckpt, m1, extra_meta={"iters_done": 8})
    m2 = _model(sweep, seed=999)
    meta = restore_model(ckpt, m2)
    assert meta["iters_done"] == 8 and meta["framework"] == "torch"
    assert m2._avg_s == 2 and m2.cur_perplx == m1.cur_perplx
    m2.run_training(8, 4, continue_avg=True, total_iters=16)

    _assert_same(_arrays(m2, str(tmp_path / "b")), _arrays(ref, str(tmp_path / "a")))
    assert m2.cur_perplx == ref.cur_perplx and m2._avg_s == ref._avg_s == 4
    if sweep == "fused":
        assert meta["sampler_formula"] == SAMPLER_FORMULA_VERSION and m2._merge_M == 2


@pytest.mark.parametrize("sweep", SWEEPS)
def test_chunked_run_equals_one_call(tmp_path, sweep):
    one = _train(_model(sweep), 1, 16, 4, 16)
    chunked = _train(_model(sweep), 4, 4, 4, 16)
    _assert_same(_arrays(chunked, str(tmp_path / "b")), _arrays(one, str(tmp_path / "a")))


def _opts(**kw):
    base = dict(file="x", lvl=1, it=8, thinning=2, lower=0.0, upper=1.0,
                alpha=0.1, beta=0.01, pickle=False, seed=7, no_perplexity=True,
                engine="gibbs", sweep="auto", checkpoint=None, save_every=4,
                resume=False, n_chains=1, n_data=1, device="cpu")
    base.update(kw)
    return SimpleNamespace(**base)


@pytest.mark.parametrize("sweep", SWEEPS)
def test_cli_checkpoint_flow(tmp_path, sweep):
    """The CLI's chunk loop: save-every chunks and a resume mid-run give the
    uninterrupted chunked run's state exactly."""
    from lda_thesis_tpu_torch.cli.evaluate_labeled_lda import _train_gibbs, make_config

    train = SimpleNamespace(docs=DOCS, labs=LABS, labelset=LABELSET)
    o_ref = _opts(sweep=sweep)
    ref = _train_gibbs(make_config(o_ref), o_ref, train)
    # a "killed" run of 4 iterations, checkpointed; the resumed run finishes 8
    o_half = _opts(sweep=sweep, it=4, checkpoint=str(tmp_path / "c"))
    _train_gibbs(make_config(o_half), o_half, train)
    o_res = _opts(sweep=sweep, checkpoint=str(tmp_path / "c"), resume=True)
    stats = {}
    res = _train_gibbs(make_config(o_res), o_res, train, stats)
    assert stats["train_iters"] == 4
    _assert_same(_arrays(res, str(tmp_path / "b")), _arrays(ref, str(tmp_path / "a")))


def test_fused_merge_block_mismatch_raises(tmp_path):
    """A resumed fused run that selects another merge block M than the
    checkpointed run raises instead of drawing a different chain."""
    docs = [f"w{i} w{(i+1) % 7} w{(i+2) % 7}".split() for i in range(12)]
    labs = [["A"] if i % 2 else ["B"] for i in range(12)]
    dicti = Dictionary(docs)

    def build():
        return LabeledLDA(docs, labs, ["A", "B"], dicti, alpha=0.1, beta=0.01,
                          seed=0, sweep="fused", device="cpu")

    m1 = build()
    # chunk 1 of a planned 80-sweep run: M = select(25, 10, 80) = 10
    m1.run_training(10, 10, total_iters=80, perplexity=False)
    path = str(tmp_path / "ck")
    save_model(path, m1, extra_meta={"iters_done": 10})
    m2 = build()
    restore_model(path, m2)
    with pytest.raises(ValueError, match="merge-block mismatch"):
        m2.run_training(10, 10, perplexity=False)  # budget 10 -> M = 1
    m2.run_training(10, 10, total_iters=80, perplexity=False)


def test_bucket_and_sweep_mismatch_raise(tmp_path):
    c = planted_corpus(3, **PLANTED_SMALL)  # documents of many lengths
    dicti = prune_dict(c.train_docs, lower=0, upper=1)

    def build(**kw):
        return LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, 0.1, 0.01,
                          device="cpu", **kw)

    path = str(tmp_path / "ck")
    save_model(path, build(n_buckets=1))
    four = build()
    assert len(four.counts.z) > 1
    with pytest.raises(ValueError, match=r"bucket count mismatch.*n_buckets=1.*--n-buckets 1"):
        restore_model(path, four)
    with pytest.raises(ValueError, match="sweep kernel mismatch: checkpoint 'fused'"):
        restore_model(path, build(n_buckets=1, sweep="dense"))
    restore_model(path, build(n_buckets=1))
    small = LabeledLDA(DOCS, LABS, LABELSET, prune_dict(DOCS, lower=0, upper=1), 0.1,
                       0.01, n_buckets=1, device="cpu")
    with pytest.raises(ValueError, match="V mismatch"):
        restore_model(path, small)


def test_generator_state_of_another_device_raises(tmp_path):
    path = str(tmp_path / "ck")
    save_model(path, _model())
    arrays, meta = load_checkpoint(path)
    assert meta["rng_device"] == "cpu"
    meta["rng_device"] = "cuda"
    save_checkpoint(path, arrays, meta)  # the metadata lives in the .npz too
    model = _model()
    before = model._gen.get_state()
    with pytest.raises(ValueError, match="cuda generator state.*draws on cpu"):
        restore_model(path, model)
    assert torch.equal(model._gen.get_state(), before)


def test_formula_version_mismatch_warns(tmp_path):
    path = str(tmp_path / "ck")
    save_model(path, _train(_model(), 1, 4, 2, 4))
    arrays, meta = load_checkpoint(path)
    meta["sampler_formula"] = SAMPLER_FORMULA_VERSION + 1
    save_checkpoint(path, arrays, meta)  # the metadata lives in the .npz too
    with pytest.warns(UserWarning, match="fused sampler formula"):
        restore_model(path, _model())


def test_kinds_not_ported_raise(tmp_path):
    # every kind of the JAX package is ported, the distributed trainers
    # included (test_torch_sharded_io.py, test_torch_hslda_sharded_io.py):
    # only a kind the JAX package lacks raises
    from lda_thesis_tpu_torch.utils.checkpoint import _KINDS

    assert "DistributedHSLDA" in _KINDS and "DistributedLabeledLDA" in _KINDS
    kind = type("GuidedLDA", (), {})
    with pytest.raises(TypeError, match="unknown model kind"):
        save_model(str(tmp_path / "x"), kind())
    with pytest.raises(TypeError, match="unknown model kind"):
        restore_model(str(tmp_path / "x"), kind())


def test_raw_checkpoint_roundtrip(tmp_path):
    p = str(tmp_path / "ckpt")
    arrays = {"x": np.arange(6).reshape(2, 3), "y": np.float32(2.5)}
    meta = {"kind": "test", "alpha": 0.1}
    save_checkpoint(p, arrays, meta)
    a2, m2 = load_checkpoint(p)
    np.testing.assert_array_equal(a2["x"], arrays["x"])
    assert m2 == meta
    assert sorted(os.listdir(tmp_path)) == ["ckpt.json", "ckpt.npz"]


# ------------------------------------------------------------- JAX checkpoints


@pytest.mark.parametrize("sweep", SWEEPS)
def test_jax_checkpoint_restores(tmp_path, sweep):
    path = str(tmp_path / "jax")
    jm = JaxLabeledLDA(DOCS, LABS, LABELSET, jax_prune_dict(DOCS, lower=0, upper=1),
                       alpha=0.1, beta=0.01, seed=7, k_pad=8, sweep=sweep)
    jm.run_training(4, 2)
    jax_save_model(path, jm, extra_meta={"iters_done": 4})
    want, _ = jax_load_checkpoint(path)

    pm = _model(sweep)
    gen = pm._gen.get_state()
    with pytest.warns(UserWarning, match="JAX package.*constructor's generator"):
        meta = restore_model(path, pm)
    assert meta["iters_done"] == 4
    got = _arrays(pm, str(tmp_path / "port"))
    for k in [k for k in want if k != "rng_key"]:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(pm._gen.get_state(), gen)
    assert pm._avg_s == jm._avg_s == 2
    assert pm.cur_perplx == [float(x) for x in jm.cur_perplx] and len(pm.cur_perplx) == 2
    assert getattr(pm, "_ckpt_merge_M", None) == getattr(jm, "_merge_M", None)
    pm.run_training(4, 2, continue_avg=True)
    st = pm.counts
    assert torch.equal(st.n_k, st.n_vk.sum(dim=0))
    assert float(st.n_vk.sum()) == float(sum(x.sum() for x in st.n_dk)) == pm.n_tokens


def test_jax_cascade_checkpoint_restores(tmp_path):
    c = jel_corpus(1, **JEL_SMALL)
    jm = JaxCascadeLDA(c.train_docs, c.train_labs, c.labelset,
                       jax_prune_dict(c.train_docs, lower=0, upper=1), seed=1)
    jm.go_down_tree(2, 2, root_it=2, root_s=2)
    path = str(tmp_path / "jax")
    jax_save_model(path, jm)
    pm = CascadeLDA(c.train_docs, c.train_labs, c.labelset,
                    prune_dict(c.train_docs, lower=0, upper=1), seed=1, device="cpu")
    with pytest.warns(UserWarning, match="JAX package"):
        restore_model(path, pm)
    np.testing.assert_array_equal(pm.ph, jm.ph)
    assert pm.ph.dtype == np.float32


def test_cascade_round_trip(tmp_path):
    c = jel_corpus(1, **JEL_SMALL)
    dicti = prune_dict(c.train_docs, lower=0, upper=1)

    def build(seed):
        return CascadeLDA(c.train_docs, c.train_labs, c.labelset, dicti, seed=seed,
                          device="cpu")

    m1 = build(1)
    m1.go_down_tree(2, 2, root_it=2, root_s=2)
    path = str(tmp_path / "cas")
    save_model(path, m1)
    m2 = build(5)
    restore_model(path, m2)
    np.testing.assert_array_equal(m2.ph, m1.ph)
    assert m2.labelmap == m1.labelmap
    assert m1.test_down_tree_batch(c.test_docs, 3, 3) == m2.test_down_tree_batch(c.test_docs, 3, 3)


def test_pickled_model_continues_its_chain(tmp_path):
    model = _train(_model("dense"), 1, 4, 2, 8)
    clone = pickle.loads(pickle.dumps(model))
    for m in (model, clone):
        m.run_training(4, 2, continue_avg=True, total_iters=8)
    _assert_same(_arrays(clone, str(tmp_path / "b")), _arrays(model, str(tmp_path / "a")))
    np.testing.assert_array_equal(clone.run_test(DOCS[:5], 4, 2), model.run_test(DOCS[:5], 4, 2))


# ----------------------------------------------------------------- elastic


def _make_model():
    return _model("fused")


def test_elastic_restart_bit_identical(tmp_path):
    oracle = elastic_train(_make_model, total_iters=8, thinning=2,
                           checkpoint=str(tmp_path / "oracle"), save_every=4,
                           perplexity=False)
    fails = {"n": 0}
    real_run = ElasticGibbs.run

    def flaky_run(self, total_iters, thinning, save_every=0, **kw):
        real_run(self, min(self.iters + save_every, total_iters), thinning, save_every, **kw)
        if fails["n"] < 2:
            fails["n"] += 1
            raise RuntimeError("injected preemption")
        real_run(self, total_iters, thinning, save_every, **kw)

    seen = []
    ElasticGibbs.run = flaky_run
    try:
        model = elastic_train(_make_model, total_iters=8, thinning=2,
                              checkpoint=str(tmp_path / "el"), save_every=4,
                              on_failure=lambda e, a: seen.append(str(e)),
                              perplexity=False)
    finally:
        ElasticGibbs.run = real_run
    assert fails["n"] == 2 and seen == ["injected preemption"] * 2
    _assert_same(_arrays(model, str(tmp_path / "b")), _arrays(oracle, str(tmp_path / "a")))


def test_elastic_exhausts_restarts(tmp_path):
    def bad_run(self, *a, **kw):
        raise RuntimeError("always down")

    real_run = ElasticGibbs.run
    ElasticGibbs.run = bad_run
    seen = []
    try:
        with pytest.raises(RuntimeError, match="always down"):
            elastic_train(_make_model, total_iters=4, thinning=2,
                          checkpoint=str(tmp_path / "x"), save_every=2, max_restarts=2,
                          on_failure=lambda e, a: seen.append(a))
    finally:
        ElasticGibbs.run = real_run
    assert seen == [1, 2, 3]


def test_resume_first_false_ignores_stale_checkpoint(tmp_path):
    ckpt = str(tmp_path / "stale")
    done = elastic_train(_make_model, total_iters=4, thinning=2, checkpoint=ckpt,
                         save_every=2, perplexity=False)
    stale = done.counts.n_vk.clone()
    fresh = elastic_train(_make_model, total_iters=8, thinning=2, checkpoint=ckpt,
                          save_every=2, resume_first=False, perplexity=False)
    oracle = _model()
    for i in range(4):
        oracle.run_training(2, 2, perplexity=False, continue_avg=i > 0, total_iters=8)
    assert torch.equal(fresh.counts.n_vk, oracle.counts.n_vk)
    assert not torch.equal(fresh.counts.n_vk, stale)


# ---------------------------------------------------------------- progress


def test_progress_reporting(tmp_path):
    model = _make_model()
    lines = []
    prog = tracing.Progress(total_iters=4, tokens_per_iter=model.n_tokens, interval=0.0,
                            printer=lines.append)
    eg = ElasticGibbs(model, str(tmp_path / "ck"), resume=False)
    eg.run(4, 2, save_every=2, progress=prog, perplexity=False)
    assert len(lines) == 2  # one report per chunk
    assert "tokens/s" in lines[-1] and "[4/4]" in lines[-1]


def test_progress_rate_counts_this_session_only():
    lines = []
    prog = tracing.Progress(total_iters=8, tokens_per_iter=10 ** 6, interval=0.0,
                            printer=lines.append, done=4)
    prog.t0 -= 100.0  # this session started 100 s ago and trained 4 iterations
    prog.update(4)
    # 4 iterations in 100 s: 0.04 it/s; counting the resumed ones gives 0.08
    assert lines == ["[8/8] 0.04 it/s, eta 0s, 0.04M tokens/s"]


def test_progress_primed_on_resume(tmp_path, monkeypatch):
    ckpt = str(tmp_path / "pr")
    ElasticGibbs(_make_model(), ckpt, resume=False).run(4, 2, save_every=2, perplexity=False)
    made = []

    class Capturing(tracing.Progress):
        def __init__(self, **kw):
            super().__init__(interval=0.0, printer=lambda s: None, **kw)
            made.append(self)

    monkeypatch.setattr(tracing, "Progress", Capturing)
    eg = ElasticGibbs(_make_model(), ckpt, resume=True)
    assert eg.iters == 4
    eg.run(8, 2, save_every=2, progress=True, perplexity=False)
    assert made[0].done_at_start == 4 and made[0].done == 8 and made[0].total == 8
