"""HSLDA checkpoints, the torn-pair repair and the HSLDA CLI of the port, on the CPU.

Ports ``tests/test_checkpoint.py``'s HSLDA cases: a round trip, and a
chunked run saved and restored into a model built with another seed that
ends bitwise equal to the uninterrupted run (counts, η, a, β, φ̂, z̄ and
the generator).  A checkpoint that the JAX package wrote loads its arrays
exactly and warns that the draw stream does not carry over.  A checkpoint
whose ``.npz`` is new and whose ``.json`` is old (a kill between the two
renames) loads with the ``.npz``'s own metadata.  The CLI runs on a tiny
CSV with ``--device cpu``; a run stopped after its first checkpoint and
resumed prints the uninterrupted run's metric lines.
"""

import json
import re
import shutil

import numpy as np
import pytest
import torch

from lda_thesis_tpu.models.hslda import HSLDA as JaxHSLDA
from lda_thesis_tpu.utils.checkpoint import load_checkpoint as jax_load_checkpoint
from lda_thesis_tpu.utils.checkpoint import save_model as jax_save_model
from lda_thesis_tpu_torch.cli import evaluate_hslda
from lda_thesis_tpu_torch.models.hslda import HSLDA
from lda_thesis_tpu_torch.utils.checkpoint import (
    META_ARRAY,
    load_checkpoint,
    restore_model,
    save_model,
)
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs
from test_cli_smoke import _capture, corpus_csv  # noqa: F401  (a fixture)

DOCS = [
    "cat dog pet animal".split(),
    "stock bond market price".split(),
    "dog bark pet tail".split(),
    "bond yield market trade".split(),
] * 3
LABS = [["A"], ["B"], ["A"], ["B"]] * 3
METRIC_LINES = re.compile(r"^(AUC ROC|one error|two error|F1 score).*$", re.M)


def _model(seed=3, **kw):
    return HSLDA(DOCS, LABS, ["A", "B"], k=4, seed=seed, device="cpu", **kw)


def _arrays(model, path) -> dict:
    save_model(path, model)
    return load_checkpoint(path)[0]


def _assert_same(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_hslda_roundtrip(tmp_path):
    p = str(tmp_path / "h")
    m1 = _model()
    m1.run_training(it=2, thinning=2)
    save_model(p, m1)
    m2 = _model(seed=99)
    meta = restore_model(p, m2)
    assert meta["kind"] == "HSLDA" and meta["framework"] == "torch"
    assert meta["token2id"] == m1.w_to_v and meta["labelmap"] == m1.labelmap
    assert torch.equal(m1.eta, m2.eta) and torch.equal(m1.beta, m2.beta)
    assert torch.equal(m1.a, m2.a) and torch.equal(m1.counts.z, m2.counts.z)
    np.testing.assert_array_equal(m1.ph, m2.ph)
    assert m2._avg_s == 1 and m2._cycles_done == 2
    assert torch.equal(m1._gen.get_state(), m2._gen.get_state())


@pytest.mark.parametrize("opt", [1, 2, 3])
def test_hslda_chunked_resume_bit_identical(tmp_path, opt):
    """A save, restore and continue reproduces one uninterrupted call bit
    for bit: counts, η, a, β, the thinned means and the generator."""
    p = str(tmp_path / "h")
    full = _model()
    full.run_training(it=8, thinning=2, opt=opt)

    part = _model()
    part.run_training(it=4, thinning=2, opt=opt)
    save_model(p, part, {"iters_done": 4})

    resumed = _model(seed=99)
    meta = restore_model(p, resumed)
    assert meta["iters_done"] == 4 and meta["cycles_done"] == 4
    resumed.run_training(it=4, thinning=2, opt=opt, continue_avg=True)
    _assert_same(_arrays(resumed, str(tmp_path / "b")), _arrays(full, str(tmp_path / "a")))
    assert resumed._avg_s == full._avg_s == 4


def test_elastic_chunks_equal_one_call(tmp_path):
    one = _model()
    one.run_training(it=8, thinning=2)
    eg = ElasticGibbs(_model(), str(tmp_path / "el"), resume=False)
    eg.run(8, 2, save_every=4, opt=1)
    _assert_same(_arrays(eg.model, str(tmp_path / "b")), _arrays(one, str(tmp_path / "a")))


def test_jax_hslda_checkpoint_restores(tmp_path):
    path = str(tmp_path / "jax")
    jm = JaxHSLDA(DOCS, LABS, ["A", "B"], k=4, seed=3)
    jm.run_training(it=2, thinning=2)
    jax_save_model(path, jm, extra_meta={"iters_done": 2})
    want, _ = jax_load_checkpoint(path)

    pm = _model(seed=5)
    gen = pm._gen.get_state()
    with pytest.warns(UserWarning, match="JAX package.*constructor's generator"):
        meta = restore_model(path, pm)
    assert meta["iters_done"] == 2 and meta["cycles_done"] == 2
    assert pm._avg_s == 1 and pm._cycles_done == 2
    got = _arrays(pm, str(tmp_path / "port"))
    for k in [k for k in want if k not in ("rng_key", "master_key")]:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert torch.equal(pm._gen.get_state(), gen)
    pm.run_training(it=2, thinning=2, continue_avg=True)  # the chain goes on
    assert int(pm.counts.n_vk.sum()) == int(pm.mask.sum())


def test_torn_checkpoint_pair_loads_npz_metadata(tmp_path):
    """Checkpoint A, then B; A's ``.json`` put back beside B's ``.npz`` is
    what a kill between the two renames leaves.  Both ``load_checkpoint``
    and ``restore_model`` give B's metadata."""
    path = str(tmp_path / "ck")
    m = _model()
    m.run_training(it=2, thinning=2)
    save_model(path, m, {"iters_done": 2})
    shutil.copy(path + ".json", str(tmp_path / "a.json"))
    m.run_training(it=2, thinning=2, continue_avg=True)
    save_model(path, m, {"iters_done": 4})
    shutil.copy(str(tmp_path / "a.json"), path + ".json")
    with open(path + ".json") as f:
        assert json.load(f)["iters_done"] == 2  # the stale marker

    arrays, meta = load_checkpoint(path)
    assert META_ARRAY not in arrays
    assert meta["iters_done"] == 4 and meta["cycles_done"] == 4 and meta["avg_s"] == 2
    fresh = _model(seed=99)
    meta = restore_model(path, fresh)
    assert meta["iters_done"] == 4 and fresh._cycles_done == 4 and fresh._avg_s == 2
    assert torch.equal(fresh.counts.z, m.counts.z) and torch.equal(fresh.eta, m.eta)
    assert ElasticGibbs(_model(seed=7), path, resume=True).iters == 4


# ---------------------------------------------------------------------- CLI


def _cli(corpus_csv, *extra):
    return evaluate_hslda.main(["-f", corpus_csv, "-d", "3", "-k", "5", "-i", "4", "-s", "2",
                                "--test-it", "4", "--test-s", "2", "--seed", "3",
                                "--device", "cpu", *extra])


@pytest.mark.parametrize("opt", ["1", "2", "3"])
def test_hslda_cli(corpus_csv, capsys, opt):
    res = _cli(corpus_csv, "--opt", opt)
    out, aucs = _capture(capsys)
    m = res["model"]
    assert isinstance(m, HSLDA) and m.device.type == "cpu" and m.K == 5
    assert "Model:               HSLDA (PyTorch, cpu)" in out
    assert len(aucs) == 1 and res["metrics"]["auc_roc"] == aucs[0] and 0.0 <= aucs[0] <= 1.0
    assert res["scores"].shape[1] == m.L and m.labelmap[""] == 0
    st = res["stats"]
    assert st["train_cycles"] == 4 and m._cycles_done == 4
    assert all(st[k] >= 0 for k in ("load_s", "model_s", "train_s", "test_s", "metrics_s"))
    assert f"(4 cycles, opt {opt})" in out and "wall time by step: load+preprocess" in out


def test_hslda_cli_resume_equals_uninterrupted(corpus_csv, capsys, tmp_path):
    ref = _cli(corpus_csv, "--checkpoint", str(tmp_path / "ref"), "--save-every", "2")
    ref_out = capsys.readouterr().out
    ck = str(tmp_path / "ck")
    # a run stopped after its first checkpoint, then resumed in a new model
    evaluate_hslda.main(["-f", corpus_csv, "-d", "3", "-k", "5", "-i", "2", "-s", "2",
                         "--test-it", "4", "--test-s", "2", "--seed", "3",
                         "--device", "cpu", "--checkpoint", ck, "--save-every", "2"])
    capsys.readouterr()
    res = _cli(corpus_csv, "--checkpoint", ck, "--save-every", "2", "--resume")
    out = capsys.readouterr().out
    assert "resumed from" in out and res["stats"]["train_cycles"] == 2
    assert METRIC_LINES.findall(out) == METRIC_LINES.findall(ref_out)
    _assert_same(load_checkpoint(ck)[0], load_checkpoint(str(tmp_path / "ref"))[0])
    np.testing.assert_array_equal(res["scores"], ref["scores"])


def test_hslda_cli_max_restarts(corpus_csv, capsys, tmp_path):
    _cli(corpus_csv, "--checkpoint", str(tmp_path / "ck"), "--save-every", "2",
         "--max-restarts", "2")
    out, aucs = _capture(capsys)
    assert len(aucs) == 1 and "checkpointed at iteration 4/4" in out


# --n-chains and --n-data are ported; a mesh that one process cannot fill
# is still refused
@pytest.mark.parametrize("flags", [["--n-chains", "2", "--n-data", "2"], ["--n-data", "2"]])
def test_hslda_cli_multi_device_refused(corpus_csv, flags):
    with pytest.raises(SystemExit, match="does not divide 1 ranks"):
        _cli(corpus_csv, *flags)


def test_hslda_cli_save_every_must_align(corpus_csv, tmp_path):
    with pytest.raises(SystemExit, match="multiple of -s"):
        _cli(corpus_csv, "--checkpoint", str(tmp_path / "ck"), "--save-every", "3")
