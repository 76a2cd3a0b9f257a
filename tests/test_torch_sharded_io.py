"""Sharded checkpoints of the port's DistributedLabeledLDA.

Ported Labeled-LDA cases of ``tests/test_sharded_io.py``: a killed run
resumed from its checkpoint on a fresh model reproduces the uninterrupted
run exactly (four spawned gloo ranks on a (2, 2) mesh, four chains), a
restore validates the chain count, and ``utils/checkpoint.save_model`` /
``restore_model`` dispatch to the sharded format.  Also: a checkpoint that
the JAX package's trainer wrote loads into the port with its arrays exact,
JAX's single-chain vocab-sharded state loads onto two ranks, the shard
files of older iterations are dropped, and a restore on another data-mesh
size is refused.
"""

import os

import jax
import numpy as np
import pytest

from lda_thesis_tpu.data.vocab import Dictionary as JDictionary
from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel.sharded_io import save_sharded as j_save_sharded
from lda_thesis_tpu.parallel.trainer import DistributedLabeledLDA as JDistributed
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.parallel.launch import spawn
from lda_thesis_tpu_torch.parallel.sharded_io import restore_sharded, save_sharded
from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA
from lda_thesis_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    restore_model,
    save_checkpoint,
    save_model,
)

DOCS = [
    "cat dog pet animal fur".split(),
    "dog bark pet tail animal".split(),
    "stock bond market price trade".split(),
    "bond yield market finance price".split(),
    "cat purr whisker pet fur".split(),
    "equity trade finance market price".split(),
] * 4
LABS = [["A"], ["A"], ["B"], ["B"], ["A"], ["B"]] * 4
LABELSET = ["A", "B"]


def _llda(n_chains=4, **kw):
    return DistributedLabeledLDA(DOCS, LABS, LABELSET, Dictionary(DOCS), alpha=0.5, beta=0.1,
                                 n_chains=n_chains, seed=0, device="cpu", **kw)


def _equal_states(a, b):
    for name, x in a._asdict().items():
        y = getattr(b, name)
        if isinstance(x, tuple):
            assert all(np.array_equal(p.numpy(), q.numpy()) for p, q in zip(x, y)), name
        elif isinstance(x, int):
            assert x == y, name
        else:
            np.testing.assert_array_equal(x.numpy(), y.numpy(), err_msg=name)


def test_labeled_kill_resume_bit_identical(tmp_path):
    """Four ranks, (2, 2) mesh: 8 sweeps at thinning 2 against 4 sweeps,
    a checkpoint, a fresh model restored from it and 4 more."""
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:train_job", 4, dict(
        docs=DOCS, labs=LABS, labelset=LABELSET, mesh=(2, 2), estimators=False,
        kw=dict(alpha=0.5, beta=0.1, n_chains=4, seed=0), steps=[(8, 2, None)],
        resume={"path": str(tmp_path / "llda_ckpt"), "at": 4}), device="cpu",
        timeout=240)
    for r in res:
        assert r["resumed_meta_iters"] == 4
        for name, want in r["state"].items():
            np.testing.assert_array_equal(r["resumed_state"][name], want, err_msg=name)
    shards = sorted(f for f in os.listdir(tmp_path) if ".rank" in f)
    assert shards == sorted(f"llda_ckpt.it4.rank{r}.{e}" for r in range(4)
                            for e in ("json", "npz"))


def test_labeled_restore_validates(tmp_path):
    path = str(tmp_path / "llda_ckpt")
    m = _llda()
    m.run_training(2, 2)
    save_sharded(path, m, iters_done=2)
    with pytest.raises(ValueError, match="n_chains"):
        restore_sharded(path, _llda(n_chains=2))
    with pytest.raises(ValueError, match="n_buckets=1"):
        restore_sharded(path, _llda(n_buckets=2))
    arrays, meta = load_checkpoint(path)
    meta["mesh"]["data"] = 2  # as if written by two data shards
    save_checkpoint(path, arrays, meta)
    with pytest.raises(ValueError, match="data-mesh mismatch"):
        restore_sharded(path, _llda())


def test_save_model_dispatches_distributed(tmp_path):
    """``save_model``/``restore_model`` take the distributed trainer to the
    sharded format; older iterations' shards are dropped at each save."""
    path = str(tmp_path / "disp_ckpt")
    m = _llda(sweep="dense")
    m.run_training(2, 2)
    save_model(path, m, extra_meta={"iters_done": 2})
    m.run_training(2, 2)
    save_model(path, m, extra_meta={"iters_done": 4})
    assert sorted(f for f in os.listdir(tmp_path) if ".rank" in f) == [
        "disp_ckpt.it4.rank0.json", "disp_ckpt.it4.rank0.npz"]
    m2 = _llda(sweep="dense")
    meta = restore_model(path, m2)
    assert meta["kind"] == "DistributedLabeledLDA" and meta["iters_done"] == 4
    _equal_states(m2.state, m.state)
    m.run_training(2, 2)
    m2.run_training(2, 2)
    _equal_states(m2.state, m.state)  # the generators carried over


def test_restore_reads_jax_checkpoint(tmp_path):
    """A checkpoint of the JAX trainer (fused, two chains on one device)
    restores into the port with every array exact, the sweep count and
    merge block carried, and a warning that the generators are the
    constructor's; training then continues."""
    mesh = j_make_mesh(n_data=1, n_chains=1, devices=jax.devices()[:1])
    jm = JDistributed(DOCS, LABS, LABELSET, JDictionary(DOCS), alpha=0.5, beta=0.1,
                      mesh=mesh, n_chains=2, seed=0)
    jm.run_training(4, 2, total_iters=16)
    path = str(tmp_path / "jax_ckpt")
    j_save_sharded(path, jm, iters_done=4)
    m = _llda(n_chains=2)
    with pytest.warns(UserWarning, match="JAX package"):
        meta = restore_sharded(path, m)
    assert meta["iters_done"] == 4 and m._sweeps_done == 4 and m._ckpt_merge_M == 2
    for name in ("z", "n_dk", "n_vk", "n_k", "ph_hat", "th_hat"):
        np.testing.assert_array_equal(getattr(m.state, name).numpy(),
                                      np.asarray(getattr(jm.state, name)), err_msg=name)
    assert m.state.s == int(jm.state.s)
    m.run_training(4, 2, total_iters=16)
    assert float(m.state.n_vk[1].sum()) == m.n_tokens


def test_jax_single_chain_vocab_state_loads_on_two_ranks():
    """JAX's single-chain vocab-sharded state (no chain axis; 17 words
    padded to 18 rows over two shards) loads into a two-rank port trainer
    through ``sharded_state_from_numpy``: each rank holds its documents and
    its vocabulary rows, exactly, and the counts' invariants hold."""
    mesh = j_make_mesh(n_data=2, n_chains=1, devices=jax.devices()[:2])
    jm = JDistributed(DOCS, LABS, LABELSET, JDictionary(DOCS), alpha=0.5, beta=0.1,
                      mesh=mesh, n_chains=1, seed=0, table_shard="vocab")
    jm.run_training(4, 2, total_iters=16)
    want = {f: np.asarray(getattr(jm.state, f)) for f in jm.state._fields}
    assert want["n_vk"].shape[0] == 18 and want["z"].ndim == 2
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:train_job", 2, dict(
        docs=DOCS, labs=LABS, labelset=LABELSET, mesh=(1, 2), steps=[], estimators=False,
        kw=dict(alpha=0.5, beta=0.1, n_chains=1, seed=0, table_shard="vocab"), init=want),
        device="cpu", timeout=240)
    for field, axis in (("z", 2), ("n_dk", 2), ("n_vk", 1), ("ph_hat", 1), ("th_hat", 1)):
        got = np.concatenate([r["state"][field] for r in res], axis=axis)
        np.testing.assert_array_equal(got, want[field][None], err_msg=field)
    for r in res:
        np.testing.assert_array_equal(r["state"]["n_k"], want["n_k"][None])
        assert r["state"]["s"] == int(want["s"]) and r["invariants"]["ok"]
