"""Sharded checkpoints of the port's DistributedHSLDA (``parallel/sharded_io.py``).

The port of ``tests/test_sharded_io.py``'s HSLDA kill and resume, on two
spawned gloo CPU ranks: a run saved after its first two cycles and resumed
in a fresh model ends bitwise equal to the uninterrupted run (every state
array, the thinned φ̂ and every generator), and a model built with another
chain count refuses the checkpoint.  On one process: ``save_model`` and
``restore_model`` dispatch to the sharded format; a checkpoint that the JAX
package's ``DistributedHSLDA`` wrote loads through
``convert.hslda_sharded_state_from_numpy`` (arrays exact, a warning that the
draw stream does not carry over) and trains on with its invariants intact;
and a restore refuses a model of another ``n_chains``, K, L, V, D or
``table_shard``.
"""

import os

import jax
import numpy as np
import pytest
import torch

from lda_thesis_tpu.parallel import DistributedHSLDA as JDistributedHSLDA
from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel.sharded_io import save_hslda_sharded as j_save
from lda_thesis_tpu_torch.parallel import DistributedHSLDA
from lda_thesis_tpu_torch.parallel.jobs import hslda_invariants
from lda_thesis_tpu_torch.parallel.launch import spawn
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, restore_model, save_model

DOCS = [
    "cat dog pet animal fur".split(),
    "dog bark pet tail animal".split(),
    "stock bond market price trade".split(),
    "bond yield market finance price".split(),
    "cat purr whisker pet fur".split(),
    "equity trade finance market price".split(),
] * 3
LABS = [["A1"], ["A1"], ["B1"], ["B2"], ["A2"], ["B1"]] * 3
LABELSET = ["A", "A1", "A2", "B", "B1", "B2"]
FIELDS = ("z", "n_dk", "n_vk", "n_k", "eta", "a", "beta")


def _model(docs=DOCS, labs=LABS, labelset=LABELSET, **kw):
    kw = dict(dict(n_chains=2, k=4, seed=0), **kw)
    return DistributedHSLDA(docs, labs, labelset, device="cpu", **kw)


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("hck") / "hslda_ckpt")
    payload = dict(docs=DOCS, labs=LABS, labelset=LABELSET, mesh=(1, 2),
                   kw=dict(n_chains=2, k=4, seed=0), steps=[(4, 2, 1, False)],
                   resume={"path": path, "at": 2, "wrong_kw": {"n_chains": 4}})
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:hslda_job", 2, payload, device="cpu",
                timeout=200)
    return res, path


def test_hslda_kill_resume_bit_identical(ranks):
    res, path = ranks
    for r in res:
        assert r["resumed_meta"] == {"iters_done": 2, "n_saves": 1, "cycles_done": 2}
        for f in FIELDS:
            np.testing.assert_array_equal(r["resumed_state"][f], r["state"][f], err_msg=f)
        np.testing.assert_array_equal(r["resumed_ph_hat"], r["ph_hat"])
        assert len(r["resumed_gens"]) == 4  # two chains, a local and a replicated generator
        for a, b in zip(r["resumed_gens"], r["uninterrupted_gens"]):
            np.testing.assert_array_equal(a, b)
    # one shard per rank beside the marker
    arrays, meta = load_checkpoint(path)
    assert meta["kind"] == "DistributedHSLDA" and meta["mesh"] == {"chains": 1, "data": 2}
    assert meta["shards"] == [f"hslda_ckpt.it2.rank{r}" for r in range(2)]
    for name in meta["shards"]:
        shard, smeta = load_checkpoint(os.path.join(os.path.dirname(path), name))
        assert set(shard) >= {"z", "n_dk", "a", "n_vk", "n_k", "eta", "beta_vec", "ph_hat",
                              "gen_states", "chain_gen_states"}
    assert "rng_state" in arrays


def test_wrong_chain_count_refused_on_ranks(ranks):
    for r in ranks[0]:
        assert r["wrong_restore"] is not None and "n_chains mismatch" in r["wrong_restore"]


def test_save_model_dispatches_distributed_hslda(tmp_path):
    """``save_model``/``restore_model`` take a DistributedHSLDA to the sharded
    format; a chunked run through them equals the uninterrupted one."""
    ref = _model()
    ref.run_training(4, 2)
    first = _model()
    first.run_training(2, 2)
    path = str(tmp_path / "ck")
    save_model(path, first, extra_meta={"iters_done": 2})
    assert os.path.exists(path + ".it2.rank0.npz")
    second = _model(seed=9)  # another seed: every generator comes from the checkpoint
    meta = restore_model(path, second)
    assert meta["iters_done"] == 2 and meta["cycles_done"] == 2
    second.run_training(2, 2, continue_avg=True)
    for f in FIELDS:
        assert torch.equal(getattr(second.state, f), getattr(ref.state, f)), f
    assert torch.equal(second._ph_hat, ref._ph_hat) and second._n_saves == 2


def test_jax_checkpoint_loads_and_trains_on(tmp_path):
    """A checkpoint of the JAX package's DistributedHSLDA on a (2, 2) mesh
    of fake devices loads into the port on one rank: the arrays exact, the
    thinned φ̂ and the counters, a warning about the draw stream; then it
    trains on with every chain's invariants intact."""
    mesh = j_make_mesh(n_chains=2, n_data=2, devices=jax.devices()[:4])
    jm = JDistributedHSLDA(DOCS, LABS, LABELSET, mesh=mesh, n_chains=4, k=4, seed=0)
    jm.run_training(it=2, thinning=2, opt=1)
    path = str(tmp_path / "jax")
    j_save(path, jm, iters_done=2)
    m = _model(n_chains=4)
    with pytest.warns(UserWarning, match="threefry"):
        meta = restore_model(path, m)
    assert meta["iters_done"] == 2 and m._n_saves == 1 and m._cycles_done == 2
    want = {f: np.asarray(getattr(jm.state, f)) for f in FIELDS}
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(m.state, f).numpy(), want[f], err_msg=f)
    np.testing.assert_array_equal(m._ph_hat.numpy(), np.asarray(jm._ph_hat))
    m.run_training(2, 2, continue_avg=True)
    inv = hslda_invariants(m.mesh, m.state, m.n_tokens, "replicated")
    assert inv["ok"] and len(inv["n_dk"]) == 4, inv
    assert m._n_saves == 2 and m._cycles_done == 4


MISMATCH = {
    "n_chains": dict(kw=dict(n_chains=4)),
    "K": dict(kw=dict(k=5)),
    "L": dict(labelset=LABELSET + ["C"]),
    "V": dict(docs=[DOCS[0][:-1] + ["zebra"]] + DOCS[1:]),
    "D": dict(docs=DOCS + [DOCS[0]], labs=LABS + [LABS[0]]),
    "table_shard": dict(kw=dict(table_shard="vocab")),
}


@pytest.mark.parametrize("what", list(MISMATCH))
def test_restore_refuses_mismatch(tmp_path, what):
    path = str(tmp_path / "ck")
    m = _model()
    m.run_training(2, 2)
    save_model(path, m, extra_meta={"iters_done": 2})
    case = MISMATCH[what]
    other = _model(case.get("docs", DOCS), case.get("labs", LABS),
                   case.get("labelset", LABELSET), **case.get("kw", {}))
    with pytest.raises(ValueError, match=f"{what} (mismatch|is)"):
        restore_model(path, other)
