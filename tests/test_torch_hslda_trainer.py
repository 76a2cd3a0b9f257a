"""The port's DistributedHSLDA: multi-chain sharded training and chain-averaged tests.

Ported cases of ``tests/test_hslda_trainer.py``: the count invariants, the
thinned φ̂, the diagnostics reading chain 0 and the thinned average
restarting per call, on a (2 chains, 2 data) mesh of four spawned CPU ranks
with four chains (JAX: (2, 4) on eight fake devices); the pickle round
trip, the API of the single-chain ``HSLDA``, and chunked training equal to
one call (bitwise), on one process.  The chain-averaged prediction equals
the mean of the per-chain ``_test_loop`` scores, and the chains' batched
fold-in equals JAX's vmapped ``_test_loop`` with JAX's uniforms within
``test_test_loop_matches_jax``'s tolerance.  Also the 64-chain north star
of ``tests/test_bootstrap.py``, at its size, on one CPU rank.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lda_thesis_tpu.models import hslda as jhslda
from lda_thesis_tpu_torch.data.encode import encode_instances
from lda_thesis_tpu_torch.models import hslda as thslda
from lda_thesis_tpu_torch.models.hslda import HSLDA
from lda_thesis_tpu_torch.ops.sampling import norm_cdf, stirling_table
from lda_thesis_tpu_torch.parallel import DistributedHSLDA, chains_for, make_mesh
from lda_thesis_tpu_torch.parallel.hslda_sharded import (
    init_hslda_sharded,
    make_hslda_generators,
    make_hslda_train_step,
    shard_hslda_corpus,
)
from lda_thesis_tpu_torch.parallel.jobs import hslda_invariants
from lda_thesis_tpu_torch.parallel.launch import spawn

DOCS = [
    ["market", "price", "trade", "price"],
    ["labor", "wage", "firm"],
    ["growth", "policy", "market", "tax", "trade"],
    ["wage", "firm", "labor", "labor"],
    ["tax", "policy", "growth"],
    ["price", "market", "demand", "supply"],
    ["credit", "risk", "banking"],
    ["banking", "credit", "tax"],
] * 2
LABS = [["A1"], ["B1"], ["A1", "C1"], ["B1"], ["C1"], ["A1"], ["D1"], ["D1", "C1"]] * 2
LABELSET = ["A", "A1", "B", "B1", "C", "C1", "D", "D1"]


def _model(n_chains=4, **kw):
    return DistributedHSLDA(DOCS, LABS, LABELSET, n_chains=n_chains, k=4,
                            seed=kw.pop("seed", 0), device="cpu", **kw)


@pytest.fixture(scope="module")
def ranks():
    payload = dict(docs=DOCS, labs=LABS, labelset=LABELSET, mesh=(2, 2),
                   kw=dict(n_chains=4, k=4, seed=0),
                   steps=[(4, 2, 1, False), (2, 2, 1, False)], diagnostics=True,
                   test=([["market", "price"], ["labor", "wage", "wage"]], 8, 4))
    return spawn("lda_thesis_tpu_torch.parallel.jobs:hslda_job", 4, payload, device="cpu",
                 timeout=200)


@pytest.fixture(scope="module")
def trained():
    m = _model()
    m.run_training(it=4, thinning=2, opt=1)
    return m


def test_training_count_invariants(ranks):
    total = sum(len(d) for d in DOCS)
    for r in ranks:
        assert all(r["replicas_equal"]), r["replicas_equal"]
        assert r["invariants"]["ok"] and r["invariants"]["total"] == total
        assert r["state"]["n_vk"].shape[0] == 2  # two of the four chains on each rank
        np.testing.assert_array_equal(r["state"]["n_k"], r["state"]["n_vk"].sum(axis=1))
        assert r["backend"] == "gloo" and r["device"] == "cpu"


def test_thinned_ph_hat(trained):
    assert trained._ph_hat is not None and tuple(trained._ph_hat.shape) == (4, 4, trained.V)
    np.testing.assert_allclose(trained._ph_hat.sum(dim=2).numpy(), 1.0, rtol=1e-5)


def test_chain_averaged_prediction(ranks):
    for r in ranks:
        s = r["scores"]
        assert s.shape == (2, len(LABELSET) + 1)
        assert (s >= 0).all() and (s <= 1).all() and np.isfinite(s).all()
        np.testing.assert_array_equal(s, ranks[0]["scores"])  # the same on every rank


def test_diagnostics_read_trained_state(ranks):
    """get_ph/get_zbar/display_topics read the trained chain 0 of the mesh,
    not the constructor's state, and are the same on every rank."""
    for r in ranks:
        assert r["get_ph"].shape == (4, r["chain_ph"].shape[2])
        np.testing.assert_allclose(r["get_ph"], r["chain_ph"][0])
        np.testing.assert_allclose(r["get_zbar"].sum(axis=1), 1.0, rtol=1e-5)
        assert r["get_zbar"].shape == (len(DOCS), 4)
        assert len(r["topics"]) == 4 and all(len(t) == 3 for t in r["topics"])
        np.testing.assert_array_equal(r["get_zbar"], ranks[0]["get_zbar"])
    # chain 0 lives on ranks 0 and 1: its z̄ is their documents' n_dk
    n_dk = np.concatenate([ranks[0]["state"]["n_dk"][0], ranks[1]["state"]["n_dk"][0]])
    n_d = np.array([len(d) for d in DOCS])
    np.testing.assert_allclose(ranks[0]["get_zbar"], n_dk[:len(DOCS)] / n_d[:, None])


def test_pickle_roundtrip(trained):
    """A trained one-rank DistributedHSLDA pickles without its process
    groups or graphs, predicts, and trains on over a one-rank mesh."""
    m2 = pickle.loads(pickle.dumps(trained))
    for f in trained.state._fields:
        assert torch.equal(getattr(m2.state, f), getattr(trained.state, f)), f
    np.testing.assert_allclose(m2.get_ph(), trained.get_ph())
    s = m2.run_tests([["market", "price"]], it=4, s=2)
    assert s.shape == (1, m2.L) and np.isfinite(s).all()
    assert m2.mesh is not None and m2.mesh.single_device
    m2.run_training(it=2, thinning=2, opt=1)
    assert m2._n_saves == 1


def test_thinned_average_resets_per_call(ranks):
    """A second run_training call restarts the thinned φ̂ mean (the base
    class's semantics) instead of continuing the first call's average."""
    for r in ranks:
        assert r["n_saves_by_step"] == [2, 1]
        assert r["cycles_done"] == 6


def test_api_matches_single_chain():
    """HSLDA's constructor surface; one mesh row, one chain, opt 2."""
    mesh = make_mesh(n_data=1, n_chains=1, device="cpu")
    m = DistributedHSLDA(DOCS, LABS, LABELSET, mesh=mesh, n_chains=1, k=3, seed=1)
    assert isinstance(m, HSLDA) and m.device.type == "cpu"
    m.run_training(it=2, thinning=2, opt=2)
    s = m.run_tests([["market", "tax"]], it=4, s=2)
    assert s.shape == (1, m.L) and np.isfinite(s).all()
    assert m.run_test(["market", "tax"], it=4, s=2).shape == (m.L,)
    with pytest.raises(ValueError, match="positive multiple"):
        DistributedHSLDA(DOCS, LABS, LABELSET, mesh=make_mesh(n_chains=1, device="cpu"),
                         n_chains=0, k=3)
    with pytest.raises(ValueError, match="table_shard"):
        DistributedHSLDA(DOCS, LABS, LABELSET, device="cpu", table_shard="rows", k=3)


def test_internal_chunking_equals_single_call():
    """Chunked training (10 + 10 + 5 cycles, the mean carried across) equals
    one 25-cycle call bitwise: state, thinned φ̂ and save count."""
    one = _model(seed=3)
    one.run_training(it=25, thinning=5, opt=1)
    chunked = _model(seed=3)
    for i, it in enumerate((10, 10, 5)):
        chunked.run_training(it=it, thinning=5, opt=1, continue_avg=i > 0)
    for f in one.state._fields:
        assert torch.equal(getattr(chunked.state, f), getattr(one.state, f)), f
    assert torch.equal(chunked._ph_hat, one._ph_hat)
    assert chunked._n_saves == one._n_saves == 5 and chunked._cycles_done == 25


def _fold_in_inputs(m):
    ph = m._ph_hat.numpy()
    init_phi = np.ascontiguousarray(ph.transpose(0, 2, 1)).astype(np.float32)
    sweep = m.state.n_vk.numpy().astype(np.float64) + m.gamma
    sweep_phi = (sweep / sweep.sum(axis=1, keepdims=True)).astype(np.float32)
    ab = (m.alpha * m.state.beta).numpy()
    return init_phi, sweep_phi, ab


def test_prediction_is_the_mean_of_per_chain_scores(trained):
    """run_tests equals the mean over chains of Φ(η_c·z̄_c − ξ), each z̄_c from
    the single-chain ``_test_loop`` on chain c's columns of the uniforms
    that the model's fold-in generator draws."""
    m = trained
    docs = [["market", "price"], ["labor", "wage", "wage"], ["credit", "tax"]]
    tok_v, mask = m._encode_test(docs)
    Dt, N = tok_v.shape
    it, s = 6, 3
    gen = torch.Generator().set_state(m._gen.get_state())
    u0 = torch.rand((N, 4 * Dt), generator=gen)
    us = [torch.rand((N, 4 * Dt), generator=gen) for _ in range(it)]
    scores = m.run_tests(docs, it=it, s=s)
    init_phi, sweep_phi, ab = _fold_in_inputs(m)
    per_chain = []
    for c in range(4):
        cols = slice(c * Dt, (c + 1) * Dt)
        zbar = thslda._test_loop(tok_v, mask, torch.from_numpy(init_phi[c]),
                                 torch.from_numpy(sweep_phi[c]), torch.from_numpy(ab[c]), it, s,
                                 init_uniforms=u0[:, cols],
                                 sweep_uniforms=[u[:, cols] for u in us])
        mean_a = zbar.numpy() @ m.state.eta[c].numpy().T - np.float32(m.xi)
        per_chain.append(norm_cdf(torch.from_numpy(mean_a)).numpy())
    np.testing.assert_allclose(scores, np.mean(per_chain, axis=0), rtol=1e-6, atol=1e-7)


def test_batched_fold_in_matches_jax_vmap(trained):
    """The chains' fold-in in one batch against JAX's vmapped ``_test_loop``
    (``hslda_trainer.py:239-243``) with JAX's uniforms of each chain's key."""
    m = trained
    docs = [["market", "price"], ["labor", "wage", "wage"], ["credit", "tax"]]
    tok_v, mask = (x.numpy() for x in m._encode_test(docs))
    Dt, N = tok_v.shape
    init_phi, sweep_phi, ab = _fold_in_inputs(m)
    it, thinning = 4, 2
    keys = jax.random.split(jax.random.PRNGKey(3), 4)
    want = jax.vmap(lambda kk, ip, sp, a: jhslda._test_loop(
        kk, tok_v, mask, ip, sp, a, it=it, thinning=thinning))(
        keys, jnp.asarray(init_phi), jnp.asarray(sweep_phi), jnp.asarray(ab))
    u0, us = [], [[] for _ in range(it)]
    for k in keys:
        k_init, k_sweeps = jax.random.split(k)
        u0.append(np.asarray(jax.random.uniform(k_init, (N, Dt), dtype=jnp.float32)))
        for i, ks in enumerate(jax.random.split(k_sweeps, it)):
            us[i].append(np.asarray(jax.random.uniform(ks, (N, Dt), dtype=jnp.float32)))
    got = thslda.chains_test_loop(
        torch.from_numpy(tok_v), torch.from_numpy(mask), torch.from_numpy(init_phi),
        torch.from_numpy(sweep_phi), torch.from_numpy(ab), it, thinning,
        init_uniforms=torch.from_numpy(np.concatenate(u0, axis=1)),
        sweep_uniforms=[torch.from_numpy(np.concatenate(u, axis=1)) for u in us])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_north_star_64_chain_hslda():
    """``tests/test_bootstrap.py``'s north star: 64 HSLDA chains, one full
    blocked-Gibbs cycle keeping every chain's count invariants, here all 64
    batched on one CPU rank."""
    mesh = make_mesh(n_data=1, n_chains=1, device="cpu")
    assert chains_for(64, mesh) == (1, 64)
    rng = np.random.default_rng(0)
    D, V, K, L = 16, 32, 4, 5
    docs = [rng.integers(0, V, size=rng.integers(3, 7)).tolist() for _ in range(D)]
    tok_v, mask = encode_instances(docs)
    labs = np.zeros((D, L), np.float32)
    labs[:, 0] = 1
    for d in range(D):
        labs[d, rng.integers(1, L)] = 1
    corpus = shard_hslda_corpus(mesh, tok_v, mask, labs)
    gens = make_hslda_generators(mesh, 64, seed=0)
    state = init_hslda_sharded(mesh, corpus, V, K, 64, gens)
    t = stirling_table(16)
    logs = torch.from_numpy(np.log(np.where(t > 0, t, 1e-300)).astype(np.float32))
    step = make_hslda_train_step(mesh, corpus, 64, logs, D_total=D)
    after = step(state, gens)
    assert after.z.shape[0] == 64 and not torch.equal(after.z, state.z)
    inv = hslda_invariants(mesh, after, int(mask.sum()), "replicated")
    assert inv["ok"] and len(inv["n_dk"]) == 64, inv
    assert torch.isfinite(after.eta).all() and torch.isfinite(after.beta).all()
