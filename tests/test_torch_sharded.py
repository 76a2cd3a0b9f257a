"""The port's dense AD-LDA layer (``parallel/sharded.py``) on gloo ranks.

Ported cases of ``tests/test_sharded.py``, run by the port on a (2 chains,
2 data) mesh of four spawned CPU ranks (the JAX cases use a (2, 4) mesh of
eight fake devices): count invariants, exactness at one data shard, the
stationary statistics against the serial sampler, and the pooled φ̂.  Also
one dense AD-LDA step against JAX's, bitwise, from JAX's own init state
and with JAX's uniforms rebuilt from its keys.  All the four-rank runs go
through one spawn.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lda_thesis_tpu.ops.gibbs import init_counts as j_init_counts
from lda_thesis_tpu.ops.gibbs import train_sweep as j_train_sweep
from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel import make_sharded_train_step as j_make_step
from lda_thesis_tpu.parallel import shard_corpus as j_shard_corpus
from lda_thesis_tpu.parallel.sharded import init_sharded_state as j_init_sharded
from lda_thesis_tpu_torch.ops.gibbs import init_counts, train_sweep
from lda_thesis_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_corpus
from lda_thesis_tpu_torch.parallel.launch import spawn
from lda_thesis_tpu_torch.parallel.sharded import init_sharded_state, make_generators

MESH, WORLD = (2, 2), 4


def _toy(D=24, U=8, V=32, K=8, seed=0):
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    tok_f = rng.integers(1, 4, size=(D, U)).astype(np.int32)
    tok_f[:, U - 2:] = 0  # padding slots
    labs = (rng.random((D, K)) < 0.4).astype(np.float32)
    labs[:, 0] = 1.0
    return tok_v, tok_f, labs


def _assemble(results, field, doc_axis, S=MESH[1]):
    """Global (C, ...) array from the ranks' local ones (rank = ci·S + di)."""
    rows = []
    for ci in range(len(results) // S):
        parts = [results[ci * S + di]["state"][field] for di in range(S)]
        rows.append(np.concatenate(parts, axis=doc_axis) if doc_axis else parts[0])
    return np.concatenate(rows, axis=0)


def _jax_parity_case():
    """JAX's init and one step on a (2, 2) mesh of four chains (two per
    chain row), and the uniforms of each (chain, shard) rebuilt from the
    step's key as ``train_sweep`` draws them."""
    tok_v, tok_f, labs = _toy(D=21, U=8, V=16, K=8, seed=4)  # documents padded to 22
    V, C, alpha, beta = 16, 4, 0.3, 0.05
    mesh = j_make_mesh(n_data=2, n_chains=2, devices=jax.devices()[:4])
    tv, tf, lb = j_shard_corpus(mesh, tok_v, tok_f, labs)
    state = j_init_sharded(jax.random.PRNGKey(3), mesh, tv, tf, lb, V, n_chains=C)
    step = j_make_step(mesh, C, alpha=alpha, beta=beta)
    k = jax.random.PRNGKey(9)
    after = step(k, state, tv, tf, lb, save=jnp.bool_(False))
    D_s, U = tv.shape[0] // 2, tv.shape[1]
    uniforms = {}
    for ci in range(2):
        for j in range(2):
            for di in range(2):
                key = jax.random.fold_in(jax.random.fold_in(k, ci * 1009 + j), di)
                uniforms[(ci * 2 + j, di, 0)] = np.asarray(
                    jax.random.uniform(key, (U, D_s), dtype=jnp.float32))
    init = {f: np.asarray(getattr(state, f)) for f in state._fields}
    want = {f: np.asarray(getattr(after, f)) for f in ("z", "n_dk", "n_vk", "n_k")}
    payload = dict(mesh=MESH, n_chains=C, V=V, K=8, alpha=alpha, beta=beta,
                   arrays=(tok_v, tok_f, labs), init=init, uniforms=uniforms, saves=[False])
    return payload, want


@pytest.fixture(scope="module")
def runs():
    parity, want = _jax_parity_case()
    cases = [
        ("arrays_job", dict(mesh=MESH, n_chains=2, V=32, K=8, arrays=_toy(),
                            saves=[False, False, True])),
        ("arrays_job", dict(mesh=MESH, n_chains=2, V=16, K=4, alpha=0.5, beta=0.1, seed=7,
                            arrays=_toy(D=24, U=8, V=16, K=4, seed=1),
                            saves=[i >= 10 for i in range(20)])),
        ("arrays_job", dict(mesh=MESH, n_chains=2, V=16, K=4,
                            arrays=_toy(D=16, U=8, V=16, K=4, seed=2), saves=[True])),
        ("arrays_job", parity),
    ]
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:multi_job", WORLD,
                {"jobs": cases}, device="cpu", timeout=240)
    return [[r[i] for r in res] for i in range(len(cases))], want


def test_invariants_after_sharded_sweeps(runs):
    res = runs[0][0]
    tok_v, tok_f, labs = _toy()
    total_f = int(tok_f.sum())
    n_dk = _assemble(res, "n_dk", 1)
    n_vk = _assemble(res, "n_vk", None)
    n_k = _assemble(res, "n_k", None)
    z = _assemble(res, "z", 1)
    for c in range(2):
        assert n_dk[c].sum() == total_f
        assert n_vk[c].sum() == total_f
        np.testing.assert_array_equal(n_vk[c].sum(axis=0), n_k[c])
        assert (n_dk[c] >= 0).all() and (n_vk[c] >= 0).all()
        picked = labs[np.arange(24)[:, None], z[c][:24]]
        assert (picked[tok_f > 0] > 0).all()  # z only on admissible topics
    assert not np.array_equal(z[0], z[1])  # chains decorrelated
    for r in res:  # every data shard holds the same replica
        np.testing.assert_array_equal(r["state"]["n_vk"], res[r["coords"][0] * 2]["state"]["n_vk"])
    assert all(r["state"]["s"] == 1 for r in res)


def test_one_data_shard_is_exactly_serial():
    """At one data shard AD-LDA is the exact serial sampler: a (1, 1) step
    equals the port's serial ``train_sweep`` with the same uniforms."""
    tok_v, tok_f, labs = _toy(D=24, U=8, V=16, K=4, seed=5)
    V = 16
    mesh = make_mesh(n_data=1, n_chains=1, device="cpu")
    corpus = shard_corpus(mesh, tok_v, tok_f, labs)
    gens = make_generators(mesh, 1, seed=11)
    state = init_sharded_state(mesh, corpus, V, 1, gens)
    step = make_sharded_train_step(mesh, 1, alpha=0.5, beta=0.1)
    serial = init_counts(torch.as_tensor(tok_v).long(), torch.as_tensor(tok_f).long(),
                         torch.as_tensor(labs), V, generator=make_generators(mesh, 1, 11)[0])
    rng = np.random.default_rng(0)
    for _ in range(5):
        u = torch.as_tensor(rng.random((8, 24), dtype=np.float32))
        state = step(state, corpus, False, uniforms=[u])
        serial = train_sweep(serial, corpus.tok_v, corpus.tok_f, corpus.labs, 0.5, 0.1,
                             uniforms=u)
    for name in ("z", "n_dk", "n_vk", "n_k"):
        assert torch.equal(getattr(state, name)[0], getattr(serial, name)), name


def test_sharded_matches_single_device_distribution(runs):
    """AD-LDA over 2 data shards keeps the stationary statistics close to
    the serial sampler's (the JAX test's bound)."""
    tok_v, tok_f, labs = _toy(D=24, U=8, V=16, K=4, seed=1)
    V = 16
    counts = j_init_counts(jax.random.PRNGKey(3), jnp.asarray(tok_v), jnp.asarray(tok_f),
                           jnp.asarray(labs), V)
    key, phs = jax.random.PRNGKey(3), []
    for i in range(20):
        key, k = jax.random.split(key)
        counts = j_train_sweep(k, counts, jnp.asarray(tok_v), jnp.asarray(tok_f),
                               jnp.asarray(labs), 0.5, 0.1)
        if i >= 10:
            phs.append(np.asarray((counts.n_vk + 0.1) / (counts.n_k + V * 0.1)))
    ph_serial = np.mean(phs, axis=0)
    ph_sharded = runs[0][1][0]["pooled_phi"]
    assert np.abs(ph_serial - ph_sharded).mean() < 0.08
    for r in runs[0][1]:  # every rank pools the same bits
        np.testing.assert_array_equal(r["pooled_phi"], ph_sharded)


def test_pooled_phi_shape_and_normalisation(runs):
    ph = runs[0][2][0]["pooled_phi"]
    assert ph.shape == (16, 4)
    np.testing.assert_allclose(ph.sum(axis=0), 1.0, rtol=1e-4)


def test_dense_step_matches_jax(runs):
    """One dense AD-LDA step on the (2, 2) mesh, four chains batched two per
    rank, from JAX's init state with JAX's uniforms: z and every count
    bitwise equal to JAX's step."""
    res, want = runs[0][3], runs[1]
    np.testing.assert_array_equal(_assemble(res, "z", 1), want["z"])
    np.testing.assert_array_equal(_assemble(res, "n_dk", 1), want["n_dk"])
    np.testing.assert_array_equal(_assemble(res, "n_vk", None), want["n_vk"])
    np.testing.assert_array_equal(_assemble(res, "n_k", None), want["n_k"])
