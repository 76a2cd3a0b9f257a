"""Port's fold-in sweep, likelihood and estimators against the JAX package's.

The same NumPy inputs, and for the fold-in the same uniforms, go through
both packages on the CPU.  z and n_dk must be equal (the port's cumsum may
round differently from the JAX ``w @ triu`` matmul by a few ULPs, which
flips a draw only on a measure-zero CDF tie); float results are compared
at the tolerance stated beside each.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lda_thesis_tpu.models import state as jstate
from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu_torch.models import state as tstate
from lda_thesis_tpu_torch.ops import gibbs as tgibbs

D, U, K, V = 16, 8, 128, 40
ALPHA, BETA = 0.1, 0.01


@pytest.fixture(scope="module")
def foldin_problem():
    rng = np.random.default_rng(4)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    n_types = rng.integers(2, U + 1, size=(D,))
    tok_f = (np.arange(U)[None, :] < n_types[:, None]).astype(np.int32)
    tok_f *= rng.integers(1, 4, size=(D, U)).astype(np.int32)
    n_vk = rng.integers(0, 30, size=(V, K)).astype(np.float32)
    n_vk[:, 100:] = 0  # padded topics: zero columns, as the model masks them
    mask = (np.arange(K) < 100).astype(np.float32)
    phi = ((n_vk + BETA) / (n_vk.sum(0) + V * BETA) * mask).astype(np.float32)
    z = rng.integers(0, 100, size=(D, U)).astype(np.int32)
    n_dk = np.zeros((D, K), np.float32)
    for d in range(D):
        np.add.at(n_dk[d], z[d], tok_f[d].astype(np.float32))
    return tok_v, tok_f, phi, z, n_dk, mask


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_foldin_sweep_matches_jax(foldin_problem, seed):
    tok_v, tok_f, phi, z, n_dk, _ = foldin_problem
    key = jax.random.PRNGKey(seed)
    z_j, ndk_j = jgibbs.foldin_sweep(key, jnp.asarray(z), jnp.asarray(n_dk),
                                     jnp.asarray(tok_v), jnp.asarray(tok_f),
                                     jnp.asarray(phi), ALPHA)
    u = np.array(jax.random.uniform(key, (U, D), dtype=jnp.float32))
    z_t, ndk_t = tgibbs.foldin_sweep(*_t(z, n_dk, tok_v, tok_f, phi), ALPHA,
                                     uniforms=torch.from_numpy(u))
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_array_equal(ndk_t.numpy(), np.asarray(ndk_j))


def test_foldin_sweep_keeps_counts(foldin_problem):
    tok_v, tok_f, phi, z, n_dk, _ = foldin_problem
    g = torch.Generator().manual_seed(0)
    z_t, ndk_t = tgibbs.foldin_sweep(*_t(z, n_dk, tok_v, tok_f, phi), ALPHA,
                                     generator=g)
    np.testing.assert_array_equal(ndk_t.sum(1).numpy(), tok_f.sum(1))
    assert (ndk_t >= 0).all()
    # padding positions keep their z
    assert torch.equal(z_t[torch.from_numpy(tok_f == 0)],
                       torch.from_numpy(z[tok_f == 0]))


def test_log_likelihood_matches_jax(foldin_problem):
    tok_v, tok_f, phi, _, n_dk, mask = foldin_problem
    theta = ((n_dk + ALPHA * mask) / (n_dk + ALPHA * mask).sum(1, keepdims=True)
             ).astype(np.float32)
    ll_j, n_j = jgibbs.log_likelihood(jnp.asarray(theta), jnp.asarray(phi),
                                      jnp.asarray(tok_v), jnp.asarray(tok_f))
    ll_t, n_t = tgibbs.log_likelihood(*_t(theta, phi, tok_v, tok_f))
    # float32 sums in another order: a relative 1e-5 bounds the difference
    np.testing.assert_allclose(float(ll_t), float(ll_j), rtol=1e-5)
    assert int(n_t) == int(n_j)


def test_theta_from_compact_matches_jax():
    rng = np.random.default_rng(6)
    A = 8
    lab_ids = np.sort(rng.choice(K, size=(D, A)), axis=1).astype(np.int32)
    lab_valid = (np.arange(A)[None, :] < rng.integers(1, A + 1, size=(D, 1))
                 ).astype(np.float32)
    lab_ids = np.where(lab_valid > 0, lab_ids, 0).astype(np.int32)
    n_dk = (rng.integers(0, 9, size=(D, A)) * lab_valid).astype(np.float32)
    want = jgibbs.theta_from_compact(jnp.asarray(n_dk), jnp.asarray(lab_ids),
                                     jnp.asarray(lab_valid), ALPHA, K)
    got = tgibbs.theta_from_compact(*_t(n_dk, lab_ids, lab_valid), ALPHA, K)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)


def test_phi_and_running_average_match_jax():
    rng = np.random.default_rng(8)
    n_vk = rng.integers(0, 50, size=(V, K)).astype(np.float32)
    mask = (np.arange(K) < 100).astype(np.float32)
    want = jstate.phi_from_counts(jnp.asarray(n_vk), jnp.asarray(n_vk.sum(0)),
                                  BETA, jnp.asarray(mask))
    got = tstate.phi_from_counts(*_t(n_vk, n_vk.sum(0)), BETA, torch.from_numpy(mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    avg_j = jnp.zeros((V, K), jnp.float32)
    avg_t = torch.zeros((V, K))
    for s in range(1, 5):
        cur = rng.random((V, K)).astype(np.float32)
        avg_j = jstate.running_average(avg_j, jnp.asarray(cur), jnp.int32(s))
        avg_t = tstate.running_average(avg_t, torch.from_numpy(cur), s)
        np.testing.assert_allclose(avg_t.numpy(), np.asarray(avg_j), rtol=1e-6)

    labs = (rng.random((D, K)) < 0.1).astype(np.float32)
    n_dk = (rng.integers(0, 9, size=(D, K)) * labs).astype(np.float32)
    want_th = jstate.theta_from_counts(jnp.asarray(n_dk), jnp.asarray(labs), ALPHA)
    got_th = tstate.theta_from_counts(*_t(n_dk, labs), ALPHA)
    np.testing.assert_allclose(got_th.numpy(), np.asarray(want_th), rtol=1e-6)
