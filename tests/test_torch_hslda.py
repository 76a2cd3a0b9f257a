"""The port's HSLDA ops, blocks and model against the JAX package, on the CPU.

Each op is held to its JAX counterpart with the same NumPy inputs and JAX's
own noise, rebuilt outside the JAX function from the keys it splits:

* ``hslda_init_counts`` and ``hslda_z_sweep`` (opt 1, opt 2 sparse, opt 2
  blockwise, opt 3, over two label blocks): every draw equal, the int32
  counts equal, the logits of every position within rtol 1e-5 (the JAX
  logits are read through ``gumbel_argmax``, the function both packages
  draw with), M within 1e-5.  No draw flips at these sizes and seeds, so
  the test requires every draw equal;
* the η, a, m and β blocks of one ``_train_cycle`` and the whole cycle,
  both packages started from one state through
  ``convert.hslda_state_from_numpy``: z and the counts equal, η within
  1e-5, m equal, β within 1e-6, a in probability (below);
* ``_test_loop`` (the fold-in): z̄ within 1e-6.

``truncated_normal`` is an inverse CDF, so its draws are compared where
they are conditioned: as probabilities Φ(x) of the standardised reflected
draw, within 1e-6.  The JAX function forms Φ as ½(1 + erf), which carries
an absolute float32 error of about 6e-8 that becomes large errors of x in
the tails; the port forms the left half-line by erfc and is held to a
float64 inverse CDF within 1e-4 in value.

The rest ports ``tests/test_hslda.py`` and the ``truncated_normal`` /
``stirling_table`` cases of ``tests/test_sampling.py`` onto the port.
"""

import numpy as np
import pytest
import torch
from scipy import special, stats

import jax
import jax.numpy as jnp

import lda_thesis_tpu.ops.hslda_gibbs as jg
from lda_thesis_tpu.data.encode import encode_instances as jax_encode_instances
from lda_thesis_tpu.models import hslda as jhslda
from lda_thesis_tpu.ops.sampling import truncated_normal as jax_truncated_normal
import lda_thesis_tpu_torch.ops.hslda_gibbs as tg
from lda_thesis_tpu_torch.convert import hslda_state_from_numpy
from lda_thesis_tpu_torch.data.encode import encode_instances
from lda_thesis_tpu_torch.data.synthetic import jel_corpus
from lda_thesis_tpu_torch.models import hslda as thslda
from lda_thesis_tpu_torch.models.hslda import HSLDA, CycleNoise
from lda_thesis_tpu_torch.ops.sampling import (
    gumbel,
    gumbel_argmax,
    stirling_table,
    truncated_normal,
)

# 60 documents, L = 93 prefix labels (two blocks of 64), N = 32, K = 8
JEL_SMALL = dict(n_train=60, n_test=8, V=150, n_l2=12, n_l3=60, mean_types=10,
                 max_types=25, words_per_code=5)
K = 8


def T(x):
    return torch.from_numpy(np.array(x))


def _toy():
    docs = [
        "cat dog pet animal fur cat".split(),
        "dog bark pet tail animal".split(),
        "stock bond market price trade".split(),
        "bond yield market finance price stock".split(),
        "cat purr whisker pet".split(),
        "equity trade finance market price".split(),
    ] * 3
    labs = [
        ["A", "A1"], ["A", "A1"], ["B", "B1"], ["B", "B1"], ["A", "A2"], ["B", "B2"],
    ] * 3
    labelset = ["A", "A1", "A2", "B", "B1", "B2"]
    return docs, labs, labelset


@pytest.fixture(scope="module")
def jel():
    return jel_corpus(3, **JEL_SMALL)


class _State:
    """One model state as the JAX functions take it, made by the port's
    constructor (no JAX model needs compiling): jnp arrays, with the
    numpy ``arrays`` that ``convert.hslda_state_from_numpy`` loads."""

    def __init__(self, m: HSLDA):
        c = m.counts
        self.arrays = {k: v.numpy() for k, v in dict(
            z=c.z, n_dk=c.n_dk, n_vk=c.n_vk, n_k=c.n_k, eta=m.eta, a=m.a,
            beta_vec=m.beta).items()}
        self.counts = jg.HSLDACounts(*(jnp.asarray(self.arrays[k])
                                       for k in ("z", "n_dk", "n_vk", "n_k")))
        for name in ("tok_v", "mask", "labs", "_lab_pos_ids", "_lab_pos_valid",
                     "_stirling_logs", "eta", "a", "beta"):
            setattr(self, name.lstrip("_"), jnp.asarray(getattr(m, name).numpy()))
        self.lab_pos_ids = self.lab_pos_ids.astype(jnp.int32)
        for name in ("alpha", "aprime", "gamma", "mu", "sigma", "xi", "V", "L", "D"):
            setattr(self, name, getattr(m, name))
        self.ph = m.get_ph()


@pytest.fixture(scope="module")
def jm(jel):
    return _State(HSLDA(jel.train_docs, jel.train_labs, jel.labelset, k=K, seed=1,
                        device="cpu"))


def _port_from(jm, jel) -> HSLDA:
    m = HSLDA(jel.train_docs, jel.train_labs, jel.labelset, k=K, seed=2, device="cpu")
    hslda_state_from_numpy(jm.arrays, m)
    return m


def _z_noise(key, N, D):
    return np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (D, K)))(
        jax.random.split(key, N)))


def _record_jax_logits(monkeypatch, key, N):
    """Read the JAX sweep's logits at each position through its
    ``gumbel_argmax``; returns a function giving them as (N, D, K)."""
    seen = []
    orig = jg.gumbel_argmax

    def rec(k, logits, axis=-1):
        jax.debug.callback(lambda kk, lg: seen.append((np.asarray(kk), np.asarray(lg))),
                           k, logits)
        return orig(k, logits, axis=axis)

    monkeypatch.setattr(jg, "gumbel_argmax", rec)
    keys = np.asarray(jax.random.split(key, N))

    def logits():
        jax.effects_barrier()
        pos = [int(np.flatnonzero((keys == k).all(axis=1))[0]) for k, _ in seen]
        assert sorted(pos) == list(range(N))
        return np.stack([lg for _, lg in seen])[np.argsort(pos)]
    return logits


def _record_port_logits(monkeypatch):
    seen = []
    orig = tg.gumbel_argmax

    def rec(logits, dim=-1, gumbels=None, generator=None):
        seen.append(logits.clone())
        return orig(logits, dim, gumbels=gumbels, generator=generator)

    monkeypatch.setattr(tg, "gumbel_argmax", rec)
    return lambda: torch.stack(seen).numpy()


# ------------------------------------------------------------ ops against JAX


def test_encode_instances_matches_jax():
    rng = np.random.default_rng(0)
    docs = [list(rng.integers(0, 50, size=n)) for n in (0, 3, 17, 9, 1)]
    for kw in ({}, {"pad_multiple": 4, "min_width": 12}):
        got, want = encode_instances(docs, **kw), jax_encode_instances(docs, **kw)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def _reflected_cdf(a, loc, flip):
    x = a.astype(np.float64) - loc
    return special.ndtr(np.where(flip, -x, x))


def test_truncated_normal_matches_jax():
    rng = np.random.default_rng(0)
    n = 50_000
    loc = (rng.normal(size=n) * 2.5).astype(np.float32)
    pos = rng.random(n) < 0.5
    lo = np.where(pos, 0.0, -np.inf).astype(np.float32)
    hi = np.where(pos, np.inf, 0.0).astype(np.float32)
    key = jax.random.PRNGKey(0)
    want = np.asarray(jax_truncated_normal(key, lo, hi, loc=jnp.asarray(loc)))
    u = np.asarray(jax.random.uniform(key, (n,), jnp.float32, 1e-7, 1.0))
    got = truncated_normal(T(lo), T(hi), loc=T(loc), uniforms=T(u)).numpy()
    assert got.dtype == np.float32
    assert (got[pos] >= 0).all() and (got[~pos] <= 0).all()
    flip = pos  # the right-half intervals are the reflected ones
    np.testing.assert_allclose(_reflected_cdf(got, loc, flip),
                               _reflected_cdf(want, loc, flip), rtol=0, atol=1e-6)
    # the port against the same inverse CDF in float64
    l64, h64 = lo.astype(np.float64) - loc, hi.astype(np.float64) - loc
    lf, hf = np.where(flip, -h64, l64), np.where(flip, -l64, h64)
    cl, ch = special.ndtr(lf), special.ndtr(hf)
    x = np.clip(special.ndtri(cl + u * (ch - cl)), lf, hf)
    np.testing.assert_allclose(got, loc + np.where(flip, -x, x), rtol=0, atol=1e-4)


def test_init_counts_match_jax(jm):
    D, N = jm.tok_v.shape
    rng = np.random.default_rng(1)
    theta = rng.dirichlet(np.ones(K), size=D).astype(np.float32)
    key = jax.random.PRNGKey(4)
    want = jg.hslda_init_counts(key, jm.tok_v, jm.mask, jnp.asarray(theta), jm.V)
    got = tg.hslda_init_counts(T(jm.tok_v), T(jm.mask), T(theta), jm.V,
                               gumbels=T(_z_noise(key, N, D)))
    for g, w in zip(got, want):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


SWEEPS = [(1, False), (2, True), (2, False), (3, False)]


@pytest.mark.parametrize("opt,sparse", SWEEPS,
                         ids=["opt1", "opt2-sparse", "opt2-blockwise", "opt3"])
def test_z_sweep_matches_jax(monkeypatch, jm, opt, sparse):
    D, N = jm.tok_v.shape
    assert jm.L > 64  # two label blocks, the second padded
    key = jax.random.PRNGKey(5 + opt)
    jax_logits = _record_jax_logits(monkeypatch, key, N)
    port_logits = _record_port_logits(monkeypatch)
    kw = dict(lab_pos_ids=jm.lab_pos_ids, lab_pos_valid=jm.lab_pos_valid) if sparse else {}
    want, M_want = jg.hslda_z_sweep(key, jm.counts, jm.tok_v, jm.mask, jm.labs, jm.eta, jm.a,
                                    alpha_beta=jm.alpha * jm.beta, gamma=jm.gamma, xi=jm.xi,
                                    opt=opt, **kw)
    tkw = {k: T(v) for k, v in kw.items()}
    got, M_got = tg.hslda_z_sweep(tg.HSLDACounts(*(T(x) for x in jm.counts)), T(jm.tok_v),
                                  T(jm.mask), T(jm.labs), T(jm.eta), T(jm.a),
                                  T(jm.alpha * jm.beta), jm.gamma, jm.xi, opt=opt,
                                  gumbels=T(_z_noise(key, N, D)), **tkw)
    np.testing.assert_allclose(port_logits(), jax_logits(), rtol=1e-5, atol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    np.testing.assert_allclose(M_got.numpy(), np.asarray(M_want), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_cycle(jm):
    """One JAX ``_train_cycle`` at opt 1 from the model's state, its noise
    rebuilt from the keys the function splits."""
    key = jax.random.PRNGKey(21)
    k_z, k_eta, k_a, k_m, k_beta = jax.random.split(key, 5)
    out = jhslda._train_cycle(key, jm.counts, jm.tok_v, jm.mask, jm.labs, jm.eta, jm.a,
                              jm.beta, jm.stirling_logs, jm.mu, jm.sigma, jm.aprime,
                              jm.alpha, gamma=jm.gamma, xi=jm.xi, opt=1,
                              lab_pos_ids=jm.lab_pos_ids, lab_pos_valid=jm.lab_pos_valid)
    D, N = jm.tok_v.shape
    L, S = jm.L, jm.stirling_logs.shape[0]
    n_blocks = -(-D // thslda.D_BLOCK)
    m_noise = np.concatenate([np.asarray(jax.random.gumbel(
        jax.random.fold_in(k_m, g), (thslda.D_BLOCK, K, S))) for g in range(n_blocks)])[:D]
    noise = dict(z=_z_noise(k_z, N, D), eta=np.asarray(jax.random.normal(k_eta, (K, L))),
                 a=np.asarray(jax.random.uniform(k_a, (D, L), jnp.float32, 1e-7, 1.0)),
                 m=m_noise)

    def beta_draws(conc):
        return T(jax.random.gamma(k_beta, jnp.asarray(conc.numpy())))

    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)], noise, beta_draws, k_m


def _jax_m(jm, n_dk, k_m):
    """JAX's Antoniak draw of ``_train_cycle`` (models/hslda.py:100-114)."""
    from lda_thesis_tpu.ops.sampling import gumbel_argmax as jax_gumbel_argmax

    S = jm.stirling_logs.shape[0]
    log_ab = jnp.log(jnp.maximum(jm.alpha * jm.beta, 1e-38))
    n_clip = jnp.minimum(jnp.asarray(n_dk), S - 1)
    D = n_clip.shape[0]
    Dp = -(-D // 512) * 512
    n_pad = jnp.pad(n_clip, ((0, Dp - D), (0, 0)))
    blocks = [jax_gumbel_argmax(jax.random.fold_in(k_m, g),
                                jm.stirling_logs[n_pad[g * 512:(g + 1) * 512]]
                                + jnp.arange(S, dtype=jnp.float32)[None, None, :]
                                * log_ab[None, :, None], axis=2)
              for g in range(Dp // 512)]
    return np.asarray(jnp.concatenate(blocks)[:D])


def test_blocks_match_jax(jm, jax_cycle):
    """η, a, m and β, each from the JAX cycle's own inputs and draws."""
    (z, n_dk, n_vk, n_k, eta, a, beta, zbar, mean_a), noise, beta_draws, k_m = jax_cycle
    eta_got = thslda.eta_block(T(zbar), T(jm.a), jm.mu, jm.sigma, normals=T(noise["eta"]))
    np.testing.assert_allclose(eta_got.numpy(), eta, rtol=1e-5, atol=1e-5)
    a_got, mean_got = thslda.a_block(T(zbar), T(eta), T(jm.labs), uniforms=T(noise["a"]))
    np.testing.assert_allclose(mean_got.numpy(), mean_a, rtol=1e-5, atol=1e-6)
    flip = np.asarray(jm.labs) > 0
    np.testing.assert_allclose(_reflected_cdf(a_got.numpy(), mean_a, flip),
                               _reflected_cdf(a, mean_a, flip), rtol=0, atol=1e-6)
    m_got = thslda.antoniak_draw(T(n_dk), jm.alpha, T(jm.beta), T(jm.stirling_logs),
                                 gumbels=T(noise["m"]))
    np.testing.assert_array_equal(m_got.numpy(), _jax_m(jm, n_dk, k_m))
    mdot = m_got.sum(dim=0).to(torch.float32) / m_got.shape[0]
    beta_got = thslda.beta_block(mdot, jm.aprime, beta_draws)
    np.testing.assert_allclose(beta_got.numpy(), beta, rtol=1e-6, atol=1e-7)


def test_train_cycle_matches_jax(jm, jel, jax_cycle):
    """One whole cycle of the port's model from the JAX model's state."""
    (z, n_dk, n_vk, n_k, eta, a, beta, _, mean_a), noise, beta_draws, _ = jax_cycle
    m = _port_from(jm, jel)
    m.train_cycle(1, noise=CycleNoise(z=T(noise["z"]), eta=T(noise["eta"]),
                                      a=T(noise["a"]), m=T(noise["m"]), beta=beta_draws))
    c = m.counts
    for got, want in zip(c, (z, n_dk, n_vk, n_k)):
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_allclose(m.eta.numpy(), eta, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(m.beta.numpy(), beta, rtol=1e-6, atol=1e-7)
    flip = np.asarray(jm.labs) > 0
    np.testing.assert_allclose(_reflected_cdf(m.a.numpy(), mean_a, flip),
                               _reflected_cdf(a, mean_a, flip), rtol=0, atol=1e-6)
    assert m._cycles_done == 1


def test_test_loop_matches_jax(jm, jel):
    init_phi = np.ascontiguousarray(jm.ph.T).astype(np.float32)
    sweep = np.asarray(jm.counts.n_vk).astype(np.float64) + jm.gamma
    sweep_phi = (sweep / sweep.sum(axis=0, keepdims=True)).astype(np.float32)
    m = _port_from(jm, jel)
    tok_v, mask = (x.numpy() for x in m._encode_test(jel.test_docs))
    key = jax.random.PRNGKey(3)
    it, thinning = 4, 2
    want = jhslda._test_loop(key, tok_v, mask, jnp.asarray(init_phi), jnp.asarray(sweep_phi),
                             jm.alpha * jm.beta, it=it, thinning=thinning)
    k_init, k_sweeps = jax.random.split(key)
    D, N = tok_v.shape
    u_init = jax.random.uniform(k_init, (N, D), dtype=jnp.float32)
    u_sweeps = [T(jax.random.uniform(k, (N, D), dtype=jnp.float32))
                for k in jax.random.split(k_sweeps, it)]
    got = thslda._test_loop(T(tok_v), T(mask), T(init_phi), T(sweep_phi),
                            T(jm.alpha * jm.beta), it, thinning, init_uniforms=T(u_init),
                            sweep_uniforms=u_sweeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


# ----------------------------------------- tests/test_hslda.py, on the port


def test_init_state_shapes_and_invariants():
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=5, seed=0, device="cpu")
    assert m.L == 7  # root '' + 6 labels
    assert m.labelmap[""] == 0
    total = int(m.mask.sum())
    c = m.counts
    assert all(x.dtype == torch.int32 for x in c)
    assert int(c.n_dk.sum()) == total
    assert int(c.n_vk.sum()) == total
    assert torch.equal(c.n_vk.sum(dim=0, dtype=torch.int32), c.n_k)
    # a respects label signs: positive labels -> a > 0, negative -> a < 0
    assert (m.a[m.labs > 0] > 0).all()
    assert (m.a[m.labs == 0] < 0).all()


@pytest.mark.parametrize("opt", [1, 2, 3])
def test_z_sweep_preserves_counts(opt):
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=5, seed=1, device="cpu")
    total = int(m.mask.sum())
    counts, M = tg.hslda_z_sweep(m.counts, m.tok_v, m.mask, m.labs, m.eta, m.a,
                                 m.alpha * m.beta, m.gamma, m.xi, opt=opt,
                                 generator=torch.Generator().manual_seed(0))
    assert int(counts.n_dk.sum()) == total
    assert int(counts.n_vk.sum()) == total
    assert (counts.n_dk >= 0).all()
    assert torch.equal(counts.n_vk.sum(dim=0, dtype=torch.int32), counts.n_k)
    # incremental M must equal the exact recomputation z̄ @ ηᵀ
    n_d = np.maximum(m.mask.sum(dim=1).numpy(), 1)
    zbar = counts.n_dk.numpy() / n_d[:, None]
    np.testing.assert_allclose(M.numpy(), zbar @ m.eta.numpy().T, atol=1e-3)


def test_opt2_sparse_coupling_matches_blockwise():
    """The compact positive-label Φ coupling computes the same logp2 sum as
    the label-blockwise evaluation: draws from the same noise agree except
    on float-order ties (none expected at toy scale)."""
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=5, seed=1, device="cpu")
    noise = gumbel((m.tok_v.shape[1], m.D, 5), "cpu", torch.Generator().manual_seed(0))
    args = (m.counts, m.tok_v, m.mask, m.labs, m.eta, m.a, m.alpha * m.beta, m.gamma, m.xi)
    c_block, M_block = tg.hslda_z_sweep(*args, opt=2, gumbels=noise)
    c_sparse, M_sparse = tg.hslda_z_sweep(*args, opt=2, lab_pos_ids=m._lab_pos_ids,
                                          lab_pos_valid=m._lab_pos_valid, gumbels=noise)
    agree = float((c_block.z == c_sparse.z).to(torch.float32).mean())
    assert agree > 0.98, agree
    assert int(c_sparse.n_vk.sum()) == int(m.mask.sum())
    np.testing.assert_allclose(M_sparse.numpy(), M_block.numpy(), atol=1e-3)


def test_opt1_log_decomposition_identity():
    """The sweep's matmul form of log p2 equals the reference's direct
    product form (HSLDA.py:254-257) up to a k-independent constant."""
    rng = np.random.default_rng(0)
    L, Kk, n_d = 6, 4, 17.0
    eta = torch.from_numpy(rng.normal(size=(L, Kk)))
    M = torch.from_numpy(rng.normal(size=L))  # means without the current token
    a = torch.from_numpy(rng.normal(size=L))
    labs = torch.from_numpy((rng.random(L) < 0.5).astype(float))
    labs[0] = 1.0
    ref = torch.stack([torch.sum(labs * (-0.5 * (M + eta[:, k] / n_d - a) ** 2))
                       for k in range(Kk)])
    C = (M - a) * labs
    mine = -(C @ eta / n_d + labs @ (eta ** 2) / (2 * n_d ** 2))
    diff = (ref - mine).numpy()
    np.testing.assert_allclose(diff, diff[0] * np.ones(Kk), atol=1e-10)


def test_training_cycle_and_thinning():
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=5, seed=0, device="cpu")
    m.run_training(it=4, thinning=2, opt=1)
    assert m.ph is not None and m.th is not None
    assert m.ph.shape == (5, m.V)
    assert m.th.shape == (m.D, 5)
    assert not np.isnan(m.ph).any() and not np.isnan(m.th).any()
    np.testing.assert_allclose(float(m.beta.sum()), 1.0, rtol=1e-5)
    assert torch.isfinite(m.eta).all()
    assert (m.a[m.labs > 0] > 0).all() and (m.a[m.labs == 0] < 0).all()
    assert m._avg_s == 2 and m._cycles_done == 4


def test_run_tests_scores():
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=5, seed=0, device="cpu")
    m.run_training(it=6, thinning=3, opt=1)
    scores = m.run_tests(
        ["cat dog pet animal".split(), "stock market finance price".split()], it=10, s=5)
    assert scores.shape == (2, m.L)
    assert (scores >= 0).all() and (scores <= 1).all()
    preds = m.label_predictions(scores[0])
    assert len(preds) == m.L
    np.testing.assert_array_equal(m.run_test("cat dog".split(), it=4, s=2).shape, (m.L,))


def test_display_topics():
    docs, labs, labelset = _toy()
    m = HSLDA(docs, labs, labelset, k=3, seed=0, device="cpu")
    m.run_training(it=2, thinning=2)
    tops = m.display_topics(n=4)
    assert len(tops) == 3 and all(len(t) == 4 for t in tops)
    assert m.get_zbar().shape == (m.D, 3)
    np.testing.assert_allclose(m.get_ph().sum(axis=1), 1.0)


def test_stirling_antoniak_support():
    """Antoniak draws satisfy 1 <= m <= n for n >= 1 (and m = 0 for n = 0)."""
    S = 20
    with np.errstate(divide="ignore"):
        logs = torch.from_numpy(np.log(stirling_table(S)))
    n = torch.tensor([[0, 1, 5, 12]])
    logits = logs[n] + torch.arange(S) * float(np.log(0.7))
    for seed in range(10):
        m = gumbel_argmax(logits, 2, generator=torch.Generator().manual_seed(seed))[0]
        assert m[0] == 0
        assert 1 <= m[1] <= 1
        assert 1 <= m[2] <= 5
        assert 1 <= m[3] <= 12
    # the m block's draw over the same table
    m = thslda.antoniak_draw(n.to(torch.int32), 1.0, torch.full((4,), 0.7), logs.float(),
                             generator=torch.Generator().manual_seed(0))[0]
    assert m[0] == 0 and m[1] == 1 and 1 <= m[2] <= 5 and 1 <= m[3] <= 12


# ----------------------- tests/test_sampling.py's HSLDA cases, on the port


@pytest.mark.parametrize(
    "lower,upper,loc",
    [
        (0.0, np.inf, 0.0),
        (-np.inf, 0.0, 0.0),
        (-1.0, 2.0, 0.5),
        (3.0, np.inf, 0.0),  # deep right tail
        (-np.inf, -4.0, 0.0),  # deep left tail
    ],
)
def test_truncated_normal_ks(lower, upper, loc):
    n = 8000
    x = truncated_normal(torch.full((n,), lower), torch.full((n,), upper),
                         loc=torch.tensor(loc, dtype=torch.float32), scale=1.0,
                         generator=torch.Generator().manual_seed(42)).numpy()
    assert np.all(x >= lower - 1e-5) and np.all(x <= upper + 1e-5)
    a, b = (lower - loc), (upper - loc)
    ks = stats.kstest(x, stats.truncnorm(a, b, loc=loc).cdf)
    assert ks.pvalue > 1e-4, ks


def test_truncated_normal_hslda_shapes():
    # positive labels a ∈ (0, ∞), negative labels a ∈ (−∞, 0), each
    # centred at mean_a (absolute bounds; HSLDA.py:135-137)
    mean = torch.tensor([[0.5, -2.0], [1.5, 0.0]])
    labs = torch.tensor([[1, 0], [0, 1]])
    lower = torch.where(labs == 1, 0.0, float("-inf"))
    upper = torch.where(labs == 1, float("inf"), 0.0)
    a = truncated_normal(lower, upper, loc=mean, generator=torch.Generator().manual_seed(0))
    assert (a[labs == 1] > 0).all()
    assert (a[labs == 0] < 0).all()


def test_stirling_table_matches_reference_construction():
    # reference get_stirling_numbers (HSLDA.py:25-36), small n oracle
    n = 30
    mat = np.identity(n)
    mat[1, 0] = 0
    mat[2, 1] = 1
    for m in range(3, n):
        for k in range(1, m):
            mat[m, k] = mat[m - 1, k - 1] + (m - 1) * mat[m - 1, k]
    ref = mat / mat.max(axis=1, keepdims=True)
    np.testing.assert_allclose(stirling_table(n), ref, rtol=1e-10, atol=1e-300)


def test_stirling_table_no_overflow():
    t = stirling_table(500)
    assert np.isfinite(t).all() and t.max() == 1.0
