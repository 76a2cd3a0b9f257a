"""The test-time position loops' graphed classes against the eager functions.

``FoldinSweep``, ``CascadeSweep`` and ``LogLikelihood`` (``ops/gibbs.py``)
replay one CUDA graph per sweep or sum on a card; on the CPU they run their
body eagerly.  Here, on the CPU, each is held bit for bit to the eager
function it replaces (``foldin_sweep``, ``cascade_sweep``,
``log_likelihood``), and each loop that now runs through one (the
Labeled-LDA and HSLDA fold-ins, CascadeLDA's test loop, the models'
perplexity) to its eager loop from the same generator state (the eager
loops are ``chip_smoke``'s, which phase 15 holds the replays to on the
card).  ``fold_in_test`` is also held to the JAX package's ``_test_loop``
fed JAX's uniforms, at the tolerance of ``tests/test_torch_hslda.py``'s
fold-in (z̄ within rtol 1e-6).  The fold-in kernel's chunk-width rule
(``ops/foldin_cuda.scan_log_width``) is held to torch's.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from lda_thesis_tpu.models import labeled_lda as jlabeled
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.models import hslda as thslda
from lda_thesis_tpu_torch.models import labeled_lda as tlabeled
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
from lda_thesis_tpu_torch.models.labeled_lda_vi import LabeledLDAVI
from lda_thesis_tpu_torch.models.local_lda import LocalLDA
from lda_thesis_tpu_torch.ops import foldin_cuda
from lda_thesis_tpu_torch.ops import gibbs as tgibbs

D, U, K, V = 24, 10, 16, 40
ALPHA, BETA = 0.1, 0.01
SMALL = dict(n_train=40, n_test=8, V=200, max_types=20, mean_types=8)


def _same(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and torch.equal(a, b)


def _problem(seed):
    """Held-out documents, a frozen φ with padded (zero) topics, and a
    state (z, n_dk) of those documents."""
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U))
    n_types = rng.integers(2, U + 1, size=(D,))
    tok_f = (np.arange(U)[None, :] < n_types[:, None]) * rng.integers(1, 4, size=(D, U))
    n_vk = rng.integers(0, 30, size=(V, K)).astype(np.float32)
    n_vk[:, 12:] = 0
    phi = ((n_vk + BETA) / (n_vk.sum(0) + V * BETA) * (np.arange(K) < 12)).astype(np.float32)
    z = rng.integers(0, 12, size=(D, U)).astype(np.int32)
    n_dk = np.zeros((D, K), np.float32)
    for d in range(D):
        np.add.at(n_dk[d], z[d], tok_f[d].astype(np.float32))
    mask = (np.arange(K) < 12).astype(np.float32)
    return [torch.from_numpy(np.ascontiguousarray(x))
            for x in (z, n_dk, tok_v, tok_f, phi, mask)]


def _alpha(form, rng):
    if form == "scalar":
        return ALPHA
    shape = (K,) if form == "per_topic" else (D, K)  # HSLDA's α·β: one chain, or per row
    return torch.from_numpy((rng.random(shape) * 0.2 + 0.01).astype(np.float32))


@pytest.mark.parametrize("draws", ["generator", "uniforms"])
@pytest.mark.parametrize("form", ["scalar", "per_topic", "per_row"])
def test_foldin_sweep_class_equals_function(form, draws):
    """4 calls of ``FoldinSweep`` == 4 calls of ``foldin_sweep`` from one
    state, bit for bit after each; the class updates its state in place."""
    z, n_dk, tok_v, tok_f, phi, _ = _problem(1)
    alpha = _alpha(form, np.random.default_rng(2))
    zs, ns = z.clone(), n_dk.clone()
    run = tgibbs.FoldinSweep(zs, ns, tok_v, tok_f, phi, alpha)
    g = [torch.Generator().manual_seed(5) for _ in range(2)]
    for i in range(4):
        u = torch.rand((U, D), generator=g[0]) if draws == "uniforms" else None
        run(g[1], uniforms=u)
        z, n_dk = tgibbs.foldin_sweep(z, n_dk, tok_v, tok_f, phi, alpha, uniforms=u,
                                      generator=g[0] if u is None else None)
        assert run.z is zs and run.n_dk is ns
        assert _same(zs, z) and _same(ns, n_dk)
    assert run._graph is None and run.calls == 4  # the CPU never captures


@pytest.mark.parametrize("rows, size, lx", [
    (464, 512, 4),  # llda_d3.predict: chunks of 32
    (464, 15, 4),  # hslda_jel.predict
    (100, 512, 5),  # chunks of 64
    (50, 1024, 6),
    (64, 1100, 7),
    (9000, 15, 9),  # ceil-log2 difference -10: the unsigned wrap
    (8192, 16, 4),  # difference -9: no wrap
    (1000, 2, 4),  # clamped from below
    (2, 100_000, 9),  # clamped from above
    (1, 1, 4),
])
def test_scan_log_width_mirrors_torch_rule(rows, size, lx):
    """``foldin_cuda.scan_log_width`` is torch's chunk-width rule for a
    cumsum over the innermost dim (``get_log_num_threads_x_inner_scan`` in
    ``ATen/native/cuda/ScanUtils.cuh``, unsigned arithmetic), whose order
    the fold-in kernel repeats."""
    assert foldin_cuda.scan_log_width(rows, size) == lx


def _jax_foldin_uniforms(key, it):
    """The uniforms the JAX ``_test_loop`` draws: the init's, then one
    (U, D) per sweep."""
    k_init, k_sweeps = jax.random.split(key)
    us = [jax.random.uniform(k_init, (U, D), dtype=jnp.float32)]
    us += [jax.random.uniform(k, (U, D), dtype=jnp.float32)
           for k in jax.random.split(k_sweeps, it + 1)[:it]]
    return [torch.from_numpy(np.array(u)) for u in us]


@pytest.mark.parametrize("seed", [0, 1])
def test_fold_in_test_matches_jax(monkeypatch, seed):
    """``fold_in_test`` (its sweeps through ``FoldinSweep``) against the JAX
    ``_test_loop``, every ``torch.rand`` of the loop fed JAX's uniforms."""
    _, _, tok_v, tok_f, phi, mask = _problem(seed)
    phi[3] = 0.0  # a word with no topic mass: the init's uniform fallback
    it, thinning = 7, 3
    key = jax.random.PRNGKey(seed)
    want, _ = jlabeled._test_loop(key, jnp.asarray(tok_v.numpy().astype(np.int32)),
                                  jnp.asarray(tok_f.numpy().astype(np.int32)),
                                  jnp.asarray(phi.numpy()), jnp.asarray(mask.numpy()), it,
                                  thinning, ALPHA)
    stream = iter(_jax_foldin_uniforms(key, it))

    def jax_rand(shape, generator=None, device=None, dtype=None, out=None):
        u = next(stream)
        assert tuple(u.shape) == tuple(shape)
        return u if out is None else out.copy_(u)

    monkeypatch.setattr(torch, "rand", jax_rand)
    got = tlabeled.fold_in_test(phi, tok_v, tok_f, mask, ALPHA, it, thinning,
                                torch.Generator())
    assert next(stream, None) is None  # one draw for the init and one per sweep
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6, atol=1e-7)


def test_fold_in_test_equals_eager_loop():
    _, _, tok_v, tok_f, phi, mask = _problem(3)
    g = torch.Generator().manual_seed(8)
    state = g.get_state()
    got = tlabeled.fold_in_test(phi, tok_v, tok_f, mask, ALPHA, 6, 2, g)
    after = g.get_state()
    g.set_state(state)
    want = chip_smoke.eager_fold_in(phi, tok_v, tok_f, mask, ALPHA, 6, 2, g)
    assert _same(got, want) and torch.equal(g.get_state(), after)


@pytest.mark.parametrize("C", [1, 3])
def test_hslda_fold_in_equals_eager_loop(monkeypatch, C):
    """``_test_loop`` (C = 1, α·β per topic) and ``chains_test_loop``
    (C = 3 chains as rows of one fold-in, α·β per row) against the same
    loops with eager ``foldin_sweep`` calls, from one generator state."""
    rng = np.random.default_rng(C)
    _, _, tok_v, tok_f, _, _ = _problem(C)
    mask = (tok_f > 0).to(torch.int32)
    init_phi, sweep_phi = (torch.from_numpy(np.ascontiguousarray(
        rng.dirichlet(np.ones(V), size=(C, K)).transpose(0, 2, 1), dtype=np.float32))
        for _ in range(2))
    ab = torch.from_numpy((rng.random((C, K)) * 0.3).astype(np.float32))
    g = torch.Generator().manual_seed(11)
    state = g.get_state()

    def run():
        if C == 1:
            return thslda._test_loop(tok_v, mask, init_phi[0], sweep_phi[0], ab[0], 5, 2,
                                     generator=g)
        return thslda.chains_test_loop(tok_v, mask, init_phi, sweep_phi, ab, 5, 2,
                                       generator=g)

    got = run()
    g.set_state(state)
    monkeypatch.setattr(thslda, "_test_loop", chip_smoke.eager_test_loop)
    assert _same(got, run())


def _task_problem(seed):
    """CascadeLDA tasks over a global φ: a word with an all-zero φ row (the
    (φ+β) fallback) and a padded task with no labels and no tokens."""
    rng = np.random.default_rng(seed)
    R, Ut, Vv, Kg, Kt = 20, 6, 30, 20, 8
    tok_v = rng.integers(0, Vv, size=(R, Ut))
    tok_v[:, 1] = 0
    tok_f = rng.integers(1, 4, size=(R, Ut))
    tok_f[rng.random((R, Ut)) < 0.2] = 0
    phi = rng.dirichlet(np.ones(Vv), size=Kg).T.astype(np.float32)
    phi[0] = 0.0
    lab_ids = np.zeros((R, Kt), np.int64)
    lab_mask = np.zeros((R, Kt), np.float32)
    for r in range(R - 1):
        n = rng.integers(2, Kt + 1)
        lab_ids[r, :n] = rng.choice(Kg, n, replace=False)
        lab_mask[r, :n] = 1.0
    tok_f[R - 1] = 0
    return [torch.from_numpy(x) for x in (tok_v, tok_f, phi, lab_ids, lab_mask)]


@pytest.mark.parametrize("draws", ["generator", "gumbels"])
def test_cascade_sweep_class_equals_function(draws):
    """3 calls of ``CascadeSweep`` (noise filled per position into its
    static buffer) == 3 calls of ``cascade_sweep`` (noise drawn at each
    position's draw), bit for bit after each."""
    tok_v, tok_f, phi, ids, lab_mask = _task_problem(0)
    if draws == "generator":
        run, _ = chip_smoke.cascade_sweeps_case(tok_v, tok_f, phi, ids, lab_mask, ALPHA, BETA,
                                                seed=4, sweeps=3)
        assert run._graph is None and run.calls == 3
        return
    g = torch.Generator().manual_seed(1)
    noise = torch.randn((3, tok_v.shape[1], *ids.shape), generator=g)
    z = torch.randint(0, 2, (tok_v.shape[1], tok_v.shape[0]), generator=g)
    n_dk = torch.zeros(ids.shape)
    n_dk.scatter_add_(1, z.T, tok_f.to(torch.float32))
    run = tgibbs.CascadeSweep(z.clone(), n_dk.clone(), tok_v, tok_f, phi, ids, lab_mask,
                              ALPHA, BETA)
    for i in range(3):
        run(gumbels=noise[i])
        tgibbs.cascade_sweep(z, n_dk, tok_v, tok_f, phi, ids, lab_mask, ALPHA, BETA,
                             gumbels=noise[i])
        assert _same(run.z, z) and _same(run.n_dk, n_dk)


@pytest.mark.parametrize("draws", ["generator", "gumbels"])
def test_cascade_test_loop_equals_eager_loop(draws):
    tok_v, tok_f, phi, ids, lab_mask = _task_problem(1)
    it, thinning = 5, 2
    kw = dict(alpha=ALPHA, beta=BETA)
    if draws == "gumbels":
        g = torch.Generator().manual_seed(2)
        kw.update(init_gumbels=torch.randn((tok_v.shape[1], *ids.shape), generator=g),
                  sweep_gumbels=torch.randn((it, tok_v.shape[1], *ids.shape), generator=g))
    g = torch.Generator().manual_seed(3)
    got = tgibbs.cascade_test_loop(tok_v, tok_f, phi, ids, lab_mask, it, thinning,
                                   generator=g, **kw)
    g = torch.Generator().manual_seed(3)
    want = chip_smoke.eager_cascade_loop(tok_v, tok_f, phi, ids, lab_mask, it, thinning,
                                         generator=g, **kw)
    assert _same(got, want)


def test_log_likelihood_class_equals_function():
    """``LogLikelihood`` called with three (θ, φ) pairs equals
    ``log_likelihood`` on each, bit for bit; it refuses a new shape and
    pickles without its state."""
    z, n_dk, tok_v, tok_f, phi, mask = _problem(6)
    run = tgibbs.LogLikelihood(tok_v, tok_f)
    for i in range(3):
        num = n_dk + (ALPHA + 0.1 * i) * mask
        theta = num / num.sum(dim=1, keepdim=True)
        ph = phi * (1.0 + 0.05 * i)
        got, want = run(theta, ph), tgibbs.log_likelihood(theta, ph, tok_v, tok_f)
        assert _same(got[0], want[0]) and int(got[1]) == int(want[1])
    assert run._graph is None and run.calls == 3
    with pytest.raises(ValueError, match="theta must keep the shape"):
        run(theta[:5], ph)
    clone = pickle.loads(pickle.dumps(run))
    assert clone._inputs is None and clone.calls == 0
    assert _same(clone(theta, ph)[0], want[0])


def _perplexity_by_function(model, phi, thetas):
    ll = n = 0
    for th, tv, tf in zip(thetas, model.toks_v, model.toks_f):
        llg, ng = tgibbs.log_likelihood(th, phi, tv, tf)
        ll, n = ll + float(llg), n + int(ng)
    return float(np.exp(-ll / max(n, 1)))


@pytest.mark.parametrize("model_kind", ["labeled", "local", "vi"])
def test_models_perplexity_equals_log_likelihood(model_kind):
    """Each model's perplexity, through its kept ``LogLikelihood``s, equals
    the eager ``log_likelihood``'s at every call; the model pickles with
    them and its copy gives the same perplexity."""
    c = planted_corpus(2, **SMALL)
    dicti = Dictionary(c.train_docs)
    if model_kind == "labeled":
        m = LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA, BETA, seed=0,
                       device="cpu")
        m.run_training(4, 2)  # perplexity at each of the two saves, in the save's body
        assert len(m.cur_perplx) == 2 and m._save._key_calls == {True: 2} and m._ll is None
        want = _perplexity_by_function(m, *m._cur_estimates())
    elif model_kind == "local":
        texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) + "." for d in c.train_docs]
        m = LocalLDA(texts, alpha=0.1, beta=0.01, K=5, seed=0, device="cpu")
        m.run_training(4, 2)
        want = _perplexity_by_function(m, m._phi(), [m._theta(g)
                                                     for g in range(m.buckets.n_buckets)])
    else:
        m = LabeledLDAVI(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA, BETA, seed=0,
                         device="cpu")
        m.fit(iters=3)
        theta = torch.from_numpy(m.get_theta())
        phi = torch.from_numpy(np.ascontiguousarray(m.get_phi().T))
        ll, n = tgibbs.log_likelihood(theta, phi, m.tok_v, m.tok_f)
        want = float(np.exp(-float(ll) / max(int(n), 1)))
    assert m.perplexity() == m.perplexity() == want
    if model_kind != "vi":
        assert all(run.calls == 2 for run in m._ll)
    assert pickle.loads(pickle.dumps(m)).perplexity() == want
