"""The port's CAVI/SVI engine against the JAX package's, same NumPy inputs.

``vi_init`` without a key (JAX) or generator (port) is deterministic, so
both packages start from the same state.  The port sums each chunk of type
positions before adding it to the running γ, λ and ELBO totals, where JAX
adds one position at a time: the float32 sums are taken in another order,
so γ, λ and the ELBO are held to rtol 1e-5, not bit for bit.  The rest is
``tests/test_vi.py`` on the port: a monotone ELBO, normalised and masked
estimators, held-out inference and SVI.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lda_thesis_tpu.data.vocab import Dictionary as JaxDictionary
from lda_thesis_tpu.models.labeled_lda_vi import LabeledLDAVI as JaxLabeledLDAVI
from lda_thesis_tpu.ops import vi as jvi
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.models.labeled_lda_vi import LabeledLDAVI
from lda_thesis_tpu_torch.ops import vi as tvi

DOCS = [
    "cat dog pet animal fur".split(),
    "dog bark pet tail animal".split(),
    "stock bond market price trade".split(),
    "bond yield market finance price".split(),
    "cat purr whisker pet fur".split(),
    "equity trade finance market price".split(),
] * 4
LABS = [["A"], ["A"], ["B"], ["B"], ["A"], ["B"]] * 4
SMALL = dict(n_train=60, n_test=10, V=120, n_labels=6, max_labels=3,
             mean_types=12, max_types=30, words_per_label=10)
ALPHA, BETA = 0.5, 0.1


def _problem(seed=0, D=40, U=16, K=12, V=50):
    """Token ids, frequencies (trailing padding) and label masks from NumPy."""
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    length = rng.integers(1, U + 1, size=D)
    tok_f = rng.integers(1, 5, size=(D, U)).astype(np.int32)
    tok_f[np.arange(U)[None, :] >= length[:, None]] = 0
    tok_v[tok_f == 0] = 0
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    labs[:, K - 2:] = 0.0  # padded topics
    return tok_v, tok_f, labs, V


@pytest.mark.parametrize("chunk", [None, 3], ids=["one-chunk", "chunks-of-3"])
def test_cavi_step_matches_jax(chunk, monkeypatch):
    tok_v, tok_f, labs, V = _problem()
    if chunk:  # several chunks of positions, as at full width
        D, K = labs.shape
        monkeypatch.setattr(tvi, "SLICE_ELEMENTS", chunk * D * K)
        assert tvi._chunk(D, K) == chunk
    js = jvi.vi_init(jnp.asarray(labs), V, ALPHA, BETA, key=None)
    ts = tvi.vi_init(torch.from_numpy(labs), V, ALPHA, BETA)
    np.testing.assert_array_equal(ts.gamma.numpy(), np.asarray(js.gamma))
    np.testing.assert_array_equal(ts.lam.numpy(), np.asarray(js.lam))
    args_j = (jnp.asarray(tok_v), jnp.asarray(tok_f), jnp.asarray(labs))
    args_t = tuple(torch.from_numpy(x) for x in (tok_v, tok_f, labs))
    for _ in range(3):
        js, je = jvi.cavi_step(js, *args_j, ALPHA, BETA)
        ts, te = tvi.cavi_step(ts, *args_t, ALPHA, BETA)
        np.testing.assert_allclose(ts.gamma.numpy(), np.asarray(js.gamma), rtol=1e-5)
        np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=1e-5)
        np.testing.assert_allclose(float(te), float(je), rtol=1e-5)
        # the label mask is kept exactly: γ is α·0 + 0 off the labels
        assert (ts.gamma.numpy()[labs == 0] == 0).all()
    np.testing.assert_allclose(float(tvi.elbo(ts, *args_t, ALPHA, BETA)),
                               float(jvi.elbo(js, *args_j, ALPHA, BETA)), rtol=1e-5)


def _models(seed=0):
    jm = JaxLabeledLDAVI(DOCS, LABS, ["A", "B"], JaxDictionary(DOCS), ALPHA, BETA,
                         seed=seed)
    tm = LabeledLDAVI(DOCS, LABS, ["A", "B"], Dictionary(DOCS), ALPHA, BETA,
                      seed=seed, device="cpu")
    # the same deterministic start on both sides
    jm.state = jvi.vi_init(jm.labs, jm.V, ALPHA, BETA, key=None)
    tm.state = tvi.vi_init(tm.labs, tm.V, ALPHA, BETA)
    return jm, tm


def test_model_fit_and_infer_match_jax():
    jm, tm = _models()
    assert (tm.V, tm.K, tm.Kp, tm.D) == (jm.V, jm.K, jm.Kp, jm.D)
    np.testing.assert_array_equal(tm.labs.numpy(), np.asarray(jm.labs))
    jm.fit(iters=10)
    tm.fit(iters=10)
    assert len(tm.elbo_history) == len(jm.elbo_history)
    np.testing.assert_allclose(tm.elbo_history, jm.elbo_history, rtol=1e-5)
    np.testing.assert_allclose(tm.get_phi(), jm.get_phi(), rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.get_theta(), jm.get_theta(), rtol=1e-5, atol=1e-7)
    new = ["cat dog pet".split(), "stock market price".split(), "fur price".split()]
    np.testing.assert_allclose(tm.infer(new, iters=20), jm.infer(new, iters=20),
                               rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(tm.perplexity(), jm.perplexity(), rtol=1e-5)


@pytest.fixture(scope="module")
def model():
    m = LabeledLDAVI(DOCS, LABS, ["A", "B"], Dictionary(DOCS), alpha=0.5, beta=0.1,
                     seed=0, device="cpu")
    m.fit(iters=30)
    return m


def test_elbo_monotone(model):
    """CAVI guarantees a non-decreasing ELBO (tests/test_vi.py's slack)."""
    e = np.asarray(model.elbo_history)
    assert len(e) >= 3
    assert np.all(np.diff(e) >= -1e-3 * np.abs(e[:-1]))


def test_estimators_normalised_and_masked(model):
    ph = model.get_phi()
    th = model.get_theta()
    assert ph.shape == (3, model.V)  # root + A + B
    np.testing.assert_allclose(ph.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-4)
    a_col, b_col = model.labelmap["A"], model.labelmap["B"]
    assert np.all(th[0::6, b_col] == 0)  # A-labelled docs
    assert np.all(th[2::6, a_col] == 0)  # B-labelled docs
    w2v = model.dicti.token2id
    assert ph[a_col, w2v["cat"]] > ph[a_col, w2v["market"]]
    assert ph[b_col, w2v["market"]] > ph[b_col, w2v["cat"]]
    assert len(model.topwords_per_topic(3)) == model.K


def test_infer_heldout(model):
    th = model.infer(["cat dog pet".split(), "stock market price".split()], iters=20)
    assert th.shape == (2, 3)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-4)
    assert th[0, model.labelmap["A"]] > th[0, model.labelmap["B"]]
    assert th[1, model.labelmap["B"]] > th[1, model.labelmap["A"]]


def test_svi_reaches_similar_solution():
    dicti = Dictionary(DOCS)
    m = LabeledLDAVI(DOCS, LABS, ["A", "B"], dicti, alpha=0.5, beta=0.1, seed=1,
                     device="cpu")
    m.fit_svi(epochs=30, batch_size=8)
    ph = m.get_phi()
    w2v = dicti.token2id
    assert ph[m.labelmap["A"], w2v["cat"]] > ph[m.labelmap["A"], w2v["market"]]
    assert m.perplexity() < float(m.V)  # far better than the uniform-word model
    assert len(m.elbo_history) == 1 and np.isfinite(m.elbo_history[0])


def test_svi_epoch_schedule_matches_jax():
    """With one batch of every document, the permutation only reorders the
    batch, so one SVI epoch equals JAX's: the local pass and the global step
    ρ_0 = τ₀^−κ."""
    tok_v, tok_f, labs, V = _problem(seed=3, D=24)
    D = labs.shape[0]
    js = jvi.vi_init(jnp.asarray(labs), V, ALPHA, BETA, key=None)
    ts = tvi.vi_init(torch.from_numpy(labs), V, ALPHA, BETA)
    import jax

    js = jvi.svi_epoch(jax.random.PRNGKey(0), js, jnp.asarray(tok_v), jnp.asarray(tok_f),
                       jnp.asarray(labs), ALPHA, BETA, jnp.int32(2), D,
                       local_iters=2, tau=1.5, kappa=0.7)
    ts = tvi.svi_epoch(ts, *(torch.from_numpy(x) for x in (tok_v, tok_f, labs)), ALPHA,
                       BETA, 2, D, local_iters=2, tau=1.5, kappa=0.7,
                       generator=torch.Generator().manual_seed(0))
    np.testing.assert_allclose(ts.gamma.numpy(), np.asarray(js.gamma), rtol=1e-5)
    np.testing.assert_allclose(ts.lam.numpy(), np.asarray(js.lam), rtol=1e-5)


def test_planted_corpus_vi_auc():
    """On a small planted corpus the port's VI fit and fold-in rank the
    held-out labels well above chance, as the JAX engine's do."""
    from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking

    c = planted_corpus(4, **SMALL)
    dicti = Dictionary(c.train_docs)
    m = LabeledLDAVI(c.train_docs, c.train_labs, c.labelset, dicti, 0.1, 0.01,
                     seed=0, device="cpu")
    m.fit(iters=15)
    e = np.asarray(m.elbo_history)
    assert np.all(np.diff(e) >= -1e-3 * np.abs(e[:-1]))
    th = m.infer(c.test_docs, iters=15)
    y = binary_yreal(c.test_labs, m.labelmap)[:, 1:]
    assert evaluate_ranking(th[:, 1:], y)["auc_roc"] > 0.6
