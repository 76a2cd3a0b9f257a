"""The port's LabeledLDA against the JAX package's, and its own contracts.

State trained by the JAX ``LabeledLDA`` is carried into the port through
``convert.labeled_lda_state_from_numpy`` (from the arrays that
``utils/checkpoint.save_model`` writes); both must then give the same
buckets, φ, θ and perplexity.  float32 estimators reduce in another order
in the two frameworks, so they are compared at rtol 1e-6.
"""

import numpy as np
import pytest
import torch

from lda_thesis_tpu.data.vocab import prune_dict as jax_prune_dict
from lda_thesis_tpu.models.labeled_lda import LabeledLDA as JaxLabeledLDA
from lda_thesis_tpu.utils.checkpoint import load_checkpoint, save_model
from lda_thesis_tpu_torch.convert import labeled_lda_state_from_numpy
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import prune_dict
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA

SMALL = dict(n_train=60, n_test=10, V=120, n_labels=6, max_labels=3,
             mean_types=12, max_types=30, words_per_label=10)


@pytest.fixture(scope="module")
def corpus():
    return planted_corpus(3, **SMALL)


@pytest.fixture(scope="module")
def jax_arrays(corpus, tmp_path_factory):
    dicti = jax_prune_dict(corpus.train_docs, lower=0, upper=1)
    model = JaxLabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                          dicti, 0.1, 0.01, seed=3)
    model.run_training(4, 2, perplexity=False)
    path = str(tmp_path_factory.mktemp("ckpt") / "m")
    save_model(path, model)
    arrays, _ = load_checkpoint(path)
    return model, arrays


def _port(corpus, **kw):
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    kw.setdefault("device", "cpu")
    return LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                      dicti, 0.1, 0.01, **kw)


def test_state_carried_from_jax(corpus, jax_arrays):
    jm, arrays = jax_arrays
    pm = _port(corpus)
    assert pm.buckets.n_buckets == jm.buckets.n_buckets > 1
    for a, b in zip(pm.buckets.doc_idx, jm.buckets.doc_idx):
        np.testing.assert_array_equal(a, b)
    assert (pm.V, pm.K, pm.Kp, pm.A) == (jm.V, jm.K, jm.Kp, jm.A)

    labeled_lda_state_from_numpy(arrays, pm)
    np.testing.assert_allclose(pm.get_phi(), jm.get_phi(), rtol=1e-6)
    np.testing.assert_allclose(pm.get_theta(), jm.get_theta(), rtol=1e-6)
    np.testing.assert_allclose(pm.perplexity(), jm.perplexity(), rtol=1e-6)
    np.testing.assert_allclose(pm.ph_hat.numpy(), np.asarray(jm.ph_hat), rtol=1e-6)
    np.testing.assert_allclose(pm.th_hat, jm.th_hat, rtol=1e-6)
    # the carried state keeps the count invariants
    total = float(pm.n_tokens)
    assert float(pm.counts.n_vk.sum()) == total
    assert sum(float(x.sum()) for x in pm.counts.n_dk) == total
    # and trains on in the port
    pm.run_training(4, 2, perplexity=False)
    assert float(pm.counts.n_vk.sum()) == total


def test_convert_rejects_mismatch(corpus, jax_arrays):
    _, arrays = jax_arrays
    with pytest.raises(ValueError, match="bucket count"):
        labeled_lda_state_from_numpy(arrays, _port(corpus, n_buckets=1))
    bad = dict(arrays)
    bad["n_vk"] = bad["n_vk"][:-1]
    with pytest.raises(ValueError, match="n_vk"):
        labeled_lda_state_from_numpy(bad, _port(corpus))


def test_training_cadence_and_invariants(corpus):
    m = _port(corpus, seed=1)
    m.run_training(7, 3)  # M = 1 at this budget; saves after sweeps 3 and 6
    assert m._merge_M == 1
    assert m._avg_s == 2
    assert len(m.cur_perplx) == 2 and all(np.isfinite(m.cur_perplx))
    st = m.counts
    assert float(st.n_vk.sum()) == m.n_tokens
    assert sum(float(x.sum()) for x in st.n_dk) == m.n_tokens
    assert float(st.n_vk.min()) >= 0
    assert torch.equal(st.n_k, st.n_vk.sum(0))
    m.run_training(6, 3, continue_avg=True)
    assert m._avg_s == 4
    th = m.run_test(corpus.test_docs, 5, 2)
    assert th.shape == (len(corpus.test_docs), m.K)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-5)
    assert m.get_theta().shape == (m.D, m.K)
    assert len(m.topwords_per_topic(3)) == m.K
    assert len(m.get_preds(th, 2)) == len(corpus.test_docs)


def test_merge_block_guard(corpus):
    m = _port(corpus)
    m._ckpt_merge_M = 5
    with pytest.raises(ValueError, match="merge-block mismatch"):
        m.run_training(4, 2)
    m.run_training(50, 25, total_iters=100)  # selects M = 5
    assert m._merge_M == 5


@pytest.mark.parametrize("sweep", ["dense", "compact"])
def test_exact_sweeps_not_ported(corpus, sweep):
    """The exact samplers, once refused here, now run: thinned saves at
    exact multiples, trailing sweeps unsaved, count invariants, and z back
    in the (D_g, U_g) layout of the JAX package."""
    m = _port(corpus, seed=2, sweep=sweep)
    assert m.sweep == sweep and m.buckets.n_buckets == 4
    m.run_training(7, 3)
    assert m._avg_s == 2 and len(m.cur_perplx) == 2
    assert not hasattr(m, "_merge_M")
    st = m.counts
    for z, tv in zip(st.z, m.toks_v):
        assert z.shape == tv.shape and z.dtype == torch.int32
    assert float(st.n_vk.sum()) == m.n_tokens
    assert sum(float(x.sum()) for x in st.n_dk) == m.n_tokens
    assert float(st.n_vk.min()) >= 0
    assert torch.equal(st.n_k, st.n_vk.sum(0))
    th = m.run_test(corpus.test_docs, 4, 2)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-5)


def test_default_device_is_cuda(corpus):
    if torch.cuda.is_available():
        assert _port(corpus, device=None).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            _port(corpus, device=None)
