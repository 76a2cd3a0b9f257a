"""Exact-sampler Labeled-LDA state carried from the JAX package into the port.

A JAX ``LabeledLDA`` trained with ``sweep="dense"`` or ``"compact"`` is saved
with ``utils/checkpoint.save_model`` and loaded into the port's model of the
same sampler through ``convert.labeled_lda_state_from_numpy``; both must then
give the same z, φ, θ, φ̂, θ̂ and perplexity.  float32 estimators reduce in
another order in the two frameworks, so they are compared at rtol 1e-6.
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


def _port(corpus, **kw):
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    return LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                      dicti, 0.1, 0.01, device="cpu", **kw)


@pytest.fixture(scope="module", params=["dense", "compact"])
def jax_exact(request, corpus, tmp_path_factory):
    """A JAX model trained with an exact sampler, and its saved arrays."""
    dicti = jax_prune_dict(corpus.train_docs, lower=0, upper=1)
    model = JaxLabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                          dicti, 0.1, 0.01, seed=4, sweep=request.param)
    model.run_training(5, 2, perplexity=False)
    path = str(tmp_path_factory.mktemp("ckpt") / request.param)
    save_model(path, model)
    arrays, meta = load_checkpoint(path)
    return model, arrays, meta


def test_exact_state_carried_from_jax(corpus, jax_exact):
    jm, arrays, meta = jax_exact
    pm = _port(corpus, sweep=jm.sweep)
    labeled_lda_state_from_numpy(arrays, pm, meta)
    np.testing.assert_allclose(pm.get_phi(), jm.get_phi(), rtol=1e-6)
    np.testing.assert_allclose(pm.get_theta(), jm.get_theta(), rtol=1e-6)
    np.testing.assert_allclose(pm.perplexity(), jm.perplexity(), rtol=1e-6)
    np.testing.assert_allclose(pm.ph_hat.numpy(), np.asarray(jm.ph_hat), rtol=1e-6)
    np.testing.assert_allclose(pm.th_hat, jm.th_hat, rtol=1e-6)
    for g in range(pm.buckets.n_buckets):
        np.testing.assert_array_equal(pm.counts.z[g].numpy(), np.asarray(jm.counts.z[g]))
    # and trains on in the port, keeping the count invariants
    pm.run_training(4, 2, perplexity=False)
    total = float(pm.n_tokens)
    assert float(pm.counts.n_vk.sum()) == total
    assert sum(float(x.sum()) for x in pm.counts.n_dk) == total
    assert torch.equal(pm.counts.n_k, pm.counts.n_vk.sum(0))


def test_convert_rejects_other_sweep(corpus, jax_exact):
    _, arrays, meta = jax_exact
    with pytest.raises(ValueError, match="sweep mismatch"):
        labeled_lda_state_from_numpy(arrays, _port(corpus), meta)
