"""Whole-run agreement of the port's exact Labeled-LDA samplers with the JAX package's.

The two draw from different random streams, so they cannot agree draw for
draw: on one small planted corpus each package trains three seeds at
(20; 10) with ``sweep="dense"`` or ``"compact"`` and folds in the held-out
split; both must hold the count invariants, and their mean held-out AUCs
must agree within three pooled standard errors or 0.03, whichever is larger.
"""

import numpy as np
import pytest

from lda_thesis_tpu.data.vocab import prune_dict as jax_prune_dict
from lda_thesis_tpu.models.labeled_lda import LabeledLDA as JaxLabeledLDA
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import prune_dict
from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA

SEEDS = (0, 1, 2)
ITERS, THINNING = 20, 10


@pytest.fixture(scope="module")
def corpus():
    return planted_corpus(11, n_train=200, n_test=40, V=300, n_labels=8,
                          max_labels=3, mean_types=15, max_types=40,
                          words_per_label=15)


def _auc(model, corpus) -> float:
    th = np.asarray(model.run_test(corpus.test_docs, ITERS, THINNING))[:, 1:]
    y = binary_yreal(corpus.test_labs, model.labelmap)[:, 1:]
    keep = th.sum(axis=1) != 0
    return evaluate_ranking(th[keep], y[keep])["auc_roc"]


def _invariants(n_vk, n_k, n_dks, total):
    n_vk = np.asarray(n_vk)
    assert float(n_vk.sum()) == total
    assert sum(float(np.asarray(x).sum()) for x in n_dks) == total
    assert n_vk.min() >= 0 and min(float(np.asarray(x).min()) for x in n_dks) >= 0
    np.testing.assert_array_equal(np.asarray(n_k), n_vk.sum(axis=0))


@pytest.mark.parametrize("sweep", ["dense", "compact"])
def test_heldout_auc_agrees_with_jax(corpus, sweep):
    args = (corpus.train_docs, corpus.train_labs, corpus.labelset)
    jax_dict = jax_prune_dict(corpus.train_docs, lower=0, upper=1)
    port_dict = prune_dict(corpus.train_docs, lower=0, upper=1)
    aucs = {"jax": [], "port": []}
    for seed in SEEDS:
        jm = JaxLabeledLDA(*args, jax_dict, 0.1, 0.01, seed=seed, sweep=sweep)
        jm.run_training(ITERS, THINNING, perplexity=False)
        _invariants(jm.counts.n_vk, jm.counts.n_k, jm.counts.n_dk, jm.n_tokens)
        aucs["jax"].append(_auc(jm, corpus))

        pm = LabeledLDA(*args, port_dict, 0.1, 0.01, seed=seed, sweep=sweep, device="cpu")
        pm.run_training(ITERS, THINNING, perplexity=False)
        assert pm._avg_s == ITERS // THINNING
        _invariants(pm.counts.n_vk.numpy(), pm.counts.n_k.numpy(),
                    [x.numpy() for x in pm.counts.n_dk], pm.n_tokens)
        aucs["port"].append(_auc(pm, corpus))

    j, p = np.array(aucs["jax"]), np.array(aucs["port"])
    se = np.sqrt(j.var(ddof=1) / len(j) + p.var(ddof=1) / len(p))
    assert abs(j.mean() - p.mean()) <= max(3 * se, 0.03), aucs
    assert p.mean() > 0.6, aucs  # the planted labels are recovered
