"""Whole-run agreement of the port's CascadeLDA with the JAX package's.

The two draw from different random streams in their fold-in, so they cannot
agree draw for draw end to end: on one small JEL-shaped corpus each package
trains the tree with ``go_down_tree(4, 2)`` (root level (16; 4)) for three
seeds, predicts the held-out split with ``test_down_tree_batch(4, 2)`` and
reassembles it with ``setup_theta``.  Their mean macro AUCs must agree at
every depth within three pooled standard errors or 0.03, whichever is larger.
The JAX fold-in loop runs under ``jax.jit``, with the same arguments, to keep
the file fast.
"""

import jax
import numpy as np
import pytest

import lda_thesis_tpu.models.cascade_lda as jax_cascade
from lda_thesis_tpu.data.vocab import prune_dict as jax_prune_dict
from lda_thesis_tpu.eval.cascade import setup_theta as jax_setup_theta
from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu_torch.data.synthetic import jel_corpus
from lda_thesis_tpu_torch.data.vocab import prune_dict
from lda_thesis_tpu_torch.eval.cascade import setup_theta
from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking
from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA

SEEDS = (0, 1, 2)
IT, S = 4, 2


@pytest.fixture(scope="module")
def corpus():
    return jel_corpus(5, n_train=120, n_test=60, V=300, n_l2=10, n_l3=16, max_types=24,
                      mean_types=12, level_weights=(0.3, 0.3, 0.3))


def _aucs_by_depth(model, corpus, reassemble):
    l1, l2, l3 = model.test_down_tree_batch(corpus.test_docs, IT, S)
    th_all = reassemble(l1, l2, l3, model.labelmap)
    y_all = binary_yreal(corpus.test_labs, model.labelmap)
    out = []
    for depth in (1, 2, 3):
        cols = np.array([len(x) == depth for x in model.labelmap])
        y, th = y_all[:, cols], th_all[:, cols]
        keep = (th.sum(axis=1) != 0) & (y.sum(axis=1) != 0)
        out.append(evaluate_ranking(th[keep], y[keep])["auc_roc"])
    return out


def test_cascade_auc_by_depth_agrees_with_jax(corpus, monkeypatch):
    monkeypatch.setattr(jax_cascade, "cascade_test_loop", jax.jit(
        jgibbs.cascade_test_loop, static_argnames=("it", "thinning", "alpha", "beta")))
    args = (corpus.train_docs, corpus.train_labs, corpus.labelset)
    jax_dict = jax_prune_dict(corpus.train_docs, lower=0, upper=1)
    port_dict = prune_dict(corpus.train_docs, lower=0, upper=1)
    aucs = {"jax": [], "port": []}
    for seed in SEEDS:
        jm = jax_cascade.CascadeLDA(*args, jax_dict, seed=seed)
        jm.go_down_tree(IT, S)
        aucs["jax"].append(_aucs_by_depth(jm, corpus, jax_setup_theta))

        pm = CascadeLDA(*args, port_dict, seed=seed, device="cpu")
        pm.go_down_tree(IT, S)
        assert [st["sweeps"] for st in pm.level_stats] == [4 * IT, IT, IT]
        aucs["port"].append(_aucs_by_depth(pm, corpus, setup_theta))

    j, p = np.array(aucs["jax"]), np.array(aucs["port"])  # (seed, depth)
    se = np.sqrt(j.var(axis=0, ddof=1) / len(j) + p.var(axis=0, ddof=1) / len(p))
    gate = np.maximum(3 * se, 0.03)
    assert (np.abs(j.mean(axis=0) - p.mean(axis=0)) <= gate).all(), aucs
    assert (p.mean(axis=0) > 0.6).all(), aucs  # the planted codes are recovered
