"""Whole-run agreement of the port's HSLDA with the JAX package's.

The two draw from different random streams (threefry keys against a
``torch.Generator``), so whole runs cannot agree draw for draw: on one
small JEL-shaped corpus each package builds the model for two seeds,
trains 10 cycles at thinning 5 and scores the held-out split with a
10-sweep fold-in, as the CLI does.  Their mean AUCs (root column dropped)
must agree within 0.05, and the port's counts keep their invariants
exactly.  The vocabulary, label map and encoded arrays of the port's
constructor equal the JAX model's.
"""

import numpy as np
import pytest
import torch

from lda_thesis_tpu.models.hslda import HSLDA as JaxHSLDA
from lda_thesis_tpu_torch.data.synthetic import jel_corpus
from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking
from lda_thesis_tpu_torch.models.hslda import HSLDA

SEEDS = (0, 1)
K, IT, S = 10, 10, 5


@pytest.fixture(scope="module")
def corpus():
    return jel_corpus(5, n_train=150, n_test=60, V=300, n_l2=10, n_l3=16, max_types=24,
                      mean_types=12, level_weights=(0.3, 0.3, 0.3))


@pytest.fixture(scope="module")
def jax_models(corpus):
    return [JaxHSLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, k=K, seed=seed)
            for seed in SEEDS]


def _auc(model, corpus) -> float:
    scores = model.run_tests(corpus.test_docs, it=IT, s=S)
    y = binary_yreal(corpus.test_labs, model.labelmap)[:, 1:]
    sc = scores[:, 1:]
    keep = y.sum(axis=1) != 0
    return evaluate_ranking(sc[keep], y[keep])["auc_roc"]


def test_vocab_labels_and_encoding_match_jax(corpus, jax_models):
    jm = jax_models[0]
    m = HSLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, k=K, seed=0,
              device="cpu")
    assert m.w_to_v == jm.w_to_v and m.v_to_w == jm.v_to_w
    assert m.labelmap == jm.labelmap and m.lablist == jm.lablist
    assert m.child_to_parent == jm.child_to_parent
    assert (m.D, m.V, m.L, m.K) == (jm.D, jm.V, jm.L, jm.K)
    for got, want in ((m.tok_v, jm.tok_v), (m.mask, jm.mask), (m.labs, jm.labs),
                      (m._lab_pos_ids, jm._lab_pos_ids),
                      (m._lab_pos_valid, jm._lab_pos_valid),
                      (m._stirling_logs, jm._stirling_logs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for got, want in zip(m._encode_test(corpus.test_docs), jm._encode_test(corpus.test_docs)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_auc_agrees_with_jax(corpus, jax_models):
    aucs = {"jax": [], "port": []}
    for seed, jm in zip(SEEDS, jax_models):
        jm.run_training(IT, S, opt=1)
        aucs["jax"].append(_auc(jm, corpus))

        pm = HSLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, k=K, seed=seed,
                   device="cpu")
        pm.run_training(IT, S, opt=1)
        c, total = pm.counts, int(pm.mask.sum())
        assert int(c.n_dk.sum()) == int(c.n_vk.sum()) == int(c.n_k.sum()) == total
        assert int(c.n_dk.min()) >= 0 and int(c.n_vk.min()) >= 0
        assert torch.equal(c.n_vk.sum(dim=0, dtype=torch.int32), c.n_k)
        assert pm._avg_s == IT // S and pm._cycles_done == IT
        aucs["port"].append(_auc(pm, corpus))
    j, p = np.mean(aucs["jax"]), np.mean(aucs["port"])
    assert abs(j - p) <= 0.05, aucs
    assert p > 0.6, aucs  # the planted codes are recovered
