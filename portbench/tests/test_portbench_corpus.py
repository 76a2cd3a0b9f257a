"""The frozen corpus generators give the stated shapes on every seed."""

from collections import Counter

import pytest

import portbench_tiny  # noqa: F401  (the checkout on the path)
from portbench.corpus import for_run, jel_corpus, planted_corpus

SEEDS = [0, 2**31 + 7]


@pytest.mark.parametrize("seed", SEEDS)
def test_planted_corpus_shape(seed):
    c = planted_corpus(seed)
    assert (len(c.train_docs), len(c.test_docs)) == (4171, 464)
    assert len({w for d in c.train_docs for w in d}) == 8969
    assert len(c.labelset) == 391
    assert max(len(set(l)) for l in c.train_labs) + 1 == 24  # with the root
    types = [len(set(d)) for d in c.train_docs]
    assert max(types) == 128 and min(types) >= 1


@pytest.mark.parametrize("seed", SEEDS)
def test_jel_corpus_shape(seed):
    c = jel_corpus(seed, n_l3=371)
    assert (len(c.train_docs), len(c.test_docs)) == (4171, 464)
    assert len({w for d in c.train_docs for w in d}) == 8969
    assert len(c.labelset) + 1 == 512  # with the root
    assert Counter(len(l) for l in c.labelset) == {1: 20, 2: 120, 3: 371}


def test_same_seed_same_corpus():
    a, b = planted_corpus(5, n_train=50, n_test=5, V=300), planted_corpus(5, n_train=50,
                                                                          n_test=5, V=300)
    assert a == b


def test_every_run_has_the_same_documents_in_another_order():
    spec = {"generator": "planted_corpus", "seed": 3, "args": {"n_train": 60, "n_test": 8,
                                                               "V": 300}}
    a, b = for_run(spec, 1), for_run(spec, 2**31 + 9)
    assert a.train_docs != b.train_docs
    key = lambda docs, labs: sorted(zip(map(tuple, docs), map(tuple, labs)))
    assert key(a.train_docs, a.train_labs) == key(b.train_docs, b.train_labs)
    assert key(a.test_docs, a.test_labs) == key(b.test_docs, b.test_labs)
    assert for_run(spec, 1) == a
