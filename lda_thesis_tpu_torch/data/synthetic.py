"""Synthetic labelled corpus with planted per-label word distributions.

Stands in for the abstracts corpus where the CSV is absent.  The defaults
give the shape of the depth-3 abstracts split that ``bench.py`` trains on:
4,171 training and 464 test documents, a vocabulary of exactly 8,969 words
over the training documents, 391 labels (392 topics with the root), 1–128
token types per document with a mean of about 45, about 250k tokens, and a
largest label set of 23 codes (24 slots with the root).

Each label owns a small set of words; a document's types are drawn without
replacement from a mixture of a Zipfian background (the root topic) and its
labels' word distributions, so the labels carry signal that the fold-in
test can recover.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

__all__ = ["PlantedCorpus", "planted_corpus"]


class PlantedCorpus(NamedTuple):
    train_docs: List[List[str]]
    train_labs: List[List[str]]
    test_docs: List[List[str]]
    test_labs: List[List[str]]
    labelset: List[str]


def planted_corpus(
    seed: int,
    n_train: int = 4171,
    n_test: int = 464,
    V: int = 8969,
    n_labels: int = 391,
    max_labels: int = 23,
    mean_types: float = 45.0,
    max_types: int = 128,
    words_per_label: int = 40,
    label_weight: float = 0.5,
) -> PlantedCorpus:
    """Documents as token lists plus per-document label lists.

    Every one of the ``V`` words occurs in some training document, the first
    training document carries ``max_labels`` labels and the second
    ``max_types`` token types, so the vocabulary, the slot width and the
    longest document are exactly as asked.
    """
    rng = np.random.default_rng(seed)
    labelset = [f"L{l:03d}" for l in range(n_labels)]
    words = np.array([f"w{v}" for v in range(V)])

    background = 1.0 / (np.arange(V) + 10.0)
    background = background[rng.permutation(V)]
    background /= background.sum()
    own = np.stack([rng.choice(V, words_per_label, replace=False)
                    for _ in range(n_labels)])
    own_w = rng.dirichlet(np.ones(words_per_label), size=n_labels)
    popularity = 1.0 / (np.arange(n_labels) + 2.0) ** 0.8
    popularity = popularity[rng.permutation(n_labels)]
    popularity /= popularity.sum()
    sigma = 0.6
    mu = np.log(mean_types) - sigma ** 2 / 2

    def draw(n_docs: int, first: bool):
        docs, labs = [], []
        for d in range(n_docs):
            n_l = min(1 + rng.poisson(1.5), max_labels)
            n_t = int(np.clip(np.rint(rng.lognormal(mu, sigma)), 1, max_types))
            if first and d == 0:
                n_l = max_labels
            if first and d == 1:
                n_t = max_types
            lab = rng.choice(n_labels, n_l, replace=False, p=popularity)
            p = (1.0 - label_weight) * background
            for l in lab:
                np.add.at(p, own[l], label_weight / n_l * own_w[l])
            keys = np.log(p) + rng.gumbel(size=V)
            types = np.argpartition(-keys, n_t - 1)[:n_t]
            freq = 1 + rng.poisson(0.33, size=n_t)
            docs.append(np.repeat(types, freq))
            labs.append([labelset[l] for l in lab])
        return docs, labs

    train, train_labs = draw(n_train, True)
    test, test_labs = draw(n_test, False)

    # every word occurs in training: add each missing one to a short doc
    seen = np.zeros(V, bool)
    for doc in train:
        seen[doc] = True
    short = [d for d in range(2, n_train)
             if len(np.unique(train[d])) < max_types]
    for v in np.flatnonzero(~seen):
        d = short[rng.integers(len(short))]
        train[d] = np.append(train[d], v)
        if len(np.unique(train[d])) == max_types:
            short.remove(d)

    as_tokens = lambda docs: [words[doc].tolist() for doc in docs]
    return PlantedCorpus(as_tokens(train), train_labs, as_tokens(test),
                         test_labs, labelset)
