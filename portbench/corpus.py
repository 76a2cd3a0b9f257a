"""Synthetic labelled corpora with planted per-label word distributions.

A frozen copy of the port's ``data/synthetic.py`` generators, kept here so
that a later change to the program cannot move the benchmark's inputs: the
same seed gives the same corpus whatever the program does.  Both default to
the shape of the depth-3 abstracts split: 4,171 training and 464 test
documents, a vocabulary of exactly 8,969 words over the training documents,
391 labels, 1–128 token types per document with a mean of about 45.

* :func:`planted_corpus` — flat labels (Labeled LDA's cells): about 250k
  tokens and a largest label set of 23 codes (24 slots with the root).
* :func:`jel_corpus` — JEL-shaped three-level codes (HSLDA's cells): 20
  letters, ``n_l2`` letter+digit codes and ``n_l3`` letter+two-digit codes,
  every document carrying its codes' ancestors, as the real label lists do.

Each label owns a small set of words; a document's types are drawn without
replacement from a mixture of a Zipfian background (the root topic) and its
labels' word distributions, so the labels carry signal that the fold-in
test can recover.
"""

from __future__ import annotations

from typing import List, NamedTuple

import numpy as np

__all__ = ["PlantedCorpus", "planted_corpus", "jel_corpus", "JEL_LETTERS", "for_run"]

# the 20 first-level letters of the JEL classification
JEL_LETTERS = "ABCDEFGHIJKLMNOPQRYZ"


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

    _cover_vocabulary(train, V, max_types, rng)
    as_tokens = lambda docs: [words[doc].tolist() for doc in docs]
    return PlantedCorpus(as_tokens(train), train_labs, as_tokens(test),
                         test_labs, labelset)


def _cover_vocabulary(train, V: int, max_types: int, rng) -> None:
    """Every word occurs in training: add each missing one to a short doc
    (one after the first two, which carry the widest label set and the most
    types)."""
    seen = np.zeros(V, bool)
    for doc in train:
        seen[doc] = True
    short = [d for d in range(2, len(train))
             if len(np.unique(train[d])) < max_types]
    for v in np.flatnonzero(~seen):
        d = short[rng.integers(len(short))]
        train[d] = np.append(train[d], v)
        if len(np.unique(train[d])) == max_types:
            short.remove(d)


def _split(total: int, parts: int, cap: int, rng) -> np.ndarray:
    """``total`` children over ``parts`` parents, each 1..``cap``."""
    counts = np.ones(parts, int)
    for _ in range(total - parts):
        open_ = np.flatnonzero(counts < cap)
        counts[open_[rng.integers(len(open_))]] += 1
    return counts


def jel_corpus(
    seed: int,
    n_train: int = 4171,
    n_test: int = 464,
    V: int = 8969,
    n_l2: int = 120,
    n_l3: int = 251,
    mean_types: float = 45.0,
    max_types: int = 128,
    words_per_code: int = 25,
    leaf_rate: float = 1.0,
    level_weights=(0.2, 0.2, 0.2),
) -> PlantedCorpus:
    """A JEL-shaped corpus: documents as token lists plus label lists that
    hold each document's leaf codes (letter+two digits) and their ancestors.

    The tree has the 20 JEL letters, ``n_l2`` letter+digit codes (1–10 per
    letter) and ``n_l3`` leaf codes (1–10 per parent).  A document has
    ``1 + Poisson(leaf_rate)`` leaves, drawn by a Zipfian popularity; every
    leaf labels some training document.  Its word distribution mixes a
    Zipfian background with each level's codes' own words, weighted by
    ``level_weights`` (letters, letter+digit, leaves), so every level carries
    signal.  ``labelset`` lists all 20 + ``n_l2`` + ``n_l3`` codes.
    """
    if sum(level_weights) > 1.0:
        raise ValueError(f"level_weights {level_weights} sum past 1")
    rng = np.random.default_rng(seed)
    letters = list(JEL_LETTERS)
    l2, l2_parent = [], []
    for i, n in enumerate(_split(n_l2, len(letters), 10, rng)):
        for digit in np.sort(rng.choice(10, n, replace=False)):
            l2.append(f"{letters[i]}{digit}")
            l2_parent.append(i)
    l3, l3_parent = [], []
    for j, n in enumerate(_split(n_l3, len(l2), 10, rng)):
        for digit in np.sort(rng.choice(10, n, replace=False)):
            l3.append(f"{l2[j]}{digit}")
            l3_parent.append(j)
    levels = [letters, l2, l3]
    labelset = letters + l2 + l3
    words = np.array([f"w{v}" for v in range(V)])

    background = 1.0 / (np.arange(V) + 10.0)
    background = background[rng.permutation(V)]
    background /= background.sum()
    own = [np.stack([rng.choice(V, words_per_code, replace=False) for _ in lvl])
           for lvl in levels]
    own_w = [rng.dirichlet(np.ones(words_per_code), size=len(lvl)) for lvl in levels]
    popularity = 1.0 / (np.arange(n_l3) + 2.0) ** 0.8
    popularity = popularity[rng.permutation(n_l3)]
    popularity /= popularity.sum()
    cover = rng.permutation(n_l3)  # the first n_l3 training docs carry one each
    sigma = 0.6
    mu = np.log(mean_types) - sigma ** 2 / 2

    def draw(n_docs: int, first: bool):
        docs, labs = [], []
        for d in range(n_docs):
            n_leaf = min(1 + rng.poisson(leaf_rate), 10)
            n_t = int(np.clip(np.rint(rng.lognormal(mu, sigma)), 1, max_types))
            if first and d == 1:
                n_t = max_types
            leaves = rng.choice(n_l3, n_leaf, replace=False, p=popularity)
            if first and d < n_l3 and cover[d] not in leaves:
                leaves[0] = cover[d]
            mid = np.unique([l3_parent[x] for x in leaves])
            top = np.unique([l2_parent[x] for x in mid])
            codes = [top, mid, np.unique(leaves)]
            p = (1.0 - sum(level_weights)) * background
            for lvl, ids, weight in zip(range(3), codes, level_weights):
                for c in ids:
                    np.add.at(p, own[lvl][c], weight / len(ids) * own_w[lvl][c])
            keys = np.log(p) + rng.gumbel(size=V)
            types = np.argpartition(-keys, n_t - 1)[:n_t]
            freq = 1 + rng.poisson(0.33, size=n_t)
            docs.append(np.repeat(types, freq))
            labs.append([levels[lvl][c] for lvl, ids in enumerate(codes) for c in ids])
        return docs, labs

    train, train_labs = draw(n_train, True)
    test, test_labs = draw(n_test, False)
    _cover_vocabulary(train, V, max_types, rng)
    as_tokens = lambda docs: [words[doc].tolist() for doc in docs]
    return PlantedCorpus(as_tokens(train), train_labs, as_tokens(test),
                         test_labs, labelset)


def for_run(spec: dict, seed: int) -> PlantedCorpus:
    """The corpus of a configuration (``{"generator", "seed", "args"}``) for
    the run of ``seed``: the same documents in every run, generated from the
    configuration's own seed, in an order drawn from the run's seed (the
    training and the held-out documents each shuffled with their labels).
    So every run has the same sizes to work on, in another order."""
    c = globals()[spec["generator"]](spec["seed"], **spec.get("args", {}))
    rng = np.random.default_rng(seed)
    tr, te = rng.permutation(len(c.train_docs)), rng.permutation(len(c.test_docs))
    return PlantedCorpus([c.train_docs[i] for i in tr], [c.train_labs[i] for i in tr],
                         [c.test_docs[i] for i in te], [c.test_labs[i] for i in te],
                         c.labelset)
