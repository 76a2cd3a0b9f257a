"""Corpus loading and JEL label parsing (host side).

Copy of ``lda_thesis_tpu/data/corpus.py``; the documents, label lists,
labelset and the seeded split must equal the JAX package's.  The reference
has three near-copies of ``load_corpus`` differing only in label handling:

* **truncate** mode (LabeledLDA.py:7-46): each JEL code is cut to depth ``d``
  (``x[:d]``), so labels live at a single tree level.
* **prefix** mode (CascadeLDA.py:8-53, HSLDA.py:39-79): each code expands to
  *all* prefixes up to depth ``d`` (``partition_label``), so labels live at
  every level of the tree.

Rows are ``(id, text, space-separated JEL codes)``; codes are filtered by the
regex ``[A-Z]\\d{2}``.  Rows whose label field is 3 characters or shorter are
treated as a single raw code (reference LabeledLDA.py:36-39).
"""

from __future__ import annotations

import csv
import re
import sys
from dataclasses import dataclass
from typing import List, Optional, Tuple

import numpy as np

from .textproc import preprocess_documents

__all__ = ["RawCorpus", "partition_label", "load_corpus", "split_data"]

_JEL_PAT = re.compile(r"[A-Z]\d{2}")


def _raise_csv_field_limit() -> None:
    max_int = sys.maxsize
    while True:
        try:
            csv.field_size_limit(max_int)
            return
        except OverflowError:
            max_int = int(max_int / 10)


def partition_label(lab: str, d: int) -> List[str]:
    """All prefixes of ``lab`` up to depth ``d`` (reference CascadeLDA.py:52-53)."""
    return [lab[: i + 1] for i in range(d)]


@dataclass
class RawCorpus:
    """Tokenised documents with per-document label lists and global labelset."""

    docs: List[List[str]]
    labs: List[List[str]]
    labelset: List[str]

    def __len__(self) -> int:
        return len(self.docs)


def load_corpus(
    filename: str,
    d: int = 3,
    mode: str = "truncate",
    preprocess: bool = True,
) -> RawCorpus:
    """Load a ``(id, text, labels)`` CSV into a tokenised, labelled corpus.

    ``mode='truncate'`` reproduces LabeledLDA's depth truncation,
    ``mode='prefix'`` reproduces CascadeLDA/HSLDA's prefix expansion.
    The labelset preserves first-appearance order (the reference builds it
    from dict-key order, which is insertion order).
    """
    if mode not in ("truncate", "prefix"):
        raise ValueError(f"unknown label mode: {mode!r}")
    _raise_csv_field_limit()

    docs: List[str] = []
    labs: List[List[str]] = []
    labelmap: dict = {}
    with open(filename, "r", newline="") as f:
        for row in csv.reader(f):
            doc = row[1]
            lab_field = row[2]
            if len(lab_field) > 3:
                codes = [x for x in lab_field.split(" ") if _JEL_PAT.search(x)]
                if mode == "truncate":
                    lab = [x[:d] for x in codes]
                else:
                    lab = [p for x in codes for p in partition_label(x, d)]
                # order-preserving dedup: list(set(...)) would make label
                # order (and thus the labelmap and every downstream RNG
                # draw) depend on the per-process PYTHONHASHSEED
                lab = list(dict.fromkeys(lab))
            else:
                if mode == "truncate":
                    lab = [lab_field[:d]]
                else:
                    lab = partition_label(lab_field, d)
            for x in lab:
                labelmap[x] = 1
            docs.append(doc)
            labs.append(lab)

    tokenized = preprocess_documents(docs) if preprocess else [d.split() for d in docs]
    return RawCorpus(docs=tokenized, labs=labs, labelset=list(labelmap.keys()))


def split_data(
    corpus: RawCorpus,
    train_frac: float = 0.9,
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> Tuple[RawCorpus, RawCorpus]:
    """90/10 train/test split.

    ``shuffle=True`` mirrors L-LDA/CascadeLDA (reference LabeledLDA.py:268-278);
    ``shuffle=False`` mirrors HSLDA's sequential split (HSLDA.py:397-403).
    Unlike the reference, the permutation is seedable for reproducibility;
    a seed draws the same permutation as the JAX package's ``split_data``.
    """
    n = len(corpus)
    idx = np.arange(n)
    if shuffle:
        rng = np.random.default_rng(seed) if seed is not None else np.random
        rng.shuffle(idx)
    split = int(n * train_frac)
    tr, te = idx[:split], idx[split:]
    train = RawCorpus(
        docs=[corpus.docs[i] for i in tr],
        labs=[corpus.labs[i] for i in tr],
        labelset=corpus.labelset,
    )
    test = RawCorpus(
        docs=[corpus.docs[i] for i in te],
        labs=[corpus.labs[i] for i in te],
        labelset=corpus.labelset,
    )
    return train, test
