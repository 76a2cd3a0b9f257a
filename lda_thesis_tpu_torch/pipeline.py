"""End-to-end convenience wrappers (the reference's module-level helpers:
``split_data`` / ``prune_dict`` / ``train_it`` / ``test_it``,
LabeledLDA.py:268-302, CascadeLDA.py:437-462).

Counterpart of ``lda_thesis_tpu/pipeline.py``, with a ``device`` argument
passed through to :class:`LabeledLDA` (CUDA unless the caller passes
``"cpu"``)."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from .data.corpus import RawCorpus, load_corpus, split_data as _split
from .data.vocab import prune_dict
from .models.labeled_lda import LabeledLDA

__all__ = ["split_corpus", "train_labeled_lda", "test_labeled_lda", "prune_dict"]


def split_corpus(
    filename: str,
    d: int = 2,
    mode: str = "truncate",
    shuffle: bool = True,
    seed: Optional[int] = None,
) -> Tuple[RawCorpus, RawCorpus]:
    """load + 90/10 split (reference ``split_data``, LabeledLDA.py:268-278)."""
    corpus = load_corpus(filename, d=d, mode=mode)
    return _split(corpus, shuffle=shuffle, seed=seed)


def train_labeled_lda(
    train: RawCorpus,
    it: int = 30,
    s: int = 3,
    al: float = 0.001,
    be: float = 0.001,
    l: float = 0.05,
    u: float = 0.95,
    seed: int = 0,
    perplexity: bool = True,
    device=None,
) -> LabeledLDA:
    """prune + construct + train (reference ``train_it``, LabeledLDA.py:288-293)."""
    dicti = prune_dict(train.docs, lower=l, upper=u)
    model = LabeledLDA(train.docs, train.labs, list(train.labelset), dicti,
                       al, be, seed=seed, device=device)
    model.run_training(it, s, perplexity=perplexity)
    return model


def test_labeled_lda(
    model: LabeledLDA,
    test: RawCorpus,
    it: int = 500,
    thinning: int = 25,
    n: int = 5,
):
    """fold-in inference + top-n predictions (reference ``test_it``,
    LabeledLDA.py:296-302)."""
    th_hat = model.run_test(test.docs, it, thinning)
    preds = model.get_preds(th_hat, n)
    return np.round(th_hat, 4), preds
