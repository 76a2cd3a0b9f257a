"""Vocabulary / dictionary layer (host side).

Copy of ``lda_thesis_tpu/data/vocab.py``: a gensim-compatible ``Dictionary``
(ids in order of first appearance, sorted ``doc2bow``, ``filter_extremes``
with an absolute ``no_below``) and ``prune_dict``.  Token ids must match the
JAX package's for the two to compute the same thing.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, Iterable, List, Sequence, Tuple

__all__ = ["Dictionary", "prune_dict"]


class Dictionary:
    def __init__(self, documents: Iterable[Sequence[str]] = ()):  # noqa: D107
        self.token2id: Dict[str, int] = {}
        self.dfs: Dict[int, int] = {}
        self.num_docs = 0
        self.add_documents(documents)

    # ------------------------------------------------------------------

    def add_documents(self, documents: Iterable[Sequence[str]]) -> None:
        for doc in documents:
            self.num_docs += 1
            seen = set()
            for tok in doc:
                tid = self.token2id.get(tok)
                if tid is None:
                    tid = len(self.token2id)
                    self.token2id[tok] = tid
                if tid not in seen:
                    seen.add(tid)
                    self.dfs[tid] = self.dfs.get(tid, 0) + 1

    def doc2bow(self, document: Sequence[str]) -> List[Tuple[int, int]]:
        counts = Counter(document)
        bow = {
            self.token2id[tok]: freq
            for tok, freq in counts.items()
            if tok in self.token2id
        }
        return sorted(bow.items())

    def filter_extremes(
        self,
        no_below: float = 5,
        no_above: float = 0.5,
        keep_n: int = 100000,
    ) -> None:
        no_above_abs = no_above * self.num_docs
        good = [
            tid
            for tid in self.token2id.values()
            if no_below <= self.dfs.get(tid, 0) <= no_above_abs
        ]
        if keep_n is not None and len(good) > keep_n:
            good.sort(key=lambda tid: -self.dfs.get(tid, 0))
            good = good[:keep_n]
        good_set = set(good)
        # compactify: new ids in increasing old-id order
        old_order = sorted(good_set)
        remap = {old: new for new, old in enumerate(old_order)}
        self.token2id = {
            tok: remap[tid] for tok, tid in self.token2id.items() if tid in good_set
        }
        self.dfs = {remap[tid]: df for tid, df in self.dfs.items() if tid in good_set}

    # ------------------------------------------------------------------

    @property
    def id2token(self) -> Dict[int, str]:
        return {v: k for k, v in self.token2id.items()}

    def __len__(self) -> int:
        return len(self.token2id)

    def __contains__(self, token: str) -> bool:
        return token in self.token2id

    def values(self) -> List[str]:
        """Vocabulary terms in id order (reference uses ``list(dicti.values())``)."""
        inv = self.id2token
        return [inv[i] for i in range(len(inv))]


def prune_dict(
    docs: Sequence[Sequence[str]], lower: float = 0.1, upper: float = 0.9
) -> Dictionary:
    """Build a df-pruned dictionary.

    Mirrors reference ``prune_dict`` (LabeledLDA.py:281-285): ``lower`` is a
    corpus fraction converted to an absolute document count.
    """
    dicti = Dictionary(docs)
    dicti.filter_extremes(no_above=upper, no_below=lower * len(docs))
    return dicti
