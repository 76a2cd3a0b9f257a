"""Document-length bucketing (NumPy, host side).

Copy of ``lda_thesis_tpu/data/buckets.py``.  The bucket layout decides the
order in which documents are swept and so is part of the draw stream; it
must match the JAX package's exactly.

Bucket boundaries minimise the total padded area Σ_g D_g·U_g by dynamic
programming over the sorted length distribution.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Sequence, Tuple

import numpy as np

__all__ = ["BucketedDocs", "plan_buckets", "bucket_encode"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def plan_buckets(
    lengths: Sequence[int], n_buckets: int, pad_multiple: int = 8
) -> List[int]:
    """Upper length bounds per bucket minimising Σ count·bound (DP, exact).

    Returns ascending bucket bounds (padded to ``pad_multiple``); the last
    bound covers the maximum length.
    """
    lens = np.asarray(sorted(int(x) for x in lengths))
    n = len(lens)
    if n == 0:
        return [pad_multiple]
    uniq = np.unique(lens)
    cands = np.unique([_round_up(int(u), pad_multiple) for u in uniq])
    G = min(n_buckets, len(cands))
    if G <= 1:
        return [int(cands[-1])]

    # docs_below[i] = #docs with length <= cands[i]
    docs_below = np.searchsorted(lens, cands, side="right")

    INF = float("inf")
    C = len(cands)
    # dp[g][i] = min cost covering docs with len <= cands[i] using g buckets
    dp = [[INF] * C for _ in range(G + 1)]
    choice = [[-1] * C for _ in range(G + 1)]
    for i in range(C):
        dp[1][i] = float(docs_below[i] * cands[i])
    for g in range(2, G + 1):
        for i in range(g - 1, C):
            for j in range(g - 2, i):
                cost = dp[g - 1][j] + (docs_below[i] - docs_below[j]) * cands[i]
                if cost < dp[g][i]:
                    dp[g][i] = cost
                    choice[g][i] = j
    # backtrack from dp[G][C-1]
    bounds = [int(cands[C - 1])]
    g, i = G, C - 1
    while g > 1:
        j = choice[g][i]
        if j < 0:
            break
        bounds.append(int(cands[j]))
        i, g = j, g - 1
    return sorted(set(bounds))


@dataclass
class BucketedDocs:
    """Per-bucket dense encodings plus the row → original-doc mapping."""

    tok_v: List[np.ndarray]  # per bucket (D_g, U_g) int32
    tok_f: List[np.ndarray]  # per bucket (D_g, U_g) int32
    doc_idx: List[np.ndarray]  # per bucket (D_g,) original doc indices

    @property
    def n_buckets(self) -> int:
        return len(self.tok_v)

    @property
    def n_docs(self) -> int:
        return sum(len(ix) for ix in self.doc_idx)

    def scatter_rows(self, per_bucket_rows: List[np.ndarray]) -> np.ndarray:
        """Reassemble per-bucket row arrays into original document order."""
        total = self.n_docs
        first = per_bucket_rows[0]
        out = np.zeros((total,) + first.shape[1:], dtype=first.dtype)
        for ix, rows in zip(self.doc_idx, per_bucket_rows):
            out[ix] = rows
        return out


def bucket_encode(
    bows: Sequence[Sequence[Tuple[int, int]]],
    n_buckets: int = 4,
    pad_multiple: int = 8,
) -> BucketedDocs:
    """Partition bow-encoded docs into length buckets with tight padding."""
    lengths = [max(len(b), 1) for b in bows]
    bounds = plan_buckets(lengths, n_buckets, pad_multiple)

    groups: List[List[int]] = [[] for _ in bounds]
    for d, l in enumerate(lengths):
        for g, b in enumerate(bounds):
            if l <= b:
                groups[g].append(d)
                break

    tok_v, tok_f, doc_idx = [], [], []
    for g, b in enumerate(bounds):
        if not groups[g]:
            continue
        ids = np.asarray(groups[g], np.int64)
        U = int(b)
        tv = np.zeros((len(ids), U), np.int32)
        tf = np.zeros((len(ids), U), np.int32)
        for r, d in enumerate(ids):
            for n, (v, f) in enumerate(bows[d]):
                tv[r, n] = v
                tf[r, n] = f
        tok_v.append(tv)
        tok_f.append(tf)
        doc_idx.append(ids)
    return BucketedDocs(tok_v=tok_v, tok_f=tok_f, doc_idx=doc_idx)
