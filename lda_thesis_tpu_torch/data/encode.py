"""Dense encoding of labelled corpora (NumPy, host side).

Copy of the parts of ``lda_thesis_tpu/data/encode.py`` that the port uses.
Documents become padded ``(D, U)`` arrays of (token type, frequency) slots,
or for HSLDA ``(D, N)`` arrays of token instances with a mask; padding slots
carry ``f = 0`` (mask 0) and are no-ops in every sampler.
"""

from __future__ import annotations

from typing import Dict, Sequence, Tuple

import numpy as np

__all__ = ["build_labelmap", "binarize_labels", "compact_labels", "encode_bow_types",
           "encode_instances"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def build_labelmap(labelset: Sequence[str], root: str = "root") -> Dict[str, int]:
    """Label -> topic-id map with the always-on root label at index 0
    (reference ``labelset.insert(0, 'root')``, LabeledLDA.py:51-52)."""
    labels = [root] + [l for l in labelset if l != root]
    return {l: i for i, l in enumerate(labels)}


def binarize_labels(
    labs: Sequence[Sequence[str]],
    labelmap: Dict[str, int],
    dtype=np.float32,
) -> np.ndarray:
    """(D, K) binary mask with column 0 (root) always on (LabeledLDA.py:94-99)."""
    D, K = len(labs), len(labelmap)
    out = np.zeros((D, K), dtype=dtype)
    out[:, 0] = 1
    for d, lab in enumerate(labs):
        for x in lab:
            idx = labelmap.get(x)
            if idx is not None:
                out[d, idx] = 1
    return out


def compact_labels(
    lab_mask: np.ndarray,  # (D, K) binary
    pad_multiple: int = 8,
) -> Tuple[np.ndarray, np.ndarray]:
    """(D, K) label mask -> compact ``(lab_ids, lab_valid)`` of shape (D, A).

    A = max labels per document rounded up to ``pad_multiple``.  Slot ids are
    ascending per row; pad slots carry id 0 with valid = 0.
    """
    D = lab_mask.shape[0]
    per_doc = [np.flatnonzero(lab_mask[d]) for d in range(D)]
    A = max(1, max((len(x) for x in per_doc), default=1))
    A = _round_up(A, pad_multiple)
    lab_ids = np.zeros((D, A), dtype=np.int32)
    lab_valid = np.zeros((D, A), dtype=np.float32)
    for d, ids in enumerate(per_doc):
        lab_ids[d, : len(ids)] = ids
        lab_valid[d, : len(ids)] = 1.0
    return lab_ids, lab_valid


def encode_bow_types(
    bows: Sequence[Sequence[Tuple[int, int]]],
    pad_multiple: int = 8,
    min_width: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-doc ``(id, freq)`` lists into ``tok_v, tok_f`` of shape (D, U)."""
    D = len(bows)
    U = max([min_width] + [len(b) for b in bows])
    U = _round_up(U, pad_multiple)
    tok_v = np.zeros((D, U), dtype=np.int32)
    tok_f = np.zeros((D, U), dtype=np.int32)
    for d, bow in enumerate(bows):
        for n, (v, f) in enumerate(bow):
            tok_v[d, n] = v
            tok_f[d, n] = f
    return tok_v, tok_f


def encode_instances(
    docs: Sequence[Sequence[int]],
    pad_multiple: int = 8,
    min_width: int = 1,
) -> Tuple[np.ndarray, np.ndarray]:
    """Pack per-doc token-id lists into ``tok_v (D,N), mask (D,N)``."""
    D = len(docs)
    N = max([min_width] + [len(d) for d in docs])
    N = _round_up(N, pad_multiple)
    tok_v = np.zeros((D, N), dtype=np.int32)
    mask = np.zeros((D, N), dtype=np.int32)
    for d, doc in enumerate(docs):
        tok_v[d, : len(doc)] = doc
        mask[d, : len(doc)] = 1
    return tok_v, mask
