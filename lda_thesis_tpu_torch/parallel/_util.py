"""Small shared helpers for the parallel layer.

Counterpart of ``lda_thesis_tpu/parallel/_util.py``.
"""

from __future__ import annotations

import numpy as np

from ..models.labeled_lda import check_merge_block

__all__ = ["pad_axis_to", "dispatch_chunks", "check_merge_block"]


def dispatch_chunks(iters: int, thinning: int, limit: int = 400):
    """Split ``iters`` into chunks of at most about ``limit`` sweeps, aligned
    to ``thinning`` boundaries, so the thinned-save structure is that of a
    single call: the trailing ``iters % thinning`` sweeps run unsaved in the
    final chunk.  The port's trainers loop per merge block and draw from
    generators that carry their own state, so chunking changes no draw."""
    chunk = max((int(limit) // int(thinning)) * int(thinning), int(thinning))
    done = 0
    while done < int(iters):
        step = min(chunk, int(iters) - done)
        yield step
        done += step


def pad_axis_to(x: np.ndarray, target: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``axis`` of a host array up to ``target`` (no-op if equal)."""
    x = np.asarray(x)
    if x.shape[axis] == target:
        return x
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - x.shape[axis])
    return np.pad(x, pad)
