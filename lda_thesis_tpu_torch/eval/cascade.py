"""CascadeLDA tree-probability reassembly (NumPy, host side).

Copy of ``lda_thesis_tpu/eval/cascade.py``: ``setup_theta`` multiplies each
node-local probability by its ancestors' probabilities down the tree to give
a flat (D, K) θ̂ comparable with Labeled LDA — the semantics of the reference
evaluate_CascadeLDA.py:95-127, including the regex-based child lookup over
the space-joined label string and the update order (level-3 tuples first,
overwritten upward).
"""

from __future__ import annotations

import re
from typing import Dict, List, Sequence, Tuple

import numpy as np

__all__ = ["setup_theta"]


def setup_theta(
    l1p: Sequence[List[Tuple[str, float]]],
    l2p: Sequence[List[List[Tuple[str, float]]]],
    l3p: Sequence[List[List[Tuple[str, float]]]],
    labelmap: Dict[str, int],
) -> np.ndarray:
    """Flatten per-level cascade predictions into a (D, K) θ̂ matrix.

    ``l1p[d]`` is a list of (label, prob); ``l2p[d]``/``l3p[d]`` are lists of
    such lists (one per expanded parent node) — the structure returned by
    ``CascadeLDA.test_down_tree(_batch)``.
    """
    n = len(l1p)
    K = len(labelmap)
    th_hat = np.zeros((n, K), dtype=float)

    for d in range(n):
        levels: Dict[str, float] = {}
        for tuplist in l3p[d]:
            levels.update(tuplist)
        for tuplist in l2p[d]:
            levels.update(tuplist)
        levels.update(l1p[d])

        # multiply local probabilities down the tree (ref :112-120)
        predecessors = [s for (s, _) in l1p[d]]
        lookup = " ".join(levels.keys())
        for p in predecessors:
            pat = re.compile("(" + re.escape(p) + r"[0-9])(?:[^0-9]|$)")
            currents = re.findall(pat, lookup)
            for c in currents:
                levels[c] *= levels[p]
                finals = re.findall(re.compile(re.escape(c) + "[0-9]"), lookup)
                for f in finals:
                    levels[f] *= levels[c]

        for lab, prob in levels.items():
            idx = labelmap.get(lab)
            if idx is not None:
                th_hat[d, idx] = prob
    return th_hat
