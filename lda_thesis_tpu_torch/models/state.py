"""Posterior estimators and thinned running averages, on tensors.

Counterpart of ``lda_thesis_tpu/models/state.py``:

* :func:`phi_from_counts` — smoothed φ = (n_vk + β)/(n_k + Vβ)
  (reference ``get_phi``, LabeledLDA.py:231-234)
* :func:`theta_from_counts` — label-mask-asymmetric θ = (n_dk + labs·α)/Σ
  (reference ``get_theta``, LabeledLDA.py:236-239)
* :func:`phi_unsmoothed` — n_vk/Σ (reference ``get_ph``, CascadeLDA.py:394-395),
  with 0/0 columns mapped to 0 instead of NaN
* :func:`running_average` — incremental thinned mean
  m_s = (s−1)/s · m_{s−1} + 1/s · x (reference LabeledLDA.py:138-145)
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["phi_from_counts", "theta_from_counts", "phi_unsmoothed", "running_average"]


def phi_from_counts(n_vk: torch.Tensor, n_k: torch.Tensor, beta: float,
                    topic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, K) smoothed topic-word distribution; padded topics forced to 0."""
    V = n_vk.shape[0]
    phi = (n_vk + beta) / (n_k + V * beta)
    if topic_mask is not None:
        phi = phi * topic_mask
    return phi


def theta_from_counts(n_dk: torch.Tensor, labs: torch.Tensor, alpha: float) -> torch.Tensor:
    """(D, K) doc-topic estimate with the label-masked asymmetric α prior."""
    num = n_dk + labs * alpha
    den = num.sum(dim=1, keepdim=True)
    return num / torch.clamp(den, min=1e-38)


def phi_unsmoothed(n_vk: torch.Tensor,
                   topic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, K) unsmoothed topic-word distribution; empty topics -> 0 columns."""
    den = n_vk.sum(dim=0, keepdim=True)
    phi = n_vk / torch.clamp(den, min=1.0)
    if topic_mask is not None:
        phi = phi * topic_mask
    return phi


def running_average(avg: torch.Tensor, cur: torch.Tensor, s: int) -> torch.Tensor:
    """Thinned incremental mean; ``s`` is the 1-based save index.

    The weights are rounded to float32 as the JAX function rounds them.
    """
    if s <= 1:
        return cur.clone()
    s32 = np.float32(s)
    keep = float((s32 - np.float32(1.0)) / s32)
    return keep * avg + cur / float(s32)
