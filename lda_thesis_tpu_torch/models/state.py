"""Posterior estimators and thinned running averages, on tensors.

Counterpart of ``lda_thesis_tpu/models/state.py``:

* :func:`phi_from_counts` — smoothed φ = (n_vk + β)/(n_k + Vβ)
  (reference ``get_phi``, LabeledLDA.py:231-234)
* :func:`theta_from_counts` — label-mask-asymmetric θ = (n_dk + labs·α)/Σ
  (reference ``get_theta``, LabeledLDA.py:236-239)
* :func:`phi_unsmoothed` — n_vk/Σ (reference ``get_ph``, CascadeLDA.py:394-395),
  with 0/0 columns mapped to 0 instead of NaN
* :func:`running_average` — incremental thinned mean
  m_s = (s−1)/s · m_{s−1} + 1/s · x (reference LabeledLDA.py:138-145),
  with the save index on the device (:class:`AverageWeights`) as JAX traces
  it, and :func:`running_average_`, its in-place form
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["phi_from_counts", "theta_from_counts", "phi_unsmoothed", "AverageWeights",
           "running_average", "running_average_"]


def phi_from_counts(n_vk: torch.Tensor, n_k: torch.Tensor, beta: float,
                    topic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, K) smoothed topic-word distribution; padded topics forced to 0."""
    V = n_vk.shape[0]
    phi = (n_vk + beta) / (n_k + V * beta)
    if topic_mask is not None:
        phi = phi * topic_mask
    return phi


def theta_from_counts(n_dk: torch.Tensor, labs: torch.Tensor, alpha: float) -> torch.Tensor:
    """(D, K) doc-topic estimate with the label-masked asymmetric α prior;
    ``n_dk (L, D, K)`` gives every chain's at once."""
    num = n_dk + labs * alpha
    den = num.sum(dim=-1, keepdim=True)
    return num / torch.clamp(den, min=1e-38)


def phi_unsmoothed(n_vk: torch.Tensor,
                   topic_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(V, K) unsmoothed topic-word distribution; empty topics -> 0 columns."""
    den = n_vk.sum(dim=0, keepdim=True)
    phi = n_vk / torch.clamp(den, min=1.0)
    if topic_mask is not None:
        phi = phi * topic_mask
    return phi


class AverageWeights:
    """The weights of save ``s`` (1-based) of a thinned mean, as 0-dim
    tensors on ``device``: ``first = (s <= 1)``, ``keep = (s−1)/s`` and
    ``rinv = 1/s``, each rounded to float32 on the host as the JAX function
    rounds them.  :meth:`set` refills them in place, so a captured CUDA
    graph that reads them takes each save's weights."""

    def __init__(self, device, s: Optional[int] = None):
        self.first = torch.zeros((), dtype=torch.bool, device=device)
        self.keep = torch.zeros((), dtype=torch.float32, device=device)
        self.rinv = torch.zeros((), dtype=torch.float32, device=device)
        if s is not None:
            self.set(s)

    def set(self, s: int) -> None:
        s32 = np.float32(s)
        self.first.fill_(int(s) <= 1)
        self.keep.fill_(float((s32 - np.float32(1.0)) / s32))
        self.rinv.fill_(float(np.float32(1.0) / s32))


def running_average_(avg: torch.Tensor, cur: torch.Tensor, w: AverageWeights) -> torch.Tensor:
    """:func:`running_average` into ``avg``, in place; returns ``avg``."""
    return torch.where(w.first, cur, w.keep * avg + cur * w.rinv, out=avg)


def running_average(avg: torch.Tensor, cur: torch.Tensor, s: int) -> torch.Tensor:
    """Thinned incremental mean; ``s`` is the 1-based save index.

    ``where(s <= 1, cur, keep·avg + cur·(1/s))`` with the weights in device
    scalars (:class:`AverageWeights`): a card computes ``cur / float(s)`` as
    this multiply by the float32 reciprocal, so the form has a card's bits
    of the division by a host number (``chip_smoke.divisor_check``); on the
    CPU it can differ from that division in the last bit.
    """
    w = AverageWeights(avg.device, s)
    return torch.where(w.first, cur, w.keep * avg + cur * w.rinv)
