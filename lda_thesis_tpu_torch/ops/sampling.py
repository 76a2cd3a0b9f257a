"""Sampling primitives, on tensors.

Counterpart of the parts of ``lda_thesis_tpu/ops/sampling.py`` that
CascadeLDA's fold-in uses:

* :func:`mask_to_logits` — label-constraint masks as additive ``-inf`` logits;
* :func:`gumbel_argmax` — exact categorical draws by the Gumbel-max trick
  (replaces the reference's ``np.random.multinomial(1, p).argmax()``,
  LabeledLDA.py:119,170-171).

``truncated_normal`` and ``stirling_table`` are HSLDA's and come with it.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["mask_to_logits", "gumbel_argmax", "gumbel"]


def mask_to_logits(mask: torch.Tensor) -> torch.Tensor:
    """Binary mask -> additive float32 logits (0 where allowed, -inf where not)."""
    return torch.where(mask > 0, 0.0, float("-inf")).to(torch.float32)


def gumbel(shape, device, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with u uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it: never ±inf."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_(min=tiny)))


def gumbel_argmax(logits: torch.Tensor, dim: int = -1,
                  gumbels: Optional[torch.Tensor] = None,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Exact categorical sample via the Gumbel-max trick.

    ``gumbels`` is the noise, of ``logits``' shape; without it the noise is
    drawn from ``generator``.  ``-inf`` logits are never selected unless a
    whole slice is ``-inf``, which gives index 0 (callers keep index 0
    admissible).  Returns int64 indices.
    """
    if gumbels is None:
        gumbels = gumbel(logits.shape, logits.device, generator)
    elif gumbels.shape != logits.shape:
        raise ValueError(f"gumbels must have shape {tuple(logits.shape)}, "
                         f"got {tuple(gumbels.shape)}")
    return torch.argmax(logits + gumbels.to(logits.device), dim=dim)
