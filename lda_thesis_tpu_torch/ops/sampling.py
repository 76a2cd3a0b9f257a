"""Sampling primitives, on tensors.

Counterpart of ``lda_thesis_tpu/ops/sampling.py``, whole:

* :func:`mask_to_logits` — label-constraint masks as additive ``-inf`` logits;
* :func:`gumbel_argmax` — exact categorical draws by the Gumbel-max trick
  (replaces the reference's ``np.random.multinomial(1, p).argmax()``,
  LabeledLDA.py:119,170-171);
* :func:`norm_cdf` — Φ, kept precise on the left half-line;
* :func:`truncated_normal` — one/two-sided truncated normals by inverse CDF
  (HSLDA's auxiliary variables; replaces ``scipy.stats.truncnorm.rvs``,
  reference HSLDA.py:7,137,292);
* :func:`stirling_table` — the row-normalised table of unsigned Stirling
  numbers of the first kind for HSLDA's Antoniak draw (HSLDA.py:25-36), the
  JAX package's NumPy code.

The JAX module's ``categorical_from_probs`` has no caller in the port.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

__all__ = ["mask_to_logits", "gumbel_argmax", "gumbel", "norm_cdf", "open_uniforms",
           "truncated_normal", "stirling_table"]


def mask_to_logits(mask: torch.Tensor) -> torch.Tensor:
    """Binary mask -> additive float32 logits (0 where allowed, -inf where not)."""
    return torch.where(mask > 0, 0.0, float("-inf")).to(torch.float32)


def gumbel(shape, device, generator: Optional[torch.Generator] = None,
           out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))`` with u uniform in
    ``[tiny, 1)``, as ``jax.random.gumbel`` draws it: never ±inf.  With
    ``out`` (float32, of ``shape``) the noise is written there, with the
    same draws and bits."""
    tiny = torch.finfo(torch.float32).tiny
    if out is None:
        u = torch.rand(shape, generator=generator, device=device, dtype=torch.float32)
        return -torch.log(-torch.log(u.clamp_(min=tiny)))
    torch.rand(tuple(shape), generator=generator, out=out)
    return out.clamp_(min=tiny).log_().neg_().log_().neg_()


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


def norm_cdf(x: torch.Tensor) -> torch.Tensor:
    """Φ(x), with the left half-line by ``erfc``: the JAX function's
    ½(1 + erf) cancels there, and its float32 error turns into large errors
    of deep-tail draws (a positive label at mean −5.4 draws a = 0 in JAX
    and 7.5 with that form in the port, where the exact draw is near 0.18)."""
    w = x / float(np.sqrt(2.0))
    return torch.where(x < 0, 0.5 * torch.erfc(-w), 0.5 * (1.0 + torch.erf(w)))


def open_uniforms(shape, device, generator: Optional[torch.Generator] = None,
                  out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Uniforms in [1e-7, 1), as ``jax.random.uniform(minval=1e-7,
    maxval=1)`` forms them: :func:`truncated_normal`'s draws.  With ``out``
    (float32, of ``shape``) they are written there, with the same draws and
    bits."""
    lo_u = np.float32(1e-7)
    scale, lo = float(np.float32(1.0) - lo_u), float(lo_u)
    if out is None:
        u = torch.rand(tuple(shape), generator=generator, device=device, dtype=torch.float32)
        return torch.clamp(u * scale + lo, min=lo)
    torch.rand(tuple(shape), generator=generator, out=out)
    return out.mul_(scale).add_(lo).clamp_(min=lo)


def truncated_normal(
    lower: torch.Tensor,
    upper: torch.Tensor,
    loc=0.0,
    scale: float = 1.0,
    uniforms: Optional[torch.Tensor] = None,
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Sample N(loc, scale²) truncated to [lower, upper] (elementwise): float32
    tensors on one device (``loc`` may be a number).

    Inverse CDF in the standardised frame, as the JAX function: an interval
    on the right half-line is mirrored into the left one and the draw
    negated, so ``ndtri``'s argument stays in the well-conditioned lower
    tail; Φ of the left half-line comes from ``erfc`` (see :func:`norm_cdf`),
    so the CDF keeps its relative precision there.  Bounds may be ±inf.  ``uniforms`` are the draws in [1e-7, 1) of
    the broadcast shape; without them they come from ``generator``.
    """
    lo, hi = torch.broadcast_tensors((lower - loc) / scale, (upper - loc) / scale)
    device = lo.device

    # reflect right-half intervals into the left half for tail stability
    flip = lo + hi > 0
    lo_f = torch.where(flip, -hi, lo)
    hi_f = torch.where(flip, -lo, hi)

    if uniforms is None:
        u = open_uniforms(lo.shape, device, generator)
    elif tuple(uniforms.shape) != tuple(lo.shape):
        raise ValueError(f"uniforms must have shape {tuple(lo.shape)}, "
                         f"got {tuple(uniforms.shape)}")
    else:
        u = uniforms.to(device=device, dtype=torch.float32)
    cdf_lo = norm_cdf(lo_f)
    cdf_hi = norm_cdf(hi_f)
    p = cdf_lo + u * (cdf_hi - cdf_lo)
    p = torch.clamp(p, 1e-38, 1.0 - 1e-7)
    x = torch.special.ndtri(p)
    x = torch.minimum(torch.maximum(x, lo_f), hi_f)
    x = torch.where(flip, -x, x)
    return loc + scale * x


def stirling_table(n: int) -> np.ndarray:
    """Row-normalised table of unsigned Stirling numbers of the first kind.

    ``table[m, k] = s(m, k) / max_k s(m, k)`` — the reference's
    ``get_stirling_numbers`` (HSLDA.py:25-36) computed in log space so the
    table does not overflow for large ``m`` (the reference overflows float64
    around m ≈ 170).
    """
    logs = np.full((n, n), -np.inf)
    logs[0, 0] = 0.0
    for m in range(1, n):
        # s(m, k) = s(m-1, k-1) + (m-1) * s(m-1, k)
        prev = logs[m - 1]
        left = np.concatenate([[-np.inf], prev[:-1]])
        right = np.log(m - 1) + prev if m > 1 else np.full(n, -np.inf)
        logs[m] = np.logaddexp(left, right)
    row_max = logs.max(axis=1, keepdims=True)
    return np.exp(logs - row_max)
