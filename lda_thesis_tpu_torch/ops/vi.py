"""Variational inference for (labeled) LDA — CAVI and SVI, on tensors.

Counterpart of ``lda_thesis_tpu/ops/vi.py``: the mean-field family
q(θ_d)=Dir(γ_d), q(β_k)=Dir(λ_k), q(z_dn)=Cat(r_dn) with the
label-constrained prior α_dk = α·lab_dk; responsibilities are masked exactly
like the collapsed sampler's posterior (E[log θ] is −inf off the label set).

The (D, U, K) responsibility tensor is never materialised whole.  The JAX
package scans one type position at a time; here the positions go in chunks
of ``C`` (:func:`_chunk`), so each step works on a (D, C, K) slice of a few
hundred MB at most and a sweep is a few dozen launches, not one per
position.  The γ and ELBO statistics are summed over a chunk's positions
before they are added to the running totals, so the float32 sums are taken
in another order than the JAX scan's (the results agree to about 1e-6
relative, not bit for bit).  The λ statistics land by ``index_add_`` on the
(V, K) table.  Digamma and lgamma come from ``torch.special``; no matrix
product is used.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

__all__ = ["VIState", "vi_init", "cavi_step", "svi_epoch", "elbo"]

# elements of one (D, C, K) slice: 2^26 float32 values, 256 MB
SLICE_ELEMENTS = 1 << 26
_TINY = 1e-38

_digamma = torch.special.digamma
_lgamma = torch.special.gammaln


class VIState(NamedTuple):
    gamma: torch.Tensor  # (D, K) doc-topic Dirichlet params
    lam: torch.Tensor  # (V, K) topic-word Dirichlet params


def vi_init(labs: torch.Tensor, V: int, alpha: float, beta: float,
            generator: Optional[torch.Generator] = None) -> VIState:
    """γ = prior + tokens/K heuristic start; λ = β + 0.5, plus uniform noise
    on [0, 0.5) drawn from ``generator`` where one is given (without one the
    start is deterministic, as the JAX function's with ``key=None``)."""
    D, K = labs.shape
    gamma = labs * alpha + labs
    lam = torch.full((V, K), beta, dtype=torch.float32, device=labs.device) + 0.5
    if generator is not None:
        lam = lam + 0.5 * torch.rand((V, K), generator=generator, device=labs.device)
    return VIState(gamma=gamma, lam=lam)


def _expect_logs(state: VIState, labs):
    """E[log θ] (masked to −inf off the labels) and E[log β]."""
    gamma = state.gamma
    el_theta = _digamma(gamma) - _digamma(gamma.sum(dim=1, keepdim=True))
    el_theta = torch.where(labs > 0, el_theta, -torch.inf)  # hard label constraint
    el_beta = _digamma(state.lam) - _digamma(state.lam.sum(dim=0, keepdim=True))
    return el_theta, el_beta


def _chunk(D: int, K: int) -> int:
    """Type positions per slice: (D, C, K) stays within ``SLICE_ELEMENTS``."""
    return max(1, SLICE_ELEMENTS // max(D * K, 1))


def _slices(tok_v, tok_f, el_theta, el_beta):
    """Per chunk of positions: (token ids (D, C), f (D, C), responsibilities
    (D, C, K), log-sum-exp (D, C)), in position order."""
    D, K = el_theta.shape
    U = tok_v.shape[1]
    step = _chunk(D, K)
    tv = tok_v.long()
    ff = tok_f.to(torch.float32)
    for p0 in range(0, U, step):
        v = tv[:, p0:p0 + step]
        s = el_theta[:, None, :] + el_beta[v]  # (D, C, K)
        m = s.max(dim=2, keepdim=True).values
        e = torch.where(torch.isfinite(s), torch.exp(s - m), 0.0)
        denom = e.sum(dim=2, keepdim=True)
        r = e / torch.clamp(denom, min=_TINY)
        lse = m[..., 0] + torch.log(torch.clamp(denom[..., 0], min=_TINY))
        yield v, ff[:, p0:p0 + step], r, lse


def _accumulate(tok_v, tok_f, el_theta, el_beta, V: int):
    """Responsibilities → (γ stats (D, K), λ stats (V, K), ELBO token term)."""
    D, K = el_theta.shape
    g_acc = torch.zeros((D, K), dtype=torch.float32, device=el_theta.device)
    l_acc = torch.zeros((V, K), dtype=torch.float32, device=el_theta.device)
    tok_elbo = torch.zeros((), dtype=torch.float32, device=el_theta.device)
    for v, ff, r, lse in _slices(tok_v, tok_f, el_theta, el_beta):
        fr = ff[:, :, None] * r
        g_acc = g_acc + fr.sum(dim=1)
        l_acc.index_add_(0, v.reshape(-1), fr.reshape(-1, K))
        # Σ f·(Σ_k r·s − Σ_k r·log r) = Σ f·logsumexp(s)  (standard identity)
        tok_elbo = tok_elbo + (ff * torch.where(ff > 0, lse, 0.0)).sum()
    return g_acc, l_acc, tok_elbo


def _gamma_stats(tok_v, tok_f, el_theta, el_beta):
    """γ sufficient statistics only (no (V, K) λ accumulator)."""
    g_acc = torch.zeros_like(el_theta)
    for _, ff, r, _ in _slices(tok_v, tok_f, el_theta, el_beta):
        g_acc = g_acc + (ff[:, :, None] * r).sum(dim=1)
    return g_acc


def cavi_step(state: VIState, tok_v, tok_f, labs, alpha: float,
              beta: float) -> Tuple[VIState, torch.Tensor]:
    """One full CAVI iteration; returns (new state, ELBO of the new state).

    Batch coordinate ascent: r given (γ, λ); then γ = α·lab + Σ f·r and
    λ = β + Σ f·r jointly.  The ELBO is non-decreasing across iterations.
    """
    V = state.lam.shape[0]
    el_theta, el_beta = _expect_logs(state, labs)
    g_stats, l_stats, _ = _accumulate(tok_v, tok_f, el_theta, el_beta, V)
    new = VIState(gamma=labs * alpha + g_stats, lam=beta + l_stats)
    return new, elbo(new, tok_v, tok_f, labs, alpha, beta)


def svi_epoch(state: VIState, tok_v, tok_f, labs, alpha: float, beta: float,
              t0: int, batch_size: int, local_iters: int = 1, tau: float = 1.0,
              kappa: float = 0.8,
              generator: Optional[torch.Generator] = None) -> VIState:
    """One stochastic-VI epoch (Hoffman '13), as the JAX function: shuffled
    minibatches (the permutation drawn from ``generator``), γ iterated
    ``local_iters`` times per batch with λ fixed, then the natural-gradient
    step λ ← (1−ρ_t)λ + ρ_t·λ̂ with ρ_t = (τ₀ + t)^−κ counted over global
    minibatch updates from ``t0``.  The caller advances its counter by the
    number of batches per epoch (``D // batch_size``)."""
    D = tok_v.shape[0]
    V = state.lam.shape[0]
    n_batches = D // batch_size
    perm = torch.randperm(D, generator=generator, device=tok_v.device)
    batches = perm[: n_batches * batch_size].view(n_batches, batch_size)
    gamma, lam = state
    for j, idx in enumerate(batches):
        rho = float(np.float32(np.float32(tau) + np.float32(t0 + j)) ** np.float32(-kappa))
        bv, bf, bl = tok_v[idx], tok_f[idx], labs[idx]
        el_beta = _digamma(lam) - _digamma(lam.sum(dim=0, keepdim=True))
        gamma_b = gamma[idx]
        for _ in range(max(int(local_iters) - 1, 0)):
            el_theta = _digamma(gamma_b) - _digamma(gamma_b.sum(dim=1, keepdim=True))
            el_theta = torch.where(bl > 0, el_theta, -torch.inf)
            gamma_b = bl * alpha + _gamma_stats(bv, bf, el_theta, el_beta)
        # the final local pass also collects the λ statistics
        el_theta = _digamma(gamma_b) - _digamma(gamma_b.sum(dim=1, keepdim=True))
        el_theta = torch.where(bl > 0, el_theta, -torch.inf)
        g_stats, l_stats, _ = _accumulate(bv, bf, el_theta, el_beta, V)
        gamma = gamma.index_put((idx,), bl * alpha + g_stats)
        lam_hat = beta + (D / batch_size) * l_stats
        lam = (1.0 - rho) * lam + rho * lam_hat
    return VIState(gamma=gamma, lam=lam)


def elbo(state: VIState, tok_v, tok_f, labs, alpha: float, beta: float) -> torch.Tensor:
    """Evidence lower bound of the current variational state (masked dims of
    θ are treated as absent: their γ is 0 by construction)."""
    gamma, lam = state
    V, K = lam.shape
    el_theta, el_beta = _expect_logs(state, labs)
    el_theta_f = torch.where(labs > 0, el_theta, 0.0)

    # token term: Σ f·logsumexp(Elogθ + Elogβ[v])
    _, _, tok_elbo = _accumulate(tok_v, tok_f, el_theta, el_beta, V)

    def lg(x: float) -> torch.Tensor:
        return _lgamma(torch.tensor(x, dtype=torch.float32, device=lam.device))

    # E[log p(θ|α)] − E[log q(θ|γ)] over admissible topics
    a_mat = labs * alpha
    n_lab = labs.sum(dim=1)
    theta_prior = (
        _lgamma(torch.clamp(alpha * n_lab, min=_TINY))
        - n_lab * lg(alpha)
        + ((a_mat - labs) * el_theta_f).sum(dim=1)
    )
    g_safe = torch.where(labs > 0, gamma, 1.0)
    theta_q = (
        _lgamma(torch.clamp(gamma.sum(dim=1), min=_TINY))
        - (labs * _lgamma(g_safe)).sum(dim=1)
        + ((gamma - labs) * el_theta_f).sum(dim=1)
    )

    # E[log p(β|η)] − E[log q(β|λ)]
    beta_prior = (
        lg(V * beta) - V * lg(beta)
        + ((beta - 1.0) * el_beta).sum(dim=0)
    )
    beta_q = (
        _lgamma(lam.sum(dim=0)) - _lgamma(lam).sum(dim=0)
        + ((lam - 1.0) * el_beta).sum(dim=0)
    )
    return tok_elbo + (theta_prior - theta_q).sum() + (beta_prior - beta_q).sum()
