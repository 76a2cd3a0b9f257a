"""Collapsed-Gibbs pieces of the Labeled-LDA fused path, on tensors.

Counterpart of ``lda_thesis_tpu/ops/gibbs.py``, limited to what the fused
training path and the fold-in test use: the compact-support init, the
compact → dense doc-topic helpers, the frozen-φ fold-in sweep and the
training log-likelihood.  Counts are float32 tensors holding integers
below 2^24, so every count update is exact in any order.

Every function that draws takes an optional ``uniforms`` tensor of the JAX
function's shape and otherwise draws from ``generator`` (a
``torch.Generator`` on the tensors' device).
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

__all__ = [
    "CompactLDACounts",
    "init_counts_compact",
    "densify_ndk",
    "theta_from_compact",
    "foldin_sweep",
    "log_likelihood",
]


class CompactLDACounts(NamedTuple):
    """Gibbs state over each document's compact label support.

    ``z (D, U)`` int32 slot of each type, ``n_dk (D, A)`` compact doc-topic
    counts, ``n_vk (V, K)`` / ``n_k (K,)`` dense global tables.
    """

    z: torch.Tensor
    n_dk: torch.Tensor
    n_vk: torch.Tensor
    n_k: torch.Tensor


def _uniforms(shape, like: torch.Tensor, uniforms, generator) -> torch.Tensor:
    if uniforms is not None:
        if tuple(uniforms.shape) != tuple(shape):
            raise ValueError(f"uniforms must have shape {tuple(shape)}, "
                             f"got {tuple(uniforms.shape)}")
        return uniforms.to(device=like.device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32)


def init_counts_compact(
    tok_v: torch.Tensor,  # (D, U) int
    tok_f: torch.Tensor,  # (D, U) int
    lab_ids: torch.Tensor,  # (D, A) int, ascending, pads = 0
    lab_valid: torch.Tensor,  # (D, A) float 1/0
    V: int,
    K: int,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> CompactLDACounts:
    """z ~ uniform over each document's admissible labels, and its counts.

    The draw of every position depends only on its uniform and the doc's
    label count, so all positions are drawn at once; the counts follow by
    scatter-add (exact: integer values in float32).
    """
    D, U = tok_v.shape
    A = lab_ids.shape[1]
    u = _uniforms((U, D), tok_v, uniforms, generator)
    c_valid = torch.cumsum(lab_valid, dim=1)  # (D, A)
    total = c_valid[:, -1]  # (D,)
    zc = (c_valid[None, :, :] < (u * total[None, :])[:, :, None]).sum(
        dim=2, dtype=torch.int32).T  # (D, U)
    lab = lab_ids.long()
    zg = torch.gather(lab, 1, zc.long())  # (D, U) global topic ids
    ff = tok_f.to(torch.float32)
    n_dk = torch.zeros((D, A), dtype=torch.float32, device=tok_v.device)
    n_dk.scatter_add_(1, zc.long(), ff)
    n_vk = torch.zeros((V, K), dtype=torch.float32, device=tok_v.device)
    n_vk.index_put_((tok_v.reshape(-1).long(), zg.reshape(-1)), ff.reshape(-1),
                    accumulate=True)
    return CompactLDACounts(z=zc.contiguous(), n_dk=n_dk, n_vk=n_vk,
                            n_k=n_vk.sum(dim=0))


def densify_ndk(n_dk_c: torch.Tensor, lab_ids: torch.Tensor, K: int) -> torch.Tensor:
    """Scatter compact (D, A) doc-topic values into dense (D, K)."""
    D = n_dk_c.shape[0]
    rows = torch.arange(D, device=n_dk_c.device)[:, None].expand_as(lab_ids)
    out = torch.zeros((D, K), dtype=torch.float32, device=n_dk_c.device)
    return out.index_put_((rows, lab_ids.long()), n_dk_c, accumulate=True)


def theta_from_compact(n_dk_c, lab_ids, lab_valid, alpha: float, K: int) -> torch.Tensor:
    """Dense (D, K) label-masked θ from compact counts (LabeledLDA.py:236-239)."""
    num = n_dk_c + lab_valid * alpha
    den = num.sum(dim=1, keepdim=True)
    return densify_ndk(num / torch.clamp(den, min=1e-38), lab_ids, K)


def foldin_sweep(
    z: torch.Tensor,  # (D, U) int32
    n_dk: torch.Tensor,  # (D, K) float32
    tok_v: torch.Tensor,  # (D, U)
    tok_f: torch.Tensor,  # (D, U)
    phi: torch.Tensor,  # (V, K) frozen topic-word distribution
    alpha: float,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fold-in Gibbs sweep for held-out documents with φ frozen.

    p(z=k) ∝ (n_dk + α)·φ[v, k] (reference LabeledLDA.py:185-194), drawn by
    inverse CDF; positions run in order, all documents at once.  Returns
    ``(z, n_dk)``.
    """
    D, U = tok_v.shape
    u = _uniforms((U, D), tok_v, uniforms, generator)
    ff = tok_f.to(torch.float32)
    tv = tok_v.long()
    z = z.clone()
    n_dk = n_dk.clone()
    for p in range(U):
        f_p = ff[:, p]
        z_old = z[:, p].long()[:, None]
        n_dk.scatter_add_(1, z_old, -f_p[:, None])
        c = torch.cumsum((n_dk + alpha) * phi[tv[:, p]], dim=1)
        z_new = (c < (u[p] * c[:, -1])[:, None]).sum(dim=1, dtype=torch.int32)
        z_new = torch.where(f_p > 0, z_new, z[:, p])
        n_dk.scatter_add_(1, z_new.long()[:, None], f_p[:, None])
        z[:, p] = z_new
    return z, n_dk


def log_likelihood(theta, phi_vk, tok_v, tok_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_{d,v} f · log ⟨θ_d, φ_v⟩ and the total token count (float32).

    Used for training perplexity exp(−ll/N) (reference LabeledLDA.py:256-265);
    positions are summed one after another, as in the JAX function.
    """
    acc = torch.zeros((), dtype=torch.float32, device=theta.device)
    ff = tok_f.to(torch.float32)
    tv = tok_v.long()
    for p in range(tok_v.shape[1]):
        inner = (theta * phi_vk[tv[:, p]]).sum(dim=1)
        safe = torch.where(ff[:, p] > 0, torch.log(torch.clamp(inner, min=1e-38)), 0.0)
        acc = acc + (ff[:, p] * safe).sum()
    return acc, tok_f.sum()
