"""Plain reference of HSLDA's timed paths (Perotte '11, the thesis's
``HSLDA.py``): blocked-Gibbs training cycles z → η → a → m → β with the
coupling of ``--opt 1`` and thinned φ̂/z̄ saves, and the fold-in of
held-out documents with their label probabilities Φ(z̄·η − ξ).

Plain PyTorch, written from the model; it imports nothing of the program.
It follows the program from a state the program reached (its counts, η, a,
β and its generator's state at a call's start, or its trained state for a
fold-in), so it draws the same noise in the same order: per cycle the
z-sweep's Gumbels (N, D, K), η's normals (K, L), a's uniforms in [1e-7, 1)
(D, L) and m's Gumbels (D, K, S), then β's Gamma variates; per fold-in one
(N, D) block of uniforms for the init pass and one per sweep.  What the
program derived from the corpus (its vocabulary ids, instance layout and
label columns) is checked against the corpus before it is used.

Where an operation has no bfloat16 form (the Cholesky factor, the inverse
normal CDF, the Gamma draw), the control rounds its inputs and outputs to
``dtype`` and computes it in float32.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

TINY = float(torch.finfo(torch.float32).tiny)
LO_U = np.float32(1e-7)


class State(NamedTuple):
    """A training state: ``z (D, N)`` topics, int counts ``n_dk (D, K)``,
    ``n_vk (V, K)``, ``n_k (K,)``, and η (L, K), a (D, L), β (K,)."""

    z: torch.Tensor
    n_dk: torch.Tensor
    n_vk: torch.Tensor
    n_k: torch.Tensor
    eta: torch.Tensor
    a: torch.Tensor
    beta: torch.Tensor


def check_layout(tok_v: np.ndarray, mask: np.ndarray, labs: np.ndarray, words: Sequence[str],
                 labels: Sequence[str], docs, doc_labs, root: str) -> None:
    """Raise ``ValueError`` unless row d of ``tok_v``/``mask`` holds document
    d's tokens in order (``words[v]`` names id v) and row d of ``labs`` its
    labels and ``root`` (``labels[l]`` names column l)."""
    names = np.asarray(words, dtype=object)
    for d, doc in enumerate(docs):
        n = int(mask[d].sum())
        if n != len(doc) or not mask[d, :n].all() or list(names[tok_v[d, :n]]) != list(doc):
            raise ValueError(f"document {d}'s tokens differ from the corpus")
        got = sorted(labels[l] for l in np.flatnonzero(labs[d] > 0))
        if got != sorted(set(doc_labs[d]) | {root}):
            raise ValueError(f"document {d}'s label columns differ from its labels")


def log_stirling(n: int) -> np.ndarray:
    """log of s(m, k)/max_k s(m, k), the row-normalised unsigned Stirling
    numbers of the first kind, m, k < n (−inf where s = 0)."""
    logs = np.full((n, n), -np.inf)
    logs[0, 0] = 0.0
    for m in range(1, n):
        grow = np.log(m - 1) + logs[m - 1] if m > 1 else np.full(n, -np.inf)
        logs[m] = np.logaddexp(np.concatenate([[-np.inf], logs[m - 1, :-1]]), grow)
    with np.errstate(invalid="ignore"):
        return logs - logs.max(axis=1, keepdims=True)


def _gumbel(shape, gen, device) -> torch.Tensor:
    u = torch.rand(shape, generator=gen, device=device)
    return -torch.log(-torch.log(torch.clamp(u, min=TINY)))


def _phi(x: torch.Tensor) -> torch.Tensor:
    """Φ(x), by erfc on the left half-line."""
    w = x / float(np.sqrt(2.0))
    return torch.where(x < 0, 0.5 * torch.erfc(-w), 0.5 * (1.0 + torch.erf(w)))


def _truncated(mean: torch.Tensor, positive: torch.Tensor, u: torch.Tensor) -> torch.Tensor:
    """N(mean, 1) truncated to (0, ∞) where ``positive``, else to (−∞, 0),
    by inverse CDF with uniforms ``u``; an interval on the right half-line
    is mirrored into the left one so the inverse CDF stays in its lower
    tail."""
    inf = torch.full_like(mean, float("inf"))
    lo = torch.where(positive, -mean, -inf)
    hi = torch.where(positive, inf, -mean)
    flip = lo + hi > 0
    lo_f, hi_f = torch.where(flip, -hi, lo), torch.where(flip, -lo, hi)
    c_lo, c_hi = _phi(lo_f), _phi(hi_f)
    p = torch.clamp(c_lo + u * (c_hi - c_lo), 1e-38, 1.0 - 1e-7)
    x = torch.minimum(torch.maximum(torch.special.ndtri(p), lo_f), hi_f)
    return mean + torch.where(flip, -x, x)


def train_call(tok_v: torch.Tensor, mask: torch.Tensor, labs: torch.Tensor, start: State,
               generator: torch.Generator, V: int, alpha: float, aprime: float, gamma: float,
               mu: float, sigma: float, cycles: int, thinning: int, dtype=torch.float32):
    """``cycles`` blocked-Gibbs cycles (coupling 1) from ``start``, a save at
    every ``thinning``-th; returns the end state, φ̂ (K, V) and z̄ (D, K),
    the saves' thinned means of n_kv/Σ_v and n_dk/n_d."""
    dev = tok_v.device
    D, N = tok_v.shape
    K = start.n_dk.shape[1]
    L = labs.shape[1]
    f32 = torch.float32
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(f32)
    S = max(int(mask.sum(dim=1).max()) + 2, 8)
    logs = torch.as_tensor(log_stirling(S), dtype=f32, device=dev)
    z = start.z.clone().long()
    n_dk, n_vk, n_k = (x.clone().long() for x in start[1:4])
    eta, a, beta = (x.to(dtype) for x in start[4:])
    labs_t = labs.to(dtype)
    positive = labs > 0
    vgamma = float(np.float32(V) * np.float32(gamma))
    ph = zb = None
    saves = 0
    for c in range(cycles):
        g_z = _gumbel((N, 1, D, K), generator, dev)[:, 0]
        eps = torch.randn((1, K, L), generator=generator, device=dev)[0]
        u_a = torch.rand((1, D, L), generator=generator, device=dev)[0]
        u_a = torch.clamp(u_a * float(np.float32(1) - LO_U) + float(LO_U), min=float(LO_U))
        g_m = _gumbel((1, D, K, S), generator, dev)[0]
        ab = (alpha * beta).to(dtype)
        t2 = (labs_t @ (eta * eta)) * (0.5 / (n_d * n_d)).to(dtype)[:, None]  # (D, K)
        rows = torch.arange(D, device=dev)
        for p in range(N):
            live = mask[:, p] > 0
            v, old = tok_v[:, p].long(), z[:, p]
            m = live.long()
            n_dk[rows, old] -= m
            n_vk.index_put_((v, old), -m, accumulate=True)
            n_k.index_put_((old,), -m, accumulate=True)
            zbar = n_dk.to(dtype) / n_d.to(dtype)[:, None]
            M = zbar @ eta.T  # (D, L)
            logp = (torch.log(n_dk.to(dtype) + ab) + torch.log(n_vk[v].to(dtype) + gamma)
                    - torch.log(n_k.to(dtype) + vgamma))
            logp = logp - ((((M - a) * labs_t) @ eta) / n_d.to(dtype)[:, None] + t2)
            new = torch.argmax(logp.to(f32) + g_z[p], dim=1)
            new = torch.where(live, new, old)
            n_dk[rows, new] += m
            n_vk.index_put_((v, new), m, accumulate=True)
            n_k.index_put_((new,), m, accumulate=True)
            z[:, p] = new
        zbar = (n_dk.to(f32) / n_d[:, None]).to(dtype)
        # η | z̄, a: precision I/σ + z̄ᵀz̄, mean Σ̂(μ/σ + z̄ᵀa), draw μ̂ + chol⁻ᵀ ε
        prec = (torch.eye(K, device=dev) / float(np.float32(sigma))
                + (zbar.T @ zbar).to(f32)).to(dtype).to(f32)
        chol = torch.linalg.cholesky(prec)
        rhs = (float(np.float32(mu) / np.float32(sigma)) + (zbar.T @ a).to(f32)).to(dtype).to(f32)
        mean = torch.cholesky_solve(rhs, chol)
        eta = (mean + torch.linalg.solve_triangular(chol.T, eps, upper=True)).T.to(dtype)
        a = _truncated((zbar @ eta.T).to(f32), positive, u_a).to(dtype)
        # m: Antoniak table counts by Gumbel-max over log s(n, m) + m·log(αβ_k)
        log_ab = torch.log(torch.clamp(alpha * beta.to(f32), min=1e-38))
        steps = torch.arange(S, device=dev, dtype=f32)[None, None, :] * log_ab[None, :, None]
        logits = (logs[torch.clamp(n_dk, max=S - 1)] + steps).to(dtype).to(f32)
        mdot = torch.argmax(logits + g_m, dim=2).sum(dim=0).to(f32) / D
        gam = torch._standard_gamma(mdot + float(np.float32(aprime)), generator=generator)
        beta = (gam / gam.sum()).to(dtype)
        if (c + 1) % thinning == 0:
            saves += 1
            n_kv = n_vk.to(f32).T
            cur_ph = n_kv / torch.clamp(n_kv.sum(dim=1, keepdim=True), min=1.0)
            cur_zb = n_dk.to(f32) / n_d[:, None]
            w_keep, w_new = (saves - 1) / saves, 1.0 / saves
            ph = cur_ph if ph is None else w_keep * ph + w_new * cur_ph
            zb = cur_zb if zb is None else w_keep * zb + w_new * cur_zb
    end = State(z, n_dk, n_vk, n_k, eta.to(f32), a.to(f32), beta.to(f32))
    return end, ph, zb


def recount(tok_v: torch.Tensor, mask: torch.Tensor, z: torch.Tensor, V: int, K: int):
    """``n_dk``, ``n_vk`` and ``n_k`` (int64) of the assignment ``z (D, N)``."""
    m = mask.long()
    n_dk = torch.zeros((z.shape[0], K), dtype=torch.long, device=z.device)
    n_dk.scatter_add_(1, z.long(), m)
    n_vk = torch.zeros((V, K), dtype=torch.long, device=z.device)
    n_vk.index_put_((tok_v.long().reshape(-1), z.long().reshape(-1)), m.reshape(-1),
                    accumulate=True)
    return n_dk, n_vk, n_vk.sum(dim=0)


def test_layout(docs, word_ids):
    """Held-out documents as ``tok_v``/``mask (D, N)``: each document's known
    words in order, N the longest rounded up to a multiple of eight."""
    ids = [[word_ids[w] for w in doc if w in word_ids] for doc in docs]
    N = -(-max([1] + [len(x) for x in ids]) // 8) * 8
    tok_v = np.zeros((len(docs), N), np.int64)
    mask = np.zeros((len(docs), N), np.int64)
    for d, row in enumerate(ids):
        tok_v[d, :len(row)] = row
        mask[d, :len(row)] = 1
    return tok_v, mask


def fold_in(init_phi: torch.Tensor, sweep_phi: torch.Tensor, alpha_beta: torch.Tensor,
            tok_v: torch.Tensor, mask: torch.Tensor, it: int, thinning: int,
            generator: torch.Generator, dtype=torch.float32) -> torch.Tensor:
    """z̄ (D, K) of held-out documents: z drawn per token from ``init_phi
    (V, K)``'s row for the word, then ``it`` sweeps against ``sweep_phi (V,
    K)`` with weight (n_dk − [k = z] + αβ_k)·φ[v, k], and n_dk/n_d averaged at
    every ``thinning``-th sweep."""
    D, N = tok_v.shape
    dev = tok_v.device
    init_phi, sweep_phi, ab = init_phi.to(dtype), sweep_phi.to(dtype), alpha_beta.to(dtype)
    mf = mask.to(dtype)
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    u = torch.rand((N, D), generator=generator, device=dev)
    n_dk = torch.zeros((D, init_phi.shape[1]), dtype=dtype, device=dev)
    z = torch.empty((D, N), dtype=torch.long, device=dev)
    for p in range(N):
        c = torch.cumsum(init_phi[tok_v[:, p]], dim=1)
        z[:, p] = (c < (u[p].to(dtype) * c[:, -1])[:, None]).sum(dim=1)
        n_dk.scatter_add_(1, z[:, p, None], mf[:, p, None])
    avg: Optional[torch.Tensor] = None
    saves = 0
    for i in range(int(it)):
        u = torch.rand((N, D), generator=generator, device=dev)
        for p in range(N):
            fp = mf[:, p]
            n_dk.scatter_add_(1, z[:, p, None], -fp[:, None])
            c = torch.cumsum((n_dk + ab) * sweep_phi[tok_v[:, p]], dim=1)
            new = (c < (u[p].to(dtype) * c[:, -1])[:, None]).sum(dim=1)
            new = torch.where(fp > 0, new, z[:, p])
            n_dk.scatter_add_(1, new[:, None], fp[:, None])
            z[:, p] = new
        if (i + 1) % int(thinning) == 0:
            saves += 1
            cur = n_dk.to(torch.float32) / n_d[:, None]
            if avg is None:
                avg = cur
            else:
                s32 = np.float32(saves)
                avg = float((s32 - np.float32(1)) / s32) * avg + cur * float(np.float32(1) / s32)
    return avg if avg is not None else torch.zeros((D, init_phi.shape[1]), device=dev)


def scores(zbar: np.ndarray, eta: np.ndarray, xi: float) -> np.ndarray:
    """Label probabilities Φ(z̄·ηᵀ − ξ), (D, L), in float32."""
    x = zbar.astype(np.float32) @ eta.astype(np.float32).T - np.float32(xi)
    return _phi(torch.from_numpy(x)).numpy()


def top_labels(probs: np.ndarray, labels: Sequence[str], n: int):
    """Each document's ``n`` labels of highest probability, highest first
    (ties broken by the label, the later first)."""
    return [[lab for _, lab in sorted(zip(row.tolist(), labels))[::-1][:n]] for row in probs]
