"""HSLDA's blocked-Gibbs z-sweep, on tensors.

Counterpart of ``lda_thesis_tpu/ops/hslda_gibbs.py``: the init draw and the
token-instance z-sweep of Perotte '11, Eq. (1) (reference ``sample_z``,
HSLDA.py:171-272), with the probit coupling ``p2`` that links each token's
topic to its document's label auxiliaries ``a``.

The sweep visits the N instance positions in order; at each one all D
documents decrement, draw and increment at once, as the JAX ``lax.scan``
does.  ``M[d, l] = <z̄_d, η_l>`` is kept incrementally through the sweep.
The coupling in log space, k-independent terms dropped:

* opt 1: ``-( ((labs ⊙ (M − a)) @ η) / n_d + (labs @ η²) / (2 n_d²) )``,
  the second term hoisted out of the sweep;
* opt 2: ``Σ_l labs · log Φ(m_k − ξ)`` with ``m_k = M + η_k / n_d``, on each
  document's positive labels (``lab_pos_ids``/``lab_pos_valid``) or, without
  them, label-blockwise as opt 3;
* opt 3: ``Σ_l log Φ(±(m_k − ξ))`` over all labels, in blocks of
  ``min(64, L)`` labels with the label axis zero-padded, summed block by
  block in the JAX function's order.

The op order follows the JAX function's, so the port's logits agree with it
to float32 rounding (the sums of a matmul and ``log_ndtr`` may differ in the
last bits).  Counts are int32; every count update is a ``scatter_add_``,
exact in any order, so a CUDA-graph replay of the sweep equals the eager
sweep bit for bit.  :class:`HSLDASweep` holds one model's sweep state and,
on a card, replays the sweep as one CUDA graph.  Every op that draws takes
its noise as an optional input of the JAX draw's shape (Gumbel noise
``(N, D, K)``); without it the noise comes from ``generator``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from .sampling import gumbel, gumbel_argmax

__all__ = ["HSLDACounts", "hslda_init_counts", "hslda_z_sweep", "HSLDASweep", "L_BLOCK"]

L_BLOCK = 64  # label block of the opt 2/3 blockwise coupling (at most L)


class HSLDACounts(NamedTuple):
    """Instance-level count state (reference HSLDA.py:116-130), int32."""

    z: torch.Tensor  # (D, N)
    n_dk: torch.Tensor  # (D, K)
    n_vk: torch.Tensor  # (V, K)
    n_k: torch.Tensor  # (K,)


def _noise(shape, like: torch.Tensor, gumbels, generator) -> torch.Tensor:
    if gumbels is None:
        return gumbel(shape, like.device, generator)
    if tuple(gumbels.shape) != tuple(shape):
        raise ValueError(f"gumbels must have shape {tuple(shape)}, "
                         f"got {tuple(gumbels.shape)}")
    return gumbels.to(device=like.device, dtype=torch.float32)


def _table_counts(tok_v: torch.Tensor, mask: torch.Tensor, z: torch.Tensor, V: int,
                  K: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_dk (D, K)``, ``n_vk (V, K)`` and ``n_k (K,)`` of an assignment."""
    D = tok_v.shape[0]
    m = mask.to(torch.int32)
    n_dk = torch.zeros((D, K), dtype=torch.int32, device=tok_v.device)
    n_dk.scatter_add_(1, z.long(), m)
    n_vk = torch.zeros((V, K), dtype=torch.int32, device=tok_v.device)
    n_vk.view(-1).scatter_add_(0, (tok_v.long() * K + z.long()).reshape(-1), m.reshape(-1))
    return n_dk, n_vk, n_vk.sum(dim=0, dtype=torch.int32)


def hslda_init_counts(
    tok_v: torch.Tensor,  # (D, N) token instances
    mask: torch.Tensor,  # (D, N) 1 = real token
    theta: torch.Tensor,  # (D, K) initial doc-topic proportions (θ ~ Dir(αβ))
    V: int,
    gumbels: Optional[torch.Tensor] = None,  # (N, D, K)
    generator: Optional[torch.Generator] = None,
) -> HSLDACounts:
    """z ~ Categorical(θ_d) per instance and its counts (HSLDA.py:122-130).

    Every position draws from the same θ, so all positions are drawn at
    once: ``argmax(log θ + g_p)``, padding positions included (they count
    nothing), as the JAX scan draws them.
    """
    D, N = tok_v.shape
    K = theta.shape[1]
    logits = torch.log(torch.clamp(theta.to(torch.float32), min=1e-38))
    g = _noise((N, D, K), tok_v, gumbels, generator)
    z = torch.argmax(logits[None] + g, dim=2).T.to(torch.int32)  # (D, N)
    n_dk, n_vk, n_k = _table_counts(tok_v, mask, z, V, K)
    return HSLDACounts(z=z.contiguous(), n_dk=n_dk, n_vk=n_vk, n_k=n_k)


class _Static(NamedTuple):
    """What a sweep over one corpus needs that no draw changes."""

    tok_v_t: torch.Tensor  # (N, D) int64
    vK_t: torch.Tensor  # (N, D) int64, word · K
    m_t: torch.Tensor  # (N, D) int32 mask
    neg_m_t: torch.Tensor  # (N, D) int32
    mf_t: torch.Tensor  # (N, D, 1) float32 mask
    inv_nd: torch.Tensor  # (D, 1) float32
    labs: torch.Tensor  # (D, L) float32
    labs_p: torch.Tensor  # (D, Lp) float32, zero-padded for the blockwise form
    vgamma: float  # float32(V) · γ, rounded to float32
    L: int
    Lp: int
    L_BLOCK: int


def _static(tok_v, mask, labs, V: int, K: int, gamma: float) -> _Static:
    tok_v_t = tok_v.T.long().contiguous()
    m_t = mask.T.to(torch.int32).contiguous()
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    labs = labs.to(torch.float32).contiguous()
    L = labs.shape[1]
    lb = min(L_BLOCK, L)
    Lp = ((L + lb - 1) // lb) * lb
    return _Static(
        tok_v_t=tok_v_t, vK_t=tok_v_t * K, m_t=m_t, neg_m_t=-m_t,
        mf_t=m_t.to(torch.float32)[:, :, None].contiguous(),
        inv_nd=(1.0 / n_d)[:, None].contiguous(), labs=labs,
        labs_p=torch.nn.functional.pad(labs, (0, Lp - L)).contiguous(),
        vgamma=float(np.float32(V) * np.float32(gamma)), L=L, Lp=Lp, L_BLOCK=lb)


def _log_ndtr(x: torch.Tensor) -> torch.Tensor:
    """log Φ(x), stable in the left tail."""
    return torch.special.log_ndtr(x)


def _sweep_(st: _Static, z_t, n_dk, n_vk, n_k, M, eta, a, alpha_beta, g, gamma: float,
            xi: float, opt: int, lab_pos_ids=None, lab_pos_valid=None) -> None:
    """One z-sweep in place: ``z_t (N, D)`` and the int32 counts updated,
    ``M (D, Lp)`` left holding z̄ @ ηᵀ of the new state.  No host sync, no
    branch on a tensor's value: a card can capture it as one CUDA graph."""
    K = n_dk.shape[1]
    inv_nd = st.inv_nd
    sparse2 = opt == 2 and lab_pos_ids is not None
    if opt == 1:
        T2 = (st.labs @ (eta * eta)) * (0.5 * inv_nd * inv_nd)  # (D, K)
        labs = st.labs
    elif sparse2:
        eta_pos = eta[lab_pos_ids]  # (D, A, K), hoisted
        pos_valid = lab_pos_valid[:, :, None]  # (D, A, 1)
    else:
        eta = torch.nn.functional.pad(eta, (0, 0, 0, st.Lp - st.L))
        labs = st.labs_p
    etaT = eta.T.contiguous()  # (K, Lp)
    M.copy_((n_dk.to(torch.float32) @ eta.T) * inv_nd)
    flat = n_vk.view(-1)
    inv_nd3 = inv_nd[:, :, None]
    for p in range(st.tok_v_t.shape[0]):
        v, mf = st.tok_v_t[p], st.mf_t[p]
        m, neg_m = st.m_t[p], st.neg_m_t[p]
        z_old = z_t[p].long()

        # decrement
        n_dk.scatter_add_(1, z_old[:, None], neg_m[:, None])
        n_k.scatter_add_(0, z_old, neg_m)
        flat.scatter_add_(0, st.vK_t[p] + z_old, neg_m)
        M.sub_(etaT.index_select(0, z_old) * inv_nd * mf)

        # p1: collapsed-LDA part with the HDP-style αβ prior (HSLDA.py:240-243)
        logp1 = (torch.log(n_dk.to(torch.float32) + alpha_beta[None, :])
                 + torch.log(n_vk.index_select(0, v).to(torch.float32) + gamma)
                 - torch.log(n_k.to(torch.float32) + st.vgamma))

        # p2: probit coupling (HSLDA.py:245-261)
        if opt == 1:
            C = (M - a) * labs  # (D, L), zero on negative labels
            logp2 = -((C @ eta) * inv_nd + T2)
        elif sparse2:
            mk = M.gather(1, lab_pos_ids)[:, :, None] + eta_pos * inv_nd3 - xi  # (D, A, K)
            logp2 = (pos_valid * _log_ndtr(mk)).sum(dim=1)
        else:
            lb = st.L_BLOCK
            logp2 = torch.zeros((n_dk.shape[0], K), dtype=torch.float32, device=M.device)
            for s in range(0, st.Lp, lb):
                mk = M[:, s:s + lb, None] + eta[None, s:s + lb, :] * inv_nd3 - xi
                if opt == 2:
                    logp2 = logp2 + (labs[:, s:s + lb, None] * _log_ndtr(mk)).sum(dim=1)
                else:  # opt == 3
                    signed = torch.where(labs[:, s:s + lb, None] > 0, mk, -mk)
                    logp2 = logp2 + _log_ndtr(signed).sum(dim=1)

        z_new = gumbel_argmax(logp1 + logp2, 1, gumbels=g[p])
        z_new = torch.where(m > 0, z_new, z_old)

        # increment
        n_dk.scatter_add_(1, z_new[:, None], m[:, None])
        n_k.scatter_add_(0, z_new, m)
        flat.scatter_add_(0, st.vK_t[p] + z_new, m)
        M.add_(etaT.index_select(0, z_new) * inv_nd * mf)
        z_t[p].copy_(z_new)


def _m_width(st: _Static, opt: int, sparse2: bool) -> int:
    """Columns of M: the label axis, zero-padded for the blockwise forms."""
    if opt not in (1, 2, 3):
        raise ValueError(f"opt must be 1, 2 or 3, got {opt}")
    return st.L if opt == 1 or sparse2 else st.Lp


def hslda_z_sweep(
    counts: HSLDACounts,
    tok_v: torch.Tensor,  # (D, N)
    mask: torch.Tensor,  # (D, N)
    labs: torch.Tensor,  # (D, L) float binary
    eta: torch.Tensor,  # (L, K)
    a: torch.Tensor,  # (D, L) probit auxiliaries
    alpha_beta: torch.Tensor,  # (K,) α·β vector
    gamma: float,
    xi: float,
    opt: int = 1,
    lab_pos_ids: Optional[torch.Tensor] = None,  # (D, A) positive-label ids
    lab_pos_valid: Optional[torch.Tensor] = None,  # (D, A) 1/0
    V: Optional[int] = None,
    gumbels: Optional[torch.Tensor] = None,  # (N, D, K)
    generator: Optional[torch.Generator] = None,
) -> Tuple[HSLDACounts, torch.Tensor]:
    """One full z-sweep; returns (new counts, ``M = z̄ @ ηᵀ`` of shape (D, L)).

    ``V`` is the true vocabulary size of the ``V·γ`` smoothing denominator
    (reference HSLDA.py:243); it defaults to the table's row count.  ``opt``
    selects the coupling (reference HSLDA.py:240-261): 1 — Gaussian kernel on
    positive labels, 2 — Φ(m−ξ) on positive labels (compact when
    ``lab_pos_ids``/``lab_pos_valid`` are given, else label-blockwise), 3 —
    Φ(±(m−ξ)) on all labels.  The input counts are not modified.
    """
    D, N = tok_v.shape
    K = counts.n_dk.shape[1]
    V = counts.n_vk.shape[0] if V is None else int(V)
    st = _static(tok_v, mask, labs, V, K, gamma)
    g = _noise((N, D, K), tok_v, gumbels, generator)
    z_t = counts.z.T.to(torch.int32).contiguous()
    n_dk, n_vk, n_k = (counts.n_dk.to(torch.int32).clone(), counts.n_vk.to(torch.int32).clone(),
                       counts.n_k.to(torch.int32).clone())
    M = torch.empty((D, _m_width(st, opt, opt == 2 and lab_pos_ids is not None)),
                    dtype=torch.float32, device=tok_v.device)
    ids = None if lab_pos_ids is None else lab_pos_ids.long()
    valid = None if lab_pos_valid is None else lab_pos_valid.to(torch.float32)
    _sweep_(st, z_t, n_dk, n_vk, n_k, M, eta.to(torch.float32), a.to(torch.float32),
            alpha_beta.to(torch.float32), g, float(gamma), float(xi), int(opt), ids, valid)
    new = HSLDACounts(z=z_t.T.contiguous(), n_dk=n_dk, n_vk=n_vk, n_k=n_k)
    return new, M[:, :st.L]


class HSLDASweep:
    """Repeated z-sweeps (:func:`hslda_z_sweep`) over one model's state
    tensors ``z_t (N, D)``, ``n_dk``, ``n_vk``, ``n_k``, which every call
    updates in place.

    Each call copies η, a and α·β into static buffers and fills a static
    ``(N, D, K)`` Gumbel buffer, from ``generator`` or from the given
    ``gumbels``, outside any graph and in the eager order.  On a card the
    first call runs eagerly, the second captures the sweep as one CUDA graph
    and every later call replays it: no host work per position.  On the CPU
    every call runs eagerly.  ``M`` holds z̄ @ ηᵀ after each sweep.
    """

    def __init__(self, z_t, n_dk, n_vk, n_k, tok_v, mask, labs, gamma: float, xi: float,
                 opt: int, V: int, lab_pos_ids=None, lab_pos_valid=None):
        D, N = tok_v.shape
        K = n_dk.shape[1]
        L = labs.shape[1]
        device = n_dk.device
        self.state = (z_t, n_dk, n_vk, n_k)
        self._st = _static(tok_v, mask, labs, V, K, gamma)
        self.opt, self.gamma, self.xi = int(opt), float(gamma), float(xi)
        self.sparse2 = self.opt == 2 and lab_pos_ids is not None
        self.ids = None if lab_pos_ids is None else lab_pos_ids.long().contiguous()
        self.valid = None if lab_pos_valid is None else lab_pos_valid.to(torch.float32)
        self.eta = torch.empty((L, K), dtype=torch.float32, device=device)
        self.a = torch.empty((D, L), dtype=torch.float32, device=device)
        self.ab = torch.empty((K,), dtype=torch.float32, device=device)
        self.g = torch.empty((N, D, K), dtype=torch.float32, device=device)
        self._M = torch.empty((D, _m_width(self._st, self.opt, self.sparse2)),
                              dtype=torch.float32, device=device)
        self._graphed = device.type == "cuda"
        self._graph = None
        self.sweeps = 0

    @property
    def M(self) -> torch.Tensor:
        return self._M[:, :self._st.L]

    def _sweep(self) -> None:
        _sweep_(self._st, *self.state, self._M, self.eta, self.a, self.ab, self.g, self.gamma,
                self.xi, self.opt, self.ids, self.valid)

    def _capture(self) -> None:
        device = self.g.device
        graph = torch.cuda.CUDAGraph()
        stream = torch.cuda.Stream(device)
        stream.wait_stream(torch.cuda.current_stream(device))
        with torch.cuda.stream(stream):
            graph.capture_begin()
            try:
                self._sweep()
            finally:
                graph.capture_end()
        torch.cuda.current_stream(device).wait_stream(stream)
        self._graph = graph

    def __call__(self, eta, a, alpha_beta, generator: Optional[torch.Generator] = None,
                 gumbels: Optional[torch.Tensor] = None) -> None:
        """One sweep with these η (L, K), a (D, L) and α·β (K,)."""
        self.eta.copy_(eta)
        self.a.copy_(a)
        self.ab.copy_(alpha_beta)
        if gumbels is None:
            gumbel(self.g.shape, self.g.device, generator, out=self.g)
        else:
            self.g.copy_(gumbels)
        if not self._graphed or self.sweeps == 0:
            self._sweep()
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
        self.sweeps += 1
