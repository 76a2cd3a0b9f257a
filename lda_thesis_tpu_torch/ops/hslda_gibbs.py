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

**Chains.**  Every function takes the state with an optional leading axis
of C independent chains over the same documents (the JAX package vmaps its
sweep over chains): ``z (C, D, N)``, ``n_dk (C, D, K)``, ``n_vk (C, V, K)``,
``n_k (C, K)``, ``η (C, L, K)``, ``a (C, D, L)``, ``α·β (C, K)`` and Gumbel
noise ``(N, C, D, K)``.  The sweep runs every chain at once: the chains'
documents lie side by side as C·D rows, chain c's tables are rows
``c·V + v`` of one stacked ``(C·V, K)`` table (flat index ``(c·V + v)·K +
k``) and ``c·K + k`` of the topic totals, and the coupling products are
batched matmuls.  A single chain is the C = 1 case of the same code; the
chain axis is added and dropped at the edges.  The batched matmuls may
round differently from C separate ones on a card, so a draw near a tie can
differ; ``chip_smoke.py`` measures the share of equal draws.

The op order follows the JAX function's, so the port's logits agree with it
to float32 rounding (the sums of a matmul and ``log_ndtr`` may differ in the
last bits).  The matmuls are IEEE float32: TF32 stays off
(``torch.backends.cuda.matmul.allow_tf32`` is False by default, and
``chip_smoke.py`` checks it), since M and the coupling carry exact count
ratios.  Counts are int32; every count update is a ``scatter_add_``, exact
in any order, so a CUDA-graph replay of the sweep equals the eager sweep bit
for bit.  :class:`HSLDASweep` holds one state's sweep and, on a card,
replays the sweep of all its chains as one CUDA graph.  Every op that draws
takes its noise as an optional input of the JAX draw's shape (Gumbel noise
``(N, D, K)`` for one chain); without it the noise comes from
``generator``: one ``torch.Generator``, or one per chain, each filling its
chain's noise as a single-chain run would draw it.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from .gibbs import capture_graph
from .sampling import gumbel, gumbel_argmax

__all__ = ["HSLDACounts", "hslda_init_counts", "hslda_z_sweep", "HSLDASweep", "L_BLOCK",
           "fill_gumbels"]

L_BLOCK = 64  # label block of the opt 2/3 blockwise coupling (at most L)

Generators = Optional[Union[torch.Generator, Sequence[torch.Generator]]]


class HSLDACounts(NamedTuple):
    """Instance-level count state (reference HSLDA.py:116-130), int32; with a
    leading chain axis where the state holds several chains."""

    z: torch.Tensor  # (D, N) or (C, D, N)
    n_dk: torch.Tensor  # (D, K) or (C, D, K)
    n_vk: torch.Tensor  # (V, K) or (C, V, K)
    n_k: torch.Tensor  # (K,) or (C, K)


def fill_gumbels(out: torch.Tensor, generator: Generators) -> torch.Tensor:
    """Fill ``out (N, C, …)`` with Gumbel noise: from one generator for the
    whole buffer, or, given one generator per chain, chain c's slice
    ``out[:, c]`` from generator c, with the numbers a single-chain buffer
    of that shape would get."""
    if generator is None or isinstance(generator, torch.Generator):
        return gumbel(out.shape, out.device, generator, out=out)
    if len(generator) != out.shape[1]:
        raise ValueError(f"{len(generator)} generators for {out.shape[1]} chains")
    for c, gen in enumerate(generator):
        dst = out[:, c]
        if dst.is_contiguous():
            gumbel(dst.shape, out.device, gen, out=dst)
        else:
            dst.copy_(gumbel(dst.shape, out.device, gen))
    return out


def _noise(shape, like: torch.Tensor, gumbels, generator: Generators) -> torch.Tensor:
    """Gumbel noise ``(N, C, D, K)``; ``gumbels`` may come without the chain
    axis when C = 1."""
    if gumbels is None:
        return fill_gumbels(torch.empty(shape, dtype=torch.float32, device=like.device),
                            generator)
    if gumbels.numel() != int(np.prod(shape)) or (
            tuple(gumbels.shape) != tuple(shape) and shape[1] != 1):
        single = (shape[0],) + tuple(shape[2:])
        raise ValueError(f"gumbels must have shape {tuple(shape)}"
                         + (f" or {single}" if shape[1] == 1 else "")
                         + f", got {tuple(gumbels.shape)}")
    return gumbels.to(device=like.device, dtype=torch.float32).reshape(shape)


def _table_counts(tok_v: torch.Tensor, mask: torch.Tensor, z: torch.Tensor, V: int,
                  K: int) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """``n_dk (C, D, K)``, ``n_vk (C, V, K)`` and ``n_k (C, K)`` of an
    assignment ``z (C, D, N)`` of the documents ``tok_v (D, N)``."""
    C, D, _ = z.shape
    m = mask.to(torch.int32).expand_as(z).contiguous()
    n_dk = torch.zeros((C, D, K), dtype=torch.int32, device=tok_v.device)
    n_dk.scatter_add_(2, z.long(), m)
    n_vk = torch.zeros((C, V, K), dtype=torch.int32, device=tok_v.device)
    rows = tok_v.long()[None] + V * torch.arange(C, device=tok_v.device)[:, None, None]
    n_vk.view(-1).scatter_add_(0, (rows * K + z.long()).reshape(-1), m.reshape(-1))
    return n_dk, n_vk, n_vk.sum(dim=1, dtype=torch.int32)


def hslda_init_counts(
    tok_v: torch.Tensor,  # (D, N) token instances
    mask: torch.Tensor,  # (D, N) 1 = real token
    theta: torch.Tensor,  # (D, K) or (C, D, K) initial doc-topic proportions
    V: int,
    gumbels: Optional[torch.Tensor] = None,  # (N, D, K) or (N, C, D, K)
    generator: Generators = None,
) -> HSLDACounts:
    """z ~ Categorical(θ_d) per instance and its counts (HSLDA.py:122-130).

    Every position draws from the same θ, so all positions are drawn at
    once: ``argmax(log θ + g_p)``, padding positions included (they count
    nothing), as the JAX scan draws them.  ``theta`` with a chain axis
    gives counts with one.
    """
    D, N = tok_v.shape
    single = theta.dim() == 2
    th = theta[None] if single else theta
    C, _, K = th.shape
    logits = torch.log(torch.clamp(th.to(torch.float32), min=1e-38))
    g = _noise((N, C, D, K), tok_v, gumbels, generator)
    z = torch.argmax(logits[None] + g, dim=3).permute(1, 2, 0).to(torch.int32)  # (C, D, N)
    n_dk, n_vk, n_k = _table_counts(tok_v, mask, z, V, K)
    out = HSLDACounts(z=z.contiguous(), n_dk=n_dk, n_vk=n_vk, n_k=n_k)
    return HSLDACounts(*(t[0] for t in out)) if single else out


class _Static(NamedTuple):
    """What a sweep over one corpus needs that no draw changes.  Rows are
    the C chains' documents side by side (row c·D + d)."""

    rows_t: torch.Tensor  # (N, C·D) int64, the word's row of the stacked table: c·V + v
    vK_t: torch.Tensor  # (N, C·D) int64, (c·V + v) · K
    m_t: torch.Tensor  # (N, C·D) int32 mask
    neg_m_t: torch.Tensor  # (N, C·D) int32
    mf_t: torch.Tensor  # (N, D, 1) float32 mask
    cK: Optional[torch.Tensor]  # (C·D,) int64, c · K (None for one chain)
    inv_nd: torch.Tensor  # (D, 1) float32
    labs: torch.Tensor  # (D, L) float32
    labs_p: torch.Tensor  # (D, Lp) float32, zero-padded for the blockwise form
    vgamma: float  # float32(V) · γ, rounded to float32
    C: int
    D: int
    L: int
    Lp: int
    L_BLOCK: int


def _static(tok_v, mask, labs, V: int, K: int, gamma: float, C: int = 1,
            rows: Optional[int] = None) -> _Static:
    """``V`` is the true vocabulary size of the ``V·γ`` denominator; ``rows``
    the table's row count (V, or the padded V of a vocab-sharded run)."""
    D, N = tok_v.shape
    rows = int(V if rows is None else rows)
    dev = tok_v.device
    chain = torch.arange(C, device=dev).repeat_interleave(D)  # (C·D,)
    rows_t = (tok_v.T.long().repeat(1, C) + rows * chain[None]).contiguous()
    m_t = mask.T.to(torch.int32).repeat(1, C).contiguous()
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    labs = labs.to(torch.float32).contiguous()
    L = labs.shape[1]
    lb = min(L_BLOCK, L)
    Lp = ((L + lb - 1) // lb) * lb
    return _Static(
        rows_t=rows_t, vK_t=rows_t * K, m_t=m_t, neg_m_t=-m_t,
        mf_t=mask.T.to(torch.float32)[:, :, None].contiguous(),
        cK=(chain * K).contiguous() if C > 1 else None,
        inv_nd=(1.0 / n_d)[:, None].contiguous(), labs=labs,
        labs_p=torch.nn.functional.pad(labs, (0, Lp - L)).contiguous(),
        vgamma=float(np.float32(V) * np.float32(gamma)), C=int(C), D=int(D), L=L, Lp=Lp,
        L_BLOCK=lb)


def _log_ndtr(x: torch.Tensor) -> torch.Tensor:
    """log Φ(x), stable in the left tail."""
    return torch.special.log_ndtr(x)


def _sweep_(st: _Static, z_t, n_dk, n_vk, n_k, M, eta, a, alpha_beta, g, gamma: float,
            xi: float, opt: int, lab_pos_ids=None, lab_pos_valid=None) -> None:
    """One z-sweep of every chain in place: ``z_t (N, C·D)`` and the int32
    counts ``n_dk (C, D, K)``, ``n_vk (C, V, K)``, ``n_k (C, K)`` updated,
    ``M (C, D, Lp)`` left holding z̄ @ ηᵀ of the new state; ``η (C, L, K)``,
    ``a (C, D, L)``, ``α·β (C, K)``, noise ``g (N, C, D, K)``.  No host
    sync, no branch on a tensor's value: a card can capture it as one CUDA
    graph."""
    C, D, K = n_dk.shape
    inv_nd = st.inv_nd
    sparse2 = opt == 2 and lab_pos_ids is not None
    if opt == 1:
        T2 = (st.labs @ (eta * eta)) * (0.5 * inv_nd * inv_nd)  # (C, D, K)
        labs = st.labs
    elif sparse2:
        eta_pos = eta[:, lab_pos_ids]  # (C, D, A, K), hoisted
        pos_valid = lab_pos_valid[:, :, None]  # (D, A, 1)
        pos_ids = lab_pos_ids.expand(C, -1, -1).contiguous()  # (C, D, A)
    else:
        eta = torch.nn.functional.pad(eta, (0, 0, 0, st.Lp - st.L))
        labs = st.labs_p
    etaT = eta.transpose(1, 2).reshape(C * K, -1)  # (C·K, Lp): row c·K + k is η_c[:, k]
    M.copy_((n_dk.to(torch.float32) @ eta.transpose(1, 2)) * inv_nd)
    flat = n_vk.view(-1)
    table = n_vk.view(-1, K)  # (C·V, K)
    n_k_flat = n_k.view(-1)
    n_dk_rows = n_dk.view(C * D, K)
    ab = alpha_beta[:, None, :]
    inv_nd3 = inv_nd[:, :, None]
    for p in range(st.rows_t.shape[0]):
        rows, mf = st.rows_t[p], st.mf_t[p]
        m, neg_m = st.m_t[p], st.neg_m_t[p]
        z_old = z_t[p].long()
        zk_old = z_old if st.cK is None else st.cK + z_old  # row of the stacked n_k / ηᵀ

        # decrement
        n_dk_rows.scatter_add_(1, z_old[:, None], neg_m[:, None])
        n_k_flat.scatter_add_(0, zk_old, neg_m)
        flat.scatter_add_(0, st.vK_t[p] + z_old, neg_m)
        M.sub_(etaT.index_select(0, zk_old).view(C, D, -1) * inv_nd * mf)

        # p1: collapsed-LDA part with the HDP-style αβ prior (HSLDA.py:240-243)
        logp1 = (torch.log(n_dk.to(torch.float32) + ab)
                 + torch.log(table.index_select(0, rows).to(torch.float32).view(C, D, K)
                             + gamma)
                 - torch.log(n_k.to(torch.float32) + st.vgamma)[:, None, :])

        # p2: probit coupling (HSLDA.py:245-261)
        if opt == 1:
            Cm = (M - a) * labs  # (C, D, L), zero on negative labels
            logp2 = -((Cm @ eta) * inv_nd + T2)
        elif sparse2:
            mk = M.gather(2, pos_ids)[..., None] + eta_pos * inv_nd3 - xi  # (C, D, A, K)
            logp2 = (pos_valid * _log_ndtr(mk)).sum(dim=2)
        else:
            lb = st.L_BLOCK
            logp2 = torch.zeros((C, D, K), dtype=torch.float32, device=M.device)
            for s in range(0, st.Lp, lb):
                mk = M[:, :, s:s + lb, None] + eta[:, None, s:s + lb, :] * inv_nd3 - xi
                if opt == 2:
                    logp2 = logp2 + (labs[:, s:s + lb, None] * _log_ndtr(mk)).sum(dim=2)
                else:  # opt == 3
                    signed = torch.where(labs[:, s:s + lb, None] > 0, mk, -mk)
                    logp2 = logp2 + _log_ndtr(signed).sum(dim=2)

        z_new = gumbel_argmax((logp1 + logp2).view(C * D, K), 1, gumbels=g[p].view(C * D, K))
        z_new = torch.where(m > 0, z_new, z_old)
        zk_new = z_new if st.cK is None else st.cK + z_new

        # increment
        n_dk_rows.scatter_add_(1, z_new[:, None], m[:, None])
        n_k_flat.scatter_add_(0, zk_new, m)
        flat.scatter_add_(0, st.vK_t[p] + z_new, m)
        M.add_(etaT.index_select(0, zk_new).view(C, D, -1) * inv_nd * mf)
        z_t[p].copy_(z_new)


def _m_width(st: _Static, opt: int, sparse2: bool) -> int:
    """Columns of M: the label axis, zero-padded for the blockwise forms."""
    if opt not in (1, 2, 3):
        raise ValueError(f"opt must be 1, 2 or 3, got {opt}")
    return st.L if opt == 1 or sparse2 else st.Lp


def _chains(x: torch.Tensor, single: bool) -> torch.Tensor:
    return x[None] if single else x


def hslda_z_sweep(
    counts: HSLDACounts,
    tok_v: torch.Tensor,  # (D, N)
    mask: torch.Tensor,  # (D, N)
    labs: torch.Tensor,  # (D, L) float binary
    eta: torch.Tensor,  # (L, K) or (C, L, K)
    a: torch.Tensor,  # (D, L) or (C, D, L) probit auxiliaries
    alpha_beta: torch.Tensor,  # (K,) or (C, K) α·β vector
    gamma: float,
    xi: float,
    opt: int = 1,
    lab_pos_ids: Optional[torch.Tensor] = None,  # (D, A) positive-label ids
    lab_pos_valid: Optional[torch.Tensor] = None,  # (D, A) 1/0
    V: Optional[int] = None,
    gumbels: Optional[torch.Tensor] = None,  # (N, D, K) or (N, C, D, K)
    generator: Generators = None,
) -> Tuple[HSLDACounts, torch.Tensor]:
    """One full z-sweep; returns (new counts, ``M = z̄ @ ηᵀ`` of shape (D, L),
    or (C, D, L) for counts with a chain axis).

    ``V`` is the true vocabulary size of the ``V·γ`` smoothing denominator
    (reference HSLDA.py:243); it defaults to the table's row count.  ``opt``
    selects the coupling (reference HSLDA.py:240-261): 1 — Gaussian kernel on
    positive labels, 2 — Φ(m−ξ) on positive labels (compact when
    ``lab_pos_ids``/``lab_pos_valid`` are given, else label-blockwise), 3 —
    Φ(±(m−ξ)) on all labels.  The input counts are not modified.
    """
    D, N = tok_v.shape
    single = counts.n_dk.dim() == 2
    n_dk, n_vk, n_k = (_chains(t, single).to(torch.int32).clone()
                       for t in counts[1:])
    C, rows, K = n_vk.shape
    V = rows if V is None else int(V)
    st = _static(tok_v, mask, labs, V, K, gamma, C, rows)
    g = _noise((N, C, D, K), tok_v, gumbels, generator)
    z_t = _chains(counts.z, single).permute(2, 0, 1).reshape(N, C * D).to(torch.int32)
    z_t = z_t.contiguous()
    M = torch.empty((C, D, _m_width(st, opt, opt == 2 and lab_pos_ids is not None)),
                    dtype=torch.float32, device=tok_v.device)
    ids = None if lab_pos_ids is None else lab_pos_ids.long()
    valid = None if lab_pos_valid is None else lab_pos_valid.to(torch.float32)
    _sweep_(st, z_t, n_dk, n_vk, n_k, M, _chains(eta, single).to(torch.float32),
            _chains(a, single).to(torch.float32),
            _chains(alpha_beta, single).to(torch.float32), g, float(gamma), float(xi),
            int(opt), ids, valid)
    z = z_t.view(N, C, D).permute(1, 2, 0).contiguous()
    new = HSLDACounts(z=z, n_dk=n_dk, n_vk=n_vk, n_k=n_k)
    M = M[..., :st.L]
    if single:
        return HSLDACounts(*(t[0] for t in new)), M[0]
    return new, M


class HSLDASweep:
    """Repeated z-sweeps (:func:`hslda_z_sweep`) over one state's tensors
    ``z_t (N, C·D)`` (position-major, the chains' documents side by side),
    ``n_dk (C, D, K)``, ``n_vk (C, V, K)``, ``n_k (C, K)``, which every call
    updates in place; a single chain's ``(D, K)``, ``(V, K)``, ``(K,)``
    tensors and ``z_t (N, D)`` are taken as C = 1 views.

    Each call copies η, a and α·β into static buffers and fills a static
    ``(N, C, D, K)`` Gumbel buffer, from the generator (or one generator per
    chain, each filling its chain's slice as a single-chain sweep draws it)
    or from the given ``gumbels``, outside any graph and in the eager order.
    On a card the first call runs eagerly, the second captures the sweep of
    every chain as one CUDA graph and every later call replays it: no host
    work per position.  On the CPU every call runs eagerly.  ``M`` holds
    z̄ @ ηᵀ after each sweep.  ``V`` is the true vocabulary size; the table
    may have more rows (a vocab-sharded run pads it).
    """

    def __init__(self, z_t, n_dk, n_vk, n_k, tok_v, mask, labs, gamma: float, xi: float,
                 opt: int, V: int, lab_pos_ids=None, lab_pos_valid=None):
        D, N = tok_v.shape
        self.single = n_dk.dim() == 2
        n_dk, n_vk, n_k = (_chains(t, self.single) for t in (n_dk, n_vk, n_k))
        C, K = n_dk.shape[0], n_dk.shape[2]
        L = labs.shape[1]
        device = n_dk.device
        if tuple(z_t.shape) != (N, C * D):
            raise ValueError(f"z_t must have shape {(N, C * D)}, got {tuple(z_t.shape)}")
        self.state = (z_t, n_dk, n_vk, n_k)
        self._st = _static(tok_v, mask, labs, V, K, gamma, C, n_vk.shape[1])
        self.opt, self.gamma, self.xi = int(opt), float(gamma), float(xi)
        self.sparse2 = self.opt == 2 and lab_pos_ids is not None
        self.ids = None if lab_pos_ids is None else lab_pos_ids.long().contiguous()
        self.valid = None if lab_pos_valid is None else lab_pos_valid.to(torch.float32)
        self.eta = torch.empty((C, L, K), dtype=torch.float32, device=device)
        self.a = torch.empty((C, D, L), dtype=torch.float32, device=device)
        self.ab = torch.empty((C, K), dtype=torch.float32, device=device)
        self.g = torch.empty((N, C, D, K), dtype=torch.float32, device=device)
        self._M = torch.empty((C, D, _m_width(self._st, self.opt, self.sparse2)),
                              dtype=torch.float32, device=device)
        self._graphed = device.type == "cuda"
        self._graph = None
        self.sweeps = 0

    @property
    def M(self) -> torch.Tensor:
        M = self._M[..., :self._st.L]
        return M[0] if self.single else M

    def _sweep(self) -> None:
        _sweep_(self._st, *self.state, self._M, self.eta, self.a, self.ab, self.g, self.gamma,
                self.xi, self.opt, self.ids, self.valid)

    def _capture(self) -> None:
        self._graph = capture_graph(self._sweep, self.g.device)

    def __call__(self, eta, a, alpha_beta, generator: Generators = None,
                 gumbels: Optional[torch.Tensor] = None) -> None:
        """One sweep of every chain with these η (C, L, K), a (C, D, L) and
        α·β (C, K) (a single chain's without the chain axis)."""
        self.eta.copy_(eta.reshape(self.eta.shape))
        self.a.copy_(a.reshape(self.a.shape))
        self.ab.copy_(alpha_beta.reshape(self.ab.shape))
        if gumbels is None:
            fill_gumbels(self.g, generator)
        else:
            self.g.copy_(_noise(self.g.shape, self.g, gumbels, None))
        if not self._graphed or self.sweeps == 0:
            self._sweep()
        else:
            if self._graph is None:
                self._capture()
            self._graph.replay()
        self.sweeps += 1
