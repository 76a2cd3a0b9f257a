"""AD-LDA collapsed Gibbs over a ``(chains, data)`` mesh of ranks.

Counterpart of ``lda_thesis_tpu/parallel/sharded.py``.  Rank ``r`` is mesh
cell ``(ci, di) = divmod(r, n_data)`` (:class:`.bootstrap.Mesh`) and holds:

* ``z (L, D_s, U)`` / ``n_dk (L, D_s, K)`` for its ``L = n_chains //
  mesh_chains`` local chains over its shard of ``D_s = D_p / n_data``
  documents (the document axis padded to ``D_p``, a multiple of
  ``n_data``, with no-op rows);
* ``n_vk (L, V, K)`` / ``n_k (L, K)``: each local chain's full replica of
  its topic-word table.

One training step: the rank's local chains run the port's exact sweep
together (one :class:`..ops.gibbs.ExactSweep` over a leading chain axis:
one draw-update and one commit launch per position for all chains, one
CUDA graph per rank on a card), each chain over the rank's shard against
its own replica, then the shards' table deltas are summed over the data
row (``all_reduce``), which
restores the exact global table (AD-LDA, Newman et al. 2009).  A save folds
every chain's φ and θ into the thinned means at once, through one
``ops/gibbs.SaveStep`` per rank (one replayed CUDA graph on a card).  Counts are
float32 holding integers below 2^24, so the sum is exact in any order and
on any backend, and every replica of a row stays bitwise identical.

**Random streams.**  Global chain ``g = ci·L + j`` on data shard ``di``
draws from its own ``torch.Generator`` on the rank's device, seeded with
:func:`chain_seed` ``(seed, g, di) = (seed·2^32 + g·2^16 + di) mod 2^63``;
each generator's draws come in a fixed order (the init, then block by
block, bucket by bucket), and checkpoints save every generator's state.
The fold-in test draws from one more generator, seeded with
``(seed·2^32 + 2^32 − 1) mod 2^63``, the same on every rank.  Every op
that draws also takes its uniforms as an input.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..models.state import theta_from_counts
from ..ops.gibbs import ExactSweep, SaveStep, init_counts
from .bootstrap import Mesh, make_global_mesh

__all__ = [
    "ShardedLDAState",
    "ShardedCorpus",
    "make_mesh",
    "chain_seed",
    "make_generators",
    "shard_corpus",
    "init_sharded_state",
    "make_sharded_train_step",
    "ShardedTrainStep",
    "gather_chains",
    "pooled_phi",
]


class ShardedLDAState(NamedTuple):
    """This rank's multi-chain dense Gibbs state (leading axis: local chains)."""

    z: torch.Tensor  # (L, D_s, U) int32
    n_dk: torch.Tensor  # (L, D_s, K) float32
    n_vk: torch.Tensor  # (L, V, K) float32
    n_k: torch.Tensor  # (L, K) float32
    ph_hat: torch.Tensor  # (L, V, K) thinned running mean
    th_hat: torch.Tensor  # (L, D_s, K)
    s: int  # saves folded into the means


class ShardedCorpus(NamedTuple):
    """This rank's shard of the dense corpus."""

    tok_v: torch.Tensor  # (D_s, U) int64
    tok_f: torch.Tensor  # (D_s, U) int64
    labs: torch.Tensor  # (D_s, K) float32


def make_mesh(n_data: Optional[int] = None, n_chains: int = 1, device=None) -> Mesh:
    """``(chains, data)`` mesh over the process group's ranks (one rank
    without a group); see :func:`.bootstrap.make_global_mesh`."""
    return make_global_mesh(n_chains=n_chains, n_data=n_data, device=device)


def chain_seed(seed: int, g: int, di: int) -> int:
    """Seed of global chain ``g`` on data shard ``di``."""
    return (int(seed) * 2**32 + int(g) * 2**16 + int(di)) % 2**63


def fold_in_seed(seed: int) -> int:
    """Seed of the fold-in test's generator (the same on every rank)."""
    return (int(seed) * 2**32 + 2**32 - 1) % 2**63


def local_chains(mesh: Mesh, n_chains: int):
    """``(L, g0)``: this rank's chain count and first global chain."""
    L = int(n_chains) // mesh.shape["chains"]
    return L, mesh.coords[0] * L


def make_generators(mesh: Mesh, n_chains: int, seed: int) -> List[torch.Generator]:
    """One generator per local chain, seeded by :func:`chain_seed`."""
    L, g0 = local_chains(mesh, n_chains)
    gens = []
    for j in range(L):
        gen = torch.Generator(device=mesh.device)
        gen.manual_seed(chain_seed(seed, g0 + j, mesh.coords[1]))
        gens.append(gen)
    return gens


def padded(n: int, parts: int) -> int:
    return -(-int(n) // int(parts)) * int(parts)


def shard_rows(x: np.ndarray, mesh: Mesh, axis: int = 0, root_col: bool = False) -> np.ndarray:
    """This rank's slice of ``x`` along ``axis`` after padding that axis to a
    multiple of the data-mesh size (pad rows zero; with ``root_col`` a
    padded row's first column is 1, so a label mask keeps the root)."""
    S, di = mesh.shape["data"], mesh.coords[1]
    x = np.asarray(x)
    n = x.shape[axis]
    target = padded(n, S)
    if target != n:
        widths = [(0, 0)] * x.ndim
        widths[axis] = (0, target - n)
        x = np.pad(x, widths)
        if root_col:
            idx = [slice(None)] * x.ndim
            idx[axis] = slice(n, target)
            idx[1 - axis] = 0
            x[tuple(idx)] = 1
    step = target // S
    idx = [slice(None)] * x.ndim
    idx[axis] = slice(di * step, (di + 1) * step)
    return np.ascontiguousarray(x[tuple(idx)])


def shard_corpus(mesh: Mesh, tok_v, tok_f, labs) -> ShardedCorpus:
    """Pad the document axis to the data-mesh size and keep this rank's
    shard, on its device."""
    dev = mesh.device
    return ShardedCorpus(
        tok_v=torch.as_tensor(shard_rows(tok_v, mesh), dtype=torch.int64, device=dev),
        tok_f=torch.as_tensor(shard_rows(tok_f, mesh), dtype=torch.int64, device=dev),
        labs=torch.as_tensor(shard_rows(np.asarray(labs, np.float32), mesh, root_col=True),
                             dtype=torch.float32, device=dev))


def init_sharded_state(mesh: Mesh, corpus: ShardedCorpus, V: int, n_chains: int,
                       generators: Sequence[torch.Generator],
                       uniforms: Optional[Sequence[torch.Tensor]] = None) -> ShardedLDAState:
    """Per-(chain, shard) init (reference LabeledLDA.py:69-92): each local
    chain draws its shard's z from its generator (or ``uniforms[j] (U,
    D_s)``); the shards' tables are summed over the data row."""
    zs, ndks, nvks, nks = [], [], [], []
    for j, gen in enumerate(generators):
        c = init_counts(corpus.tok_v, corpus.tok_f, corpus.labs, V,
                        uniforms=None if uniforms is None else uniforms[j],
                        generator=gen)
        zs.append(c.z)
        ndks.append(c.n_dk)
        nvks.append(c.n_vk)
        nks.append(c.n_k)
    n_vk = mesh.data_sum_(torch.stack(nvks))
    n_k = mesh.data_sum_(torch.stack(nks))
    L, D_s = len(zs), corpus.tok_v.shape[0]
    K = corpus.labs.shape[1]
    return ShardedLDAState(
        z=torch.stack(zs), n_dk=torch.stack(ndks), n_vk=n_vk, n_k=n_k,
        ph_hat=torch.zeros((L, V, K), dtype=torch.float32, device=mesh.device),
        th_hat=torch.zeros((L, D_s, K), dtype=torch.float32, device=mesh.device),
        s=0)


def phi_chains(n_vk: torch.Tensor, n_k: torch.Tensor, beta: float, vbeta: float,
               topic_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """(L, V, K) smoothed φ of every local chain, ``(n_vk + β)/(n_k + V·β)``
    with the true ``V·β`` (as ``models/state.phi_from_counts``)."""
    phi = (n_vk + beta) / (n_k[:, None, :] + vbeta)
    if topic_mask is not None:
        phi = phi * topic_mask
    return phi


class ShardedTrainStep:
    """The dense AD-LDA training step: sweep, merge, thinned means.

    ``step(state, corpus, save, generators=None, uniforms=None)`` returns the
    next state (the input is not modified).  The L local chains sweep
    through one :class:`..ops.gibbs.ExactSweep` over ``(L, …)`` work
    buffers, built at the first call and refilled from ``state`` by every
    call, so on a card the sweep is one CUDA graph per rank from the third
    call on, whatever L is.  Chain j draws from ``generators[j]``;
    ``uniforms`` (one ``(U, D_s)`` per local chain, or ``(L, U, D_s)``)
    replace the generators' draws.  ``on_merge`` callables see each merged
    state.  A save refills the step's ``SaveStep`` (``_saves``, one per
    rank, kept) with the state's means, computes every chain's φ and θ
    (``phi_chains``, ``theta_from_counts`` over the chain axis) from the
    merged work buffers (on a card one replayed CUDA graph) and returns
    copies of the new means.
    """

    def __init__(self, mesh: Mesh, n_chains: int, alpha: float, beta: float,
                 topic_mask: Optional[torch.Tensor] = None):
        self.mesh = mesh
        self.n_chains = int(n_chains)
        self.alpha, self.beta = float(alpha), float(beta)
        self.topic_mask = topic_mask
        self._sweep = None
        self._saves: Optional[SaveStep] = None
        self.on_merge = []

    def _bind(self, state: ShardedLDAState, corpus: ShardedCorpus) -> None:
        tv_t = corpus.tok_v.T.contiguous()
        tf_t = corpus.tok_f.T.to(torch.float32).contiguous()
        vbeta = float(state.n_vk.shape[1] * self.beta)
        self._work = (state.z.transpose(1, 2).contiguous(), state.n_dk.clone(),
                      state.n_vk.clone(), state.n_k.clone())
        self._sweep = ExactSweep(*self._work, tv_t, tf_t, corpus.labs.contiguous(),
                                 self.alpha, self.beta, vbeta)

    def __call__(self, state: ShardedLDAState, corpus: ShardedCorpus, save: bool,
                 generators: Optional[Sequence[torch.Generator]] = None,
                 uniforms=None) -> ShardedLDAState:
        if self._sweep is None:
            self._bind(state, corpus)
        z_t, n_dk, n_vk, n_k = self._work
        # refill the work buffers: the graph reads and writes only these
        z_t.copy_(state.z.transpose(1, 2))
        n_dk.copy_(state.n_dk)
        n_vk.copy_(state.n_vk)
        n_k.copy_(state.n_k)
        if uniforms is None:
            self._sweep(generator=generators)
        else:
            self._sweep(uniforms=torch.stack(list(uniforms)))
        # AD-LDA merge: every shard's deltas onto the chain's global table
        merged_vk = state.n_vk + self.mesh.data_sum_(n_vk - state.n_vk)
        merged_k = state.n_k + self.mesh.data_sum_(n_k - state.n_k)
        nxt = state._replace(z=z_t.transpose(1, 2).contiguous(), n_dk=n_dk.clone(),
                             n_vk=merged_vk, n_k=merged_k)
        for fn in self.on_merge:
            fn(nxt)
        if not save:
            return nxt
        # the save reads the merged tables from the work buffers
        n_vk.copy_(merged_vk)
        n_k.copy_(merged_k)
        if self._saves is None:
            self._saves = SaveStep(state.ph_hat, (state.th_hat,))
        else:
            self._saves.load(state.ph_hat, (state.th_hat,))
        s = state.s + 1
        self._saves(s, lambda: self._estimates(corpus))
        return nxt._replace(ph_hat=self._saves.ph_hat.clone(),
                            th_hat=self._saves.th_hat[0].clone(), s=s)

    def _estimates(self, corpus: ShardedCorpus):
        """Every local chain's φ ``(L, V, K)`` and θ ``(L, D_s, K)`` from
        the work buffers, each in one pass over the chain axis."""
        _, n_dk, n_vk, n_k = self._work
        vbeta = float(n_vk.shape[1] * self.beta)
        return (phi_chains(n_vk, n_k, self.beta, vbeta, self.topic_mask),
                (theta_from_counts(n_dk, corpus.labs, self.alpha),))


def make_sharded_train_step(mesh: Mesh, n_chains: int, alpha: float, beta: float,
                            topic_mask=None) -> ShardedTrainStep:
    """The dense AD-LDA step (sweep → merge → thinned means), see
    :class:`ShardedTrainStep`."""
    return ShardedTrainStep(mesh, n_chains, alpha, beta, topic_mask)


def gather_chains(mesh: Mesh, x: torch.Tensor, n_chains: int,
                  shard_axis: Optional[int] = None, full: Optional[int] = None) -> torch.Tensor:
    """Every chain's copy of ``x`` (this rank's ``(L, ...)``), as ``(C, ...)``
    on every rank, in global chain order.

    ``shard_axis`` names the axis of ``x`` (counting the chain axis) that is
    sharded over ``data``, of global length ``full``; without it ``x`` is
    replicated over the data row and the row's first rank contributes it.
    The gather is a sum of zero-padded blocks, exact on any backend.
    """
    L, g0 = local_chains(mesh, n_chains)
    if mesh.single_device:
        return x
    di = mesh.coords[1]
    shape = list(x.shape)
    shape[0] = int(n_chains)
    idx = [slice(g0, g0 + L)] + [slice(None)] * (x.dim() - 1)
    if shard_axis is not None:
        shape[shard_axis] = int(full)
        n = x.shape[shard_axis]
        idx[shard_axis] = slice(di * n, (di + 1) * n)
    out = torch.zeros(shape, dtype=x.dtype, device=x.device)
    if shard_axis is not None or di == 0:
        out[tuple(idx)] = x
    return mesh.world_sum_(out)


def pooled_phi(state, mesh: Optional[Mesh] = None, n_chains: Optional[int] = None) -> torch.Tensor:
    """(V, K) chain-pooled thinned φ̂: the mean over every chain, summed in
    chain order so that every rank and every run gets the same bits."""
    ph = state.ph_hat
    if mesh is not None and not mesh.single_device:
        ph = gather_chains(mesh, ph, n_chains)
    return mean_in_order(ph)


def mean_in_order(x: torch.Tensor) -> torch.Tensor:
    """Mean over axis 0 as a left-to-right sum, then one division."""
    acc = x[0].clone()
    for c in range(1, x.shape[0]):
        acc += x[c]
    return acc / float(x.shape[0])
