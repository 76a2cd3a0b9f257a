"""Merge-block sampler over the ``(chains, data)`` mesh, chains batched
into one kernel launch.

Counterpart of ``lda_thesis_tpu/parallel/fused_sharded.py``.  A merge block
freezes the topic-word table for ``M`` sweeps in time (the fused sampler,
ops/gibbs_fused.py) and across data shards (AD-LDA) at once:

* per bucket, ``ops/gibbs_fused.fused_train_block`` runs every local chain
  at once over its leading chain axis: each chain's per-slot counts are
  gathered from that chain's table, each chain's uniforms ``(M, U, D_s)``
  are drawn from its generator, and the ``L`` chains' documents lie side
  by side in **one** launch of the merge-block kernel (it keeps all its
  state per document, one CTA each); each slot's first-to-last topic move
  is committed to its chain's working table before the next bucket
  gathers;
* block end: the block's table deltas are summed over the data row
  (``all_reduce``) and the thinned φ̂/θ̂ means are updated on save
  boundaries, as in the dense step, every chain at once
  (:func:`.sharded.phi_chains`, :func:`theta_chains`).

The state holds ``z (L, U, D_s)`` / ``n_dk (L, A, D_s)`` and each chain's
table replica ``n_vk (L, V, K)``.  The bucketed layout
(parallel/fused_sharded_buckets.py) and the vocab-sharded one
(parallel/vocab_sharded.py) run the same block.  The replicated layouts run
it through :class:`RankBlocks`: on a card each block replays one CUDA graph
of the rank's chains, the data row's all-reduce outside it, and so does
each save (``ops/gibbs.SaveStep``, :meth:`RankBlocks.save`).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Sequence

import numpy as np
import torch

from ..ops.gibbs import SaveStep, init_counts_compact, theta_from_compact
from ..ops.gibbs_fused import FusedBlocks, FusedBucketState
from .bootstrap import Mesh
from .sharded import phi_chains, shard_rows

__all__ = ["FusedShardedState", "FusedShardCorpus", "shard_fused_corpus",
           "init_fused_sharded", "train_blocks", "RankBlocks", "make_fused_train_loop"]


class FusedShardedState(NamedTuple):
    z: torch.Tensor  # (L, U, D_s) int32
    n_dk: torch.Tensor  # (L, A, D_s) float32
    n_vk: torch.Tensor  # (L, V, K) float32
    n_k: torch.Tensor  # (L, K) float32
    ph_hat: torch.Tensor  # (L, V, K) thinned running mean
    th_hat: torch.Tensor  # (L, D_s, K)
    s: int  # saves folded into the means


class FusedShardCorpus(NamedTuple):
    """This rank's shard of one bucket in the fused layout."""

    tok_v: torch.Tensor  # (D_s, U) int64, doc-major
    tok_f: torch.Tensor  # (D_s, U) int64
    tok_v_t: torch.Tensor  # (U, D_s) int64, position-major
    tok_f_t: torch.Tensor  # (U, D_s) float32
    lab_ids: torch.Tensor  # (D_s, A) int64
    lab_valid: torch.Tensor  # (D_s, A) float32
    lab_valid_t: torch.Tensor  # (A, D_s) float32


def shard_fused_corpus(mesh: Mesh, tok_v, tok_f, lab_ids, lab_valid) -> FusedShardCorpus:
    """Pad the document axis to the data-mesh size and keep this rank's
    shard in the fused layout, on its device."""
    dev = mesh.device
    tv = torch.as_tensor(shard_rows(tok_v, mesh), dtype=torch.int64, device=dev)
    tf = torch.as_tensor(shard_rows(tok_f, mesh), dtype=torch.int64, device=dev)
    li = torch.as_tensor(shard_rows(lab_ids, mesh), dtype=torch.int64, device=dev)
    lv = torch.as_tensor(shard_rows(np.asarray(lab_valid, np.float32), mesh),
                         dtype=torch.float32, device=dev)
    return FusedShardCorpus(tok_v=tv, tok_f=tf, tok_v_t=tv.T.contiguous(),
                            tok_f_t=tf.T.to(torch.float32).contiguous(),
                            lab_ids=li, lab_valid=lv, lab_valid_t=lv.T.contiguous())


def init_chains(corpora: Sequence[FusedShardCorpus], V_rows: int, K: int,
                generators: Sequence[torch.Generator],
                uniforms: Optional[Sequence[Sequence[torch.Tensor]]] = None):
    """Per local chain, per bucket: z ~ uniform over each document's labels
    (LabeledLDA.py:85-92), drawn from the chain's generator bucket by bucket
    (or ``uniforms[j][g] (U_g, D_s)``).  Returns per-bucket ``z (L, U, D_s)``
    and ``n_dk (L, A, D_s)`` and this shard's unmerged ``n_vk (L, V_rows,
    K)``, ``n_k (L, K)``."""
    L, dev = len(generators), corpora[0].tok_v.device
    n_vk = torch.zeros((L, V_rows, K), dtype=torch.float32, device=dev)
    zs = [[] for _ in corpora]
    ndks = [[] for _ in corpora]
    for j, gen in enumerate(generators):
        for g, c in enumerate(corpora):
            st = init_counts_compact(c.tok_v, c.tok_f, c.lab_ids, c.lab_valid, V_rows, K,
                                     uniforms=None if uniforms is None else uniforms[j][g],
                                     generator=gen)
            zs[g].append(st.z.T)
            ndks[g].append(st.n_dk.T)
            n_vk[j] += st.n_vk
    return ([torch.stack(z) for z in zs], [torch.stack(n) for n in ndks],
            n_vk, n_vk.sum(dim=1))


def init_fused_sharded(mesh: Mesh, corpus: FusedShardCorpus, V: int, K: int,
                       n_chains: int, generators: Sequence[torch.Generator],
                       uniforms=None) -> FusedShardedState:
    """Per-(chain, shard) init with each chain's table summed over the data
    row.  ``uniforms[j]`` is chain ``j``'s ``(U, D_s)``."""
    z, n_dk, n_vk, n_k = init_chains(
        [corpus], V, K, generators,
        None if uniforms is None else [[u] for u in uniforms])
    mesh.data_sum_(n_vk)
    mesh.data_sum_(n_k)
    L, D_s = len(generators), corpus.tok_v.shape[0]
    return FusedShardedState(
        z=z[0], n_dk=n_dk[0], n_vk=n_vk, n_k=n_k,
        ph_hat=torch.zeros_like(n_vk),
        th_hat=torch.zeros((L, D_s, K), dtype=torch.float32, device=mesh.device),
        s=0)


def merge_replicated(mesh: Mesh, table: torch.Tensor, n_k: torch.Tensor,
                     work: torch.Tensor, nk_work: torch.Tensor):
    """AD-LDA merge of replicated tables: ``table + Σ_data (work − table)``."""
    if mesh.shape["data"] == 1:
        return work, nk_work
    d_vk = mesh.data_sum_(work - table)
    d_k = mesh.data_sum_(nk_work - n_k)
    return table + d_vk, n_k + d_k


class RankBlocks:
    """A rank's merge blocks over the buckets ``corpora``, all local chains
    at once, through one ``ops/gibbs_fused.FusedBlocks`` that a training
    loop keeps across its calls (on a card, one replayed CUDA graph per
    block, kernel 1 inside it), then the AD-LDA merge of the tables over the
    data row (:func:`merge_replicated`), outside the graph, its result
    copied into the runner's static tables before the next block.

    ``blocks(z, n_dk, n_vk, n_k, M, generators)`` takes per-bucket ``z`` and
    ``n_dk`` and returns the merged state as the runner's static tensors; a
    state that is not the runner's (the first call, a restored checkpoint)
    is copied in first.  The denominator's V·β counts the table's rows,
    padding included, as the trainer's loops do.

    ``blocks.save(ph_hat, th_hat, s)`` folds the merged state's φ and θ of
    every chain (``phi_chains``, :func:`theta_chains`) into the thinned
    means through one ``ops/gibbs.SaveStep`` (on a card one replayed CUDA
    graph) and returns its static means; means that are not the runner's
    are copied in first."""

    def __init__(self, mesh: Mesh, corpora: Sequence[FusedShardCorpus], alpha: float,
                 beta: float, topic_mask=None):
        self.mesh = mesh
        self._corpora = tuple(corpora)
        self._inputs = ([c.tok_v_t for c in corpora], [c.tok_f_t for c in corpora],
                        [c.lab_ids for c in corpora], [c.lab_valid_t for c in corpora])
        self._alpha, self._beta = alpha, beta
        self._topic_mask = topic_mask
        self.run: Optional[FusedBlocks] = None
        self.saves: Optional[SaveStep] = None

    def __call__(self, z, n_dk, n_vk, n_k, M: int, generators) -> FusedBucketState:
        st = FusedBucketState(tuple(z), tuple(n_dk), n_vk, n_k)
        if self.run is None:
            vbeta = float(n_vk.shape[-2]) * float(self._beta)
            self.run = FusedBlocks(st, *self._inputs, self._alpha, self._beta, vbeta=vbeta)
        elif not self.run.holds(st):
            self.run.load(st)
        out = self.run.state
        merged = self.mesh.shape["data"] > 1
        if merged:
            table, totals = out.n_vk.clone(), out.n_k.clone()  # the block-start tables
        self.run(M, generator=generators)
        if merged:
            n_vk, n_k = merge_replicated(self.mesh, table, totals, out.n_vk, out.n_k)
            out.n_vk.copy_(n_vk)
            out.n_k.copy_(n_k)
        return out

    def _estimates(self):
        st = self.run.state
        V, K = st.n_vk.shape[1:]
        cur_ph = phi_chains(st.n_vk, st.n_k, self._beta, float(V) * float(self._beta),
                            self._topic_mask)
        return cur_ph, tuple(theta_chains(nd, c, self._alpha, K)
                             for nd, c in zip(st.n_dk, self._corpora))

    def save(self, ph_hat, th_hat, s: int):
        """Save ``s`` (1-based) of the thinned means ``ph_hat (L, V, K)``
        and ``th_hat`` (per bucket ``(L, D_s, K)``) from the runner's
        merged state; returns the runner's static ``(ph_hat, th_hat)``."""
        if self.saves is None:
            self.saves = SaveStep(ph_hat, th_hat)
        elif not self.saves.holds(ph_hat, th_hat):
            self.saves.load(ph_hat, th_hat)
        self.saves(s, self._estimates)
        return self.saves.ph_hat, self.saves.th_hat


def theta_chains(n_dk: torch.Tensor, corpus: FusedShardCorpus, alpha: float,
                 K: int) -> torch.Tensor:
    """(L, D_s, K) label-masked θ of every local chain, the chains' rows
    computed together (a per-chain loop of small ops was most of a
    bucketed call's host time), doc-major as ``theta_from_fused`` takes
    them, so chain c's rows have its single-chain bits."""
    L, A, D_s = n_dk.shape
    th = theta_from_compact(n_dk.transpose(1, 2).reshape(L * D_s, A),
                            corpus.lab_ids.repeat(L, 1), corpus.lab_valid.repeat(L, 1), alpha, K)
    return th.view(L, D_s, K)


def train_blocks(block: Callable[[int], None], save: Callable[[], None],
                 iters: int, thinning: int, M: int) -> None:
    """The loop of ``make_fused_train_loop``: save blocks of ``thinning //
    M`` merge blocks with a save after each, then the trailing
    ``iters % thinning`` sweeps, unsaved, in blocks of at most ``M``."""
    if thinning % M:
        raise ValueError(f"M={M} must divide thinning={thinning} "
                         "(use select_merge_block)")
    n_save = iters // thinning
    for _ in range(n_save):
        for _ in range(thinning // M):
            block(M)
        save()
    left = iters - n_save * thinning
    while left > 0:
        m = min(M, left)
        block(m)
        left -= m


def make_fused_train_loop(mesh: Mesh, alpha: float, beta: float, topic_mask,
                          corpus: FusedShardCorpus, on_merge=()):
    """Training loop of the unbucketed layout: returns ``loop(state, iters,
    thinning, M, generators) -> state``, one kernel launch per merge block
    for all local chains, each block and each save replayed by the loop's
    :class:`RankBlocks` (``loop.blocks``, kept across calls).  The state's
    means are the runner's: a reader that keeps them past the next call
    clones them."""
    blocks = RankBlocks(mesh, [corpus], alpha, beta, topic_mask)

    def loop(state: FusedShardedState, iters: int, thinning: int, M: int,
             generators) -> FusedShardedState:
        st = [state]

        def block(m):
            s = st[0]
            out = blocks((s.z,), (s.n_dk,), s.n_vk, s.n_k, m, generators)
            st[0] = s._replace(z=out.z[0], n_dk=out.n_dk[0], n_vk=out.n_vk, n_k=out.n_k)
            for fn in on_merge:
                fn(st[0])

        def save():
            s = st[0]
            ph, th = blocks.save(s.ph_hat, (s.th_hat,), s.s + 1)
            st[0] = s._replace(ph_hat=ph, th_hat=th[0], s=s.s + 1)

        train_blocks(block, save, int(iters), int(thinning), int(M))
        return st[0]

    loop.blocks = blocks
    return loop
