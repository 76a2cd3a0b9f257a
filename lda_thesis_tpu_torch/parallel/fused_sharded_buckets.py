"""Length-bucketed merge-block sampler over the ``(chains, data)`` mesh.

Counterpart of ``lda_thesis_tpu/parallel/fused_sharded_buckets.py``.  Per
bucket ``g`` a rank holds ``z_g (L, U_g, D_gs)`` / ``n_dk_g (L, A, D_gs)``,
each bucket's document axis padded to a multiple of the data-mesh size and
sharded; the chains' table replicas ``n_vk (L, V, K)`` are those of the
unbucketed layout.  A merge block runs the buckets one after another, each
bucket's commits landing in the chain's working table before the next
bucket gathers (as on one device, ops/gibbs_fused.fused_train_block_buckets),
with one kernel launch per bucket for all local chains (the leading chain
axis of that function), each block and each save replayed as one CUDA
graph on a card (``fused_sharded.RankBlocks``); the block's deltas are
summed over the data row once, outside the graph.  Opt-in
(``DistributedLabeledLDA(n_buckets=...)``): the bucket layout is part of
the draw stream.
"""

from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from .bootstrap import Mesh
from .fused_sharded import (
    FusedShardCorpus,
    RankBlocks,
    init_chains,
    shard_fused_corpus,
    train_blocks,
)

__all__ = ["BucketedShardedState", "shard_bucketed_corpus", "init_bucketed_sharded",
           "make_bucketed_train_loop"]


class BucketedShardedState(NamedTuple):
    z: Tuple[torch.Tensor, ...]  # per bucket (L, U_g, D_gs) int32
    n_dk: Tuple[torch.Tensor, ...]  # per bucket (L, A, D_gs)
    n_vk: torch.Tensor  # (L, V, K)
    n_k: torch.Tensor  # (L, K)
    ph_hat: torch.Tensor  # (L, V, K)
    th_hat: Tuple[torch.Tensor, ...]  # per bucket (L, D_gs, K)
    s: int


def shard_bucketed_corpus(mesh: Mesh, buckets, lab_ids, lab_valid) -> Tuple[FusedShardCorpus, ...]:
    """Per bucket of ``buckets`` (a ``data.buckets.BucketedDocs``), this
    rank's shard in the fused layout; ``lab_ids``/``lab_valid`` are the
    full (D, A) arrays, indexed by the buckets' ``doc_idx``."""
    lab_ids, lab_valid = np.asarray(lab_ids), np.asarray(lab_valid)
    return tuple(shard_fused_corpus(mesh, tv, tf, lab_ids[ix], lab_valid[ix])
                 for tv, tf, ix in zip(buckets.tok_v, buckets.tok_f, buckets.doc_idx))


def init_bucketed_sharded(mesh: Mesh, corpora: Sequence[FusedShardCorpus], V: int, K: int,
                          n_chains: int, generators, uniforms=None) -> BucketedShardedState:
    """Per-(chain, shard) init over the buckets, each chain drawing bucket
    by bucket; tables summed over the data row.  ``uniforms[j][g]`` is
    chain ``j``'s ``(U_g, D_gs)``."""
    z, n_dk, n_vk, n_k = init_chains(corpora, V, K, generators, uniforms)
    mesh.data_sum_(n_vk)
    mesh.data_sum_(n_k)
    L = len(generators)
    return BucketedShardedState(
        z=tuple(z), n_dk=tuple(n_dk), n_vk=n_vk, n_k=n_k,
        ph_hat=torch.zeros_like(n_vk),
        th_hat=tuple(torch.zeros((L, c.tok_v.shape[0], K), dtype=torch.float32,
                                 device=mesh.device) for c in corpora),
        s=0)


def make_bucketed_train_loop(mesh: Mesh, alpha: float, beta: float, topic_mask,
                             corpora: Sequence[FusedShardCorpus], on_merge=()):
    """Training loop of the bucketed layout: ``loop(state, iters, thinning,
    M, generators) -> state``, one kernel launch per bucket per merge
    block for all local chains, each block and each save replayed by the
    loop's ``RankBlocks`` (``loop.blocks``, kept across calls)."""
    blocks = RankBlocks(mesh, corpora, alpha, beta, topic_mask)

    def loop(state: BucketedShardedState, iters: int, thinning: int, M: int,
             generators) -> BucketedShardedState:
        st = [state]

        def block(m):
            s = st[0]
            out = blocks(s.z, s.n_dk, s.n_vk, s.n_k, m, generators)
            st[0] = s._replace(z=out.z, n_dk=out.n_dk, n_vk=out.n_vk, n_k=out.n_k)
            for fn in on_merge:
                fn(st[0])

        def save():
            s = st[0]
            ph, th = blocks.save(s.ph_hat, s.th_hat, s.s + 1)
            st[0] = s._replace(ph_hat=ph, th_hat=th, s=s.s + 1)

        train_blocks(block, save, int(iters), int(thinning), int(M))
        return st[0]

    loop.blocks = blocks
    return loop
