"""Vocab-axis sharding of the topic-word table.

Counterpart of ``lda_thesis_tpu/parallel/vocab_sharded.py``.  Every other
layout keeps a full ``(V, K)`` table replica per chain on each rank; here
the table's vocabulary axis is sharded over the data row, so a rank's
persistent table is ``(L, V_p/S, K)``: the rows ``[di·V_p/S, (di+1)·V_p/S)``
of each local chain's table, the vocabulary padded to ``V_p``, a multiple
of ``S``.  A merge block:

* block start: each chain's full table is assembled for this block only
  (every rank writes its rows into a zero ``(L, V_p, K)`` buffer and the
  row sums it, an exact all-gather);
* ``M`` fused sweeps of every local chain over the rank's documents, one
  kernel launch (``ops/gibbs_fused.fused_train_block`` over the chain
  axis);
* block end: the block's deltas are summed over the data row and each rank
  keeps the rows it owns (JAX's ``psum_scatter``); ``n_k`` is summed.

The sampler's denominator uses the true ``V·β``, not the padded one.
Counts are integers, so the sum-then-keep and the gather are exact, and a
chains×vocab run draws the same chains as the replicated run on the same
mesh.  The single-chain mode of the JAX package is the ``L = 1`` case of
the same state.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import torch

from ..models.state import running_average
from ..ops.gibbs_fused import FusedLDAState, fused_train_block
from .bootstrap import Mesh
from .fused_sharded import FusedShardCorpus, init_chains, theta_chains, train_blocks
from .sharded import padded, phi_chains

__all__ = ["VocabChainsTrainState", "VocabShardedTrainState", "vocab_rows",
           "full_table", "init_vocab_chains", "vocab_block",
           "make_vocab_sharded_block", "make_vocab_chains_train_loop"]


class VocabChainsTrainState(NamedTuple):
    """Per local chain, every V-sized array vocab-sharded."""

    z: torch.Tensor  # (L, U, D_s) int32
    n_dk: torch.Tensor  # (L, A, D_s)
    n_vk: torch.Tensor  # (L, V_p/S, K): this rank's rows
    n_k: torch.Tensor  # (L, K), replicated over the data row
    ph_hat: torch.Tensor  # (L, V_p/S, K): this rank's rows
    th_hat: torch.Tensor  # (L, D_s, K)
    s: int


# the single-chain vocab-sharded state is the one-chain case
VocabShardedTrainState = VocabChainsTrainState


def vocab_rows(mesh: Mesh, V: int) -> slice:
    """The rows of the padded vocabulary that this rank's table holds."""
    S, di = mesh.shape["data"], mesh.coords[1]
    n = padded(V, S) // S
    return slice(di * n, (di + 1) * n)


def full_table(mesh: Mesh, n_vk: torch.Tensor, V: int) -> torch.Tensor:
    """``(L, V_p, K)``: every chain's whole table, assembled from the data
    row's shards (transient, for one block or an export)."""
    L, _, K = n_vk.shape
    full = torch.zeros((L, padded(V, mesh.shape["data"]), K), dtype=n_vk.dtype,
                       device=n_vk.device)
    full[:, vocab_rows(mesh, V)] = n_vk
    return mesh.data_sum_(full)


def init_vocab_chains(mesh: Mesh, corpus: FusedShardCorpus, V: int, K: int,
                      n_chains: int, generators, uniforms=None) -> VocabChainsTrainState:
    """Per-(chain, shard) init, drawn as the replicated layout draws it
    (:func:`.fused_sharded.init_fused_sharded`); each rank keeps its rows
    of the summed tables."""
    Vp = padded(V, mesh.shape["data"])
    z, n_dk, n_vk, n_k = init_chains(
        [corpus], Vp, K, generators,
        None if uniforms is None else [[u] for u in uniforms])
    n_vk = mesh.data_sum_(n_vk)[:, vocab_rows(mesh, V)].contiguous()
    mesh.data_sum_(n_k)
    L, D_s = len(generators), corpus.tok_v.shape[0]
    return VocabChainsTrainState(
        z=z[0], n_dk=n_dk[0], n_vk=n_vk, n_k=n_k,
        ph_hat=torch.zeros_like(n_vk),
        th_hat=torch.zeros((L, D_s, K), dtype=torch.float32, device=mesh.device),
        s=0)


def vocab_block(mesh: Mesh, state: VocabChainsTrainState, corpus: FusedShardCorpus,
                alpha: float, beta: float, M: int, V: int,
                generators: Optional[Sequence[torch.Generator]] = None,
                uniforms: Optional[torch.Tensor] = None,  # (L, M, U, D_s)
                ) -> VocabChainsTrainState:
    """One merge block: gather the tables, ``M`` sweeps of every local chain
    in one launch, route the deltas back to the rows' owners.  ``V`` is the
    true vocabulary size (the denominator's ``V·β``)."""
    full = full_table(mesh, state.n_vk, V)
    out = fused_train_block(FusedLDAState(state.z, state.n_dk, full, state.n_k),
                            corpus.tok_v_t, corpus.tok_f_t, corpus.lab_ids,
                            corpus.lab_valid_t, alpha, beta, M, uniforms=uniforms,
                            generator=generators, vbeta=float(V) * float(beta))
    d_vk = mesh.data_sum_(out.n_vk - full)[:, vocab_rows(mesh, V)]
    d_k = mesh.data_sum_(out.n_k - state.n_k)
    return state._replace(z=out.z, n_dk=out.n_dk, n_vk=state.n_vk + d_vk,
                          n_k=state.n_k + d_k)


def make_vocab_sharded_block(mesh: Mesh, alpha: float, beta: float, M: int, V: int = None):
    """``block(state, corpus, generators=None, uniforms=None)``: one merge
    block of the vocab-sharded layout; ``V`` (required) is the true
    vocabulary size, since the table's vocabulary axis is padded."""
    if V is None:
        raise TypeError("make_vocab_sharded_block requires the true vocab size V: the "
                        "sharded table is padded, and V*beta must use the unpadded V")

    def block(state, corpus, generators=None, uniforms=None):
        return vocab_block(mesh, state, corpus, alpha, beta, M, V, generators, uniforms)

    return block


def make_vocab_chains_train_loop(mesh: Mesh, alpha: float, beta: float, V: int, K: int,
                                 topic_mask, corpus: FusedShardCorpus, on_merge=()):
    """Training loop of the vocab-sharded layout: ``loop(state, iters,
    thinning, M, generators) -> state``.  The saves stay shard-local: φ̂
    rows are kept by the rank that owns the table rows, θ̂ by the rank
    that owns the documents."""
    vbeta = float(V) * float(beta)

    def loop(state, iters: int, thinning: int, M: int, generators):
        st = [state]

        def block(m):
            st[0] = vocab_block(mesh, st[0], corpus, alpha, beta, m, V, generators)
            for fn in on_merge:
                fn(st[0])

        def save():
            s = st[0]
            cur_ph = phi_chains(s.n_vk, s.n_k, beta, vbeta, topic_mask)
            n = s.s + 1
            st[0] = s._replace(
                ph_hat=running_average(s.ph_hat, cur_ph, n),
                th_hat=running_average(s.th_hat, theta_chains(s.n_dk, corpus, alpha, K), n),
                s=n)

        train_blocks(block, save, int(iters), int(thinning), int(M))
        return st[0]

    return loop
