"""User-facing distributed Labeled-LDA trainer.

Counterpart of ``lda_thesis_tpu/parallel/trainer.py``: the constructor and
methods of :class:`..models.labeled_lda.LabeledLDA` (docs, labs, labelset,
dicti, alpha, beta; ``run_training`` / ``run_test`` / ``get_phi``) plus the
mesh: documents sharded over the ``data`` axis with AD-LDA merges,
independent chains over the ``chains`` axis and, within a rank, as a
leading batch axis (one kernel launch per bucket for all of a rank's
chains), and pooled estimators.

    # one process, eight chains batched on one card
    model = DistributedLabeledLDA(docs, labs, labelset, dicti, alpha=0.1,
                                  beta=0.01, n_chains=8)
    # or, under ``python -m torch.distributed.run --nproc-per-node 4``:
    initialize_distributed()
    mesh = make_mesh(n_data=2, n_chains=2)
    model = DistributedLabeledLDA(..., mesh=mesh, n_chains=4)
    model.run_training(150, 25)
    theta = model.run_test(test_docs, 150, 25)  # pooled-φ̂ fold-in

Every rank runs the same calls; the estimators gather over the process
group, so they too are called on every rank.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..data.buckets import bucket_encode
from ..data.encode import binarize_labels, build_labelmap, compact_labels, encode_bow_types
from ..models.labeled_lda import fold_in_test
from ..ops.gibbs_fused import select_merge_block
from ._util import check_merge_block, dispatch_chunks
from .bootstrap import Mesh
from .fused_sharded import init_fused_sharded, make_fused_train_loop, shard_fused_corpus
from .fused_sharded_buckets import (
    init_bucketed_sharded,
    make_bucketed_train_loop,
    shard_bucketed_corpus,
)
from .sharded import (
    fold_in_seed,
    gather_chains,
    init_sharded_state,
    make_generators,
    make_mesh,
    make_sharded_train_step,
    mean_in_order,
    padded,
    shard_corpus,
)
from .vocab_sharded import init_vocab_chains, make_vocab_chains_train_loop

__all__ = ["DistributedLabeledLDA"]


class DistributedLabeledLDA:
    """Labeled LDA over a ``(chains, data)`` mesh of ranks."""

    def __init__(
        self,
        docs: Sequence[Sequence[str]],
        labs: Sequence[Sequence[str]],
        labelset: Sequence[str],
        dicti,
        alpha: float,
        beta: float,
        mesh: Optional[Mesh] = None,
        n_chains: Optional[int] = None,
        seed: int = 0,
        k_pad: int = 128,
        sweep: str = "auto",
        merge_every: int = 25,
        table_shard: str = "replicated",
        n_buckets: int = 1,
        device=None,
    ):
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.seed = int(seed)
        self.dicti = dicti
        self.labelmap = build_labelmap(labelset)
        self.K = len(self.labelmap)
        self.V = len(dicti)
        self.D = len(docs)
        self.v_to_w = dicti.id2token

        self.mesh = mesh if mesh is not None else make_mesh(n_chains=1, device=device)
        if device is not None and torch.device(device).type != self.mesh.device.type:
            raise ValueError(f"device {device} differs from the mesh's {self.mesh.device}")
        self.device = self.mesh.device
        self.n_chains = int(n_chains if n_chains is not None else self.mesh.shape["chains"])
        if self.n_chains % self.mesh.shape["chains"]:
            raise ValueError("n_chains must be a multiple of the chains mesh axis")

        if sweep == "auto":
            sweep = "fused"
        if sweep not in ("fused", "dense"):
            raise ValueError(f"the distributed trainer runs sweep='fused' or 'dense', "
                             f"not {sweep!r}")
        if table_shard not in ("replicated", "vocab"):
            raise ValueError(f"unknown table_shard {table_shard!r}")
        self.n_buckets = max(int(n_buckets), 1)
        if self.n_buckets > 1 and (sweep != "fused" or table_shard != "replicated"):
            raise ValueError("n_buckets > 1 requires sweep='fused' and "
                             "table_shard='replicated'")
        if table_shard == "vocab" and sweep != "fused":
            raise ValueError("table_shard='vocab' uses the fused sampler")
        self.sweep = sweep
        self.table_shard = table_shard
        self.merge_every = max(int(merge_every), 1)
        self._vocab_chains = table_shard == "vocab" and (
            self.n_chains > 1 or self.mesh.shape["chains"] > 1)

        bows = [dicti.doc2bow(doc) for doc in docs]
        tok_v, tok_f = encode_bow_types(bows)
        lab_mask = binarize_labels(labs, self.labelmap)
        self.Kp = ((self.K + k_pad - 1) // k_pad) * k_pad
        lab_mask = np.pad(lab_mask, ((0, 0), (0, self.Kp - self.K)))
        self.topic_mask = torch.as_tensor((np.arange(self.Kp) < self.K).astype(np.float32),
                                          device=self.device)
        self.n_tokens = int(tok_f.sum())

        self._gens = make_generators(self.mesh, self.n_chains, self.seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(fold_in_seed(self.seed))
        self._sweeps_done = 0
        self._loop = None
        self.on_merge = []  # callables that see each merged state

        if sweep == "dense":
            self.corpus = shard_corpus(self.mesh, tok_v, tok_f, lab_mask)
            self.state = init_sharded_state(self.mesh, self.corpus, self.V,
                                            self.n_chains, self._gens)
            return
        lab_ids, lab_valid = compact_labels(lab_mask)
        self.A = lab_ids.shape[1]
        if self.n_buckets > 1:
            self._buckets = bucket_encode(bows, n_buckets=self.n_buckets)
            self.corpus = shard_bucketed_corpus(self.mesh, self._buckets, lab_ids,
                                                lab_valid)
            self.state = init_bucketed_sharded(self.mesh, self.corpus, self.V, self.Kp,
                                               self.n_chains, self._gens)
            return
        self.corpus = shard_fused_corpus(self.mesh, tok_v, tok_f, lab_ids, lab_valid)
        init = init_vocab_chains if table_shard == "vocab" else init_fused_sharded
        self.state = init(self.mesh, self.corpus, self.V, self.Kp, self.n_chains,
                          self._gens)

    # ---------------------------------------------------------------- train

    def _make_loop(self):
        if self.sweep == "dense":
            step = make_sharded_train_step(self.mesh, self.n_chains, self.alpha,
                                           self.beta, self.topic_mask)
            step.on_merge = self.on_merge
            return step
        args = (self.mesh, self.alpha, self.beta)
        if self.table_shard == "vocab":
            return make_vocab_chains_train_loop(*args, self.V, self.Kp, self.topic_mask,
                                                self.corpus, on_merge=self.on_merge)
        if self.n_buckets > 1:
            return make_bucketed_train_loop(*args, self.topic_mask, self.corpus,
                                            on_merge=self.on_merge)
        return make_fused_train_loop(*args, self.topic_mask, self.corpus,
                                     on_merge=self.on_merge)

    def run_training(self, iters: int, thinning: int, total_iters: int = None) -> None:
        """``iters`` sweeps; φ/θ folded into the thinned running means every
        ``thinning`` sweeps (reference rule, LabeledLDA.py:131-145).  The
        means carry across calls, as in the JAX trainer.

        The fused layouts run merge blocks of M (``select_merge_block`` of
        ``merge_every``, ``thinning`` and ``total_iters``, the full planned
        sweep count of a chunked run, so its M is the uninterrupted run's);
        the dense layout runs sweep by sweep, saving at multiples of
        ``thinning`` within the call.
        """
        iters, thinning = int(iters), int(thinning)
        if self._loop is None:
            self._loop = self._make_loop()
        if self.sweep == "dense":
            for i in range(iters):
                self.state = self._loop(self.state, self.corpus, (i + 1) % thinning == 0,
                                        generators=self._gens)
            self._sweeps_done += iters
            return
        budget = int(total_iters) if total_iters else iters
        M = select_merge_block(self.merge_every, thinning, budget)
        check_merge_block(self, M)
        for step in dispatch_chunks(iters, thinning):
            self.state = self._loop(self.state, step, thinning, M, self._gens)
            self._sweeps_done += step

    # ------------------------------------------------------------ estimators

    def _chain_ph(self) -> torch.Tensor:
        """(C, V, Kp) every chain's thinned φ̂, on every rank."""
        ph = self.state.ph_hat
        if self.table_shard == "vocab":
            ph = gather_chains(self.mesh, ph, self.n_chains, shard_axis=1,
                               full=padded(self.V, self.mesh.shape["data"]))
        else:
            ph = gather_chains(self.mesh, ph, self.n_chains)
        return ph[:, : self.V]

    def pooled_phi(self) -> np.ndarray:
        """(K, V) chain-pooled thinned φ̂ (reference orientation), the mean
        over the chains in chain order."""
        return mean_in_order(self._chain_ph())[:, : self.K].T.cpu().numpy()

    def get_phi(self) -> np.ndarray:
        return self.pooled_phi()

    def chain_phis(self) -> np.ndarray:
        """(C, K, V) per-chain thinned φ̂, for Monte-Carlo error diagnostics."""
        return self._chain_ph()[:, :, : self.K].permute(0, 2, 1).cpu().numpy()

    def mc_error(self) -> float:
        """Across-chain standard deviation of φ̂, averaged over entries."""
        if self.n_chains == 1:
            return 0.0  # a single chain has no spread
        ph = self._chain_ph()[:, :, : self.K].cpu().numpy()
        return float(ph.std(axis=0).mean())

    # ----------------------------------------------------------------- test

    def run_test(self, newdocs, it: int, thinning: int,
                 chain: Optional[int] = None) -> np.ndarray:
        """Fold-in θ̂ ``(n, K)`` against the pooled φ̂ (the single-device
        fold-in, ``models/labeled_lda.fold_in_test``), or against chain
        ``chain``'s φ̂ for per-chain diagnostics.  Every rank draws the same
        fold-in from the same generator."""
        if self.n_chains == 1 and chain not in (None, 0):
            raise ValueError(f"this trainer runs a single chain; chain={chain!r} is not "
                             "available — pass chain=None (or 0)")
        ph = self._chain_ph()
        phi = mean_in_order(ph) if chain is None else ph[int(chain)]
        bows = [self.dicti.doc2bow(doc) for doc in newdocs]
        tv, tf = encode_bow_types(bows)
        avg = fold_in_test(
            phi.contiguous(), torch.as_tensor(tv, dtype=torch.int64, device=self.device),
            torch.as_tensor(tf, dtype=torch.int64, device=self.device), self.topic_mask,
            self.alpha, it, thinning, self._gen)
        return avg[:, : self.K].cpu().numpy()
