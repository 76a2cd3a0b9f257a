"""LocalLDA — sentence-level unsupervised LDA (reference LocalLDA.py:11-130), on PyTorch.

Counterpart of ``lda_thesis_tpu/models/local_lda.py``.  Each sentence
becomes a pseudo-document; the model is plain collapsed-Gibbs LDA with K
free topics and a symmetric α prior, trained by the Labeled-LDA samplers
with every topic admissible:

* ``sweep="fused"`` (``"auto"``): merge blocks against a block-frozen table
  (ops/gibbs_fused.py) in dense-K mode: slot a is topic a, A = K rounded up
  to 8, ``lab_ids[d, a] = a`` on valid slots and 0 on pad slots.  The
  port's ``gather_cv`` is an exact element gather, so these identity slots
  need no gather of their own.  One kernel-1 launch per bucket per block on
  a card, each block replayed as one CUDA graph by the model's
  ``ops/gibbs_fused.FusedBlocks`` (``models/labeled_lda.fused_blocks``);
  A > 32 (K > 32) takes the kernel's warp route up to A = 256, and its
  wide route past that (K > 256).
* ``sweep="dense"``: the exact per-position sweep (ops/gibbs.ExactSweep:
  the commit and draw kernels under a CUDA graph on a card) with an
  all-ones mask over K and zeros up to Kp, one runner per bucket kept across
  calls (``models/labeled_lda.exact_sweeps``).

Each save (the φ/θ estimates and the thinned means) runs through the
model's ``ops/gibbs.SaveStep``, on a card one replayed CUDA graph.

Deliberate deviations from the reference are the JAX package's: z-init
draws one topic per type slot, and sentences split on ``! . ? , -``.  The
model runs on ``device`` (CUDA unless the caller passes ``"cpu"``) and
draws from one ``torch.Generator`` seeded by ``seed``, so its chain agrees
with the JAX package's in distribution, not draw for draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np
import torch

from ..data.buckets import bucket_encode
from ..data.textproc import prep_docs, split_sentences
from ..data.vocab import Dictionary
from ..ops.gibbs import ExactBuckets, LogLikelihood, SaveStep, init_bucket_counts
from ..ops.gibbs_fused import (
    FusedBlocks,
    init_fused_buckets,
    select_merge_block,
    theta_from_fused,
)
from ..utils.tracing import annotate
from .labeled_lda import check_merge_block, exact_sweeps, fused_blocks
from .state import phi_from_counts, theta_from_counts

__all__ = ["LocalLDA"]


class LocalLDA:
    """Sentence-level LDA with the reference's constructor semantics and the
    JAX package's defaults (one bucket, one merge per sweep)."""

    def __init__(
        self,
        docs: Sequence[str],
        alpha: float,
        beta: float,
        K: int,
        local_lda: bool = True,
        stem: bool = False,
        seed: int = 0,
        k_pad: int = 128,
        n_buckets: int = 1,
        sweep: str = "auto",
        merge_every: int = 1,
        device=None,
    ):
        if sweep == "auto":
            sweep = "fused"
        if sweep not in ("fused", "dense"):
            raise ValueError(f"unknown sweep {sweep!r}")
        self.sweep = sweep
        self.device = torch.device("cuda" if device is None else device)
        self.a = float(alpha)
        self.b = float(beta)
        self.K = int(K)
        self.merge_every = max(int(merge_every), 1)

        if local_lda:
            sentences: List[str] = []
            for doc in docs:
                sentences.extend(split_sentences(doc))
            docs = sentences
        prepped = prep_docs(docs, stem=stem)
        self.word2id = Dictionary(prepped)
        doc_tups = [self.word2id.doc2bow(d) for d in prepped]
        # the reference keeps only sentences with >1 distinct type (LocalLDA.py:28)
        doc_tups = [t for t in doc_tups if len(t) > 1]
        self.V = len(self.word2id)
        self.D = len(doc_tups)
        self.w_to_v = self.word2id.token2id
        self.v_to_w = self.word2id.id2token

        # every topic admissible; the topic axis is padded with masked columns
        self.Kp = ((self.K + k_pad - 1) // k_pad) * k_pad
        mask = (np.arange(self.Kp) < self.K).astype(np.float32)
        self.topic_mask = self._t(mask, torch.float32)

        self.buckets = bucket_encode(doc_tups, n_buckets=n_buckets)
        ix = self.buckets.doc_idx
        self.toks_v = tuple(self._t(x, torch.int64) for x in self.buckets.tok_v)
        self.toks_f = tuple(self._t(x, torch.int64) for x in self.buckets.tok_f)
        self._toks_v_t = tuple(tv.T.contiguous() for tv in self.toks_v)
        self._toks_f_t = tuple(self._t(x.T, torch.float32) for x in self.buckets.tok_f)
        self.n_tokens = int(sum(int(x.sum()) for x in self.buckets.tok_f))

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        if sweep == "fused":
            # dense-K identity slots: slot a = topic a; pad slots a >= K carry
            # id 0 and valid 0, as data/encode.compact_labels pads
            self.A = ((self.K + 7) // 8) * 8
            ids = np.where(np.arange(self.A) < self.K, np.arange(self.A), 0)
            val = (np.arange(self.A) < self.K).astype(np.float32)
            self.lab_ids_t = tuple(
                self._t(np.broadcast_to(ids, (len(i), self.A)), torch.int64) for i in ix)
            self.lab_valid_t = tuple(
                self._t(np.broadcast_to(val, (len(i), self.A)), torch.float32) for i in ix)
            self._lab_valid_tt = tuple(lv.T.contiguous() for lv in self.lab_valid_t)
            self.counts = init_fused_buckets(
                self.toks_v, self.toks_f, self.lab_ids_t, self.lab_valid_t,
                self.V, self.Kp, generator=self._gen)
        else:
            self.labs_t = tuple(
                self._t(np.broadcast_to(mask, (len(i), self.Kp)), torch.float32) for i in ix)
            self.counts = init_bucket_counts(
                self.toks_v, self.toks_f, self.labs_t, self.V, generator=self._gen)

        self.ph_hat: Optional[np.ndarray] = None  # (K, V), reference orientation
        self.th_hat: Optional[np.ndarray] = None  # (D, K)
        # one LogLikelihood per bucket (on a card a replayed CUDA graph),
        # made at the first perplexity
        self._ll: Optional[List[LogLikelihood]] = None
        # the training runners, made at the first training call and kept
        self._fused: Optional[FusedBlocks] = None  # the fused path's merge blocks
        self._exact: Optional[ExactBuckets] = None  # the dense path's sweeps
        self._save: Optional[SaveStep] = None  # the saves

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

    # ---------------------------------------------------------------- train

    def _theta(self, g: int) -> torch.Tensor:
        """(D_g, Kp) θ of bucket ``g`` from the current counts."""
        ndk = self.counts.n_dk[g]
        if self.sweep == "fused":
            return theta_from_fused(ndk, self.lab_ids_t[g], self.lab_valid_t[g],
                                    self.a, self.Kp)
        return theta_from_counts(ndk, self.labs_t[g], self.a)

    def _phi(self) -> torch.Tensor:
        return phi_from_counts(self.counts.n_vk, self.counts.n_k, self.b, self.topic_mask)

    def _estimates(self):
        return self._phi(), tuple(self._theta(g) for g in range(self.buckets.n_buckets))

    def run_training(self, iters: int, thinning: int, total_iters: int = None) -> None:
        """Gibbs sweeps + thinned φ/θ averaging (reference LocalLDA.py:86-109).

        Saves land at exact ``thinning`` multiples; the trailing
        ``iters % thinning`` sweeps run unsaved.  ``total_iters`` (chunked or
        resumed runs) is the full planned sweep count, so the fused path's
        merge block matches the uninterrupted run's.  Blocks, sweeps and
        saves run through the model's kept runners (on a card, replayed CUDA
        graphs); the means start anew at every call, in the save runner's
        static buffers, and land in ``ph_hat``/``th_hat`` on the host, where
        ``_check_ph_hat`` guards them (the span ``local_lda.land``).
        """
        iters, thinning = int(iters), int(thinning)
        if self.sweep == "fused":
            budget = int(total_iters) if total_iters else iters
            merge = select_merge_block(self.merge_every, thinning, budget)
            check_merge_block(self, merge)
            blocks = fused_blocks(self, self.a, self.b)
        else:
            merge = 1
            blocks = exact_sweeps(self, self.a, self.b)
        if self._save is None:
            ph = torch.zeros((self.V, self.Kp), dtype=torch.float32, device=self.device)
            self._save = SaveStep(ph, [torch.zeros((len(i), self.Kp), dtype=torch.float32,
                                                   device=self.device)
                                       for i in self.buckets.doc_idx])
        saves = self._save
        saves.reset()
        n_save_blocks = iters // thinning
        for s in range(1, n_save_blocks + 1):
            for _ in range(thinning // merge):
                blocks(merge, generator=self._gen)
            saves(s, self._estimates)
        left = iters - n_save_blocks * thinning
        while left > 0:
            m = min(merge, left)
            blocks(m, generator=self._gen)
            left -= m
        if self.sweep == "dense":
            blocks.doc_major()
        with annotate("local_lda.land"):
            self.ph_hat = saves.ph_hat[:, : self.K].T.cpu().numpy()
            self.th_hat = self.buckets.scatter_rows(
                [t.cpu().numpy() for t in saves.th_hat])[:, : self.K]
            self._check_ph_hat()

    def _check_ph_hat(self) -> None:
        """Reference runtime guards (LocalLDA.py:102-109)."""
        if self.ph_hat is None:
            return
        if np.any(self.ph_hat < 0):
            raise ValueError("A negative value occurred in ph_hat")
        if np.any(np.isnan(self.ph_hat)):
            raise ValueError("A nan has creeped into ph_hat")
        if np.any(self.ph_hat.sum(axis=0) == 0):
            raise ValueError("A word in dictionary has no z-value")

    # ------------------------------------------------------------ estimators

    def get_phi(self) -> np.ndarray:
        """(K, V) smoothed φ (reference LocalLDA.py:111-114)."""
        return self._phi()[:, : self.K].T.cpu().numpy()

    def get_theta(self) -> np.ndarray:
        """(D, K) symmetric-α θ (reference LocalLDA.py:116-119)."""
        per_bucket = [self._theta(g).cpu().numpy() for g in range(self.buckets.n_buckets)]
        return self.buckets.scatter_rows(per_bucket)[:, : self.K]

    # ------------------------------------------------------------ diagnostics

    def print_topwords(self, n: int = 10):
        """Top-n words per topic (reference LocalLDA.py:121-130)."""
        ph = self.get_phi()
        topiclist = []
        for k in range(self.K):
            idx = np.argsort(-ph[k])[:n]
            topiclist.append([str(k)] + [self.v_to_w[int(v)] for v in idx])
        print(topiclist)
        return topiclist

    def perplexity(self) -> float:
        """Training perplexity exp(−ll/N) of the current counts; the log
        likelihood is summed per bucket on the host in float64, as in the
        JAX model."""
        phi = self._phi()
        if self._ll is None:
            self._ll = [LogLikelihood(tv, tf) for tv, tf in zip(self.toks_v, self.toks_f)]
        ll, n = 0.0, 0
        for g, run in enumerate(self._ll):
            llg, ng = run(self._theta(g), phi)
            ll += float(llg)
            n += int(ng)
        return float(np.exp(-ll / max(n, 1)))
