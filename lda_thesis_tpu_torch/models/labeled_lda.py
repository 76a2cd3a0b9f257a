"""Labeled LDA (Ramage '09) on PyTorch.

Counterpart of ``lda_thesis_tpu/models/labeled_lda.py``: the same surface as
the reference class (LabeledLDA.py:49-265) — ``run_training(iters,
thinning)``, ``run_test(newdocs, it, thinning)``, ``get_phi/get_theta``,
``topwords_per_topic``, ``perplexity``, ``get_pred(s)`` — over the same
length buckets (``n_buckets=4``) and label slots as the JAX package, with
its three samplers:

* ``sweep="fused"`` (``"auto"``): merge blocks of M sweeps against a
  block-frozen table (ops/gibbs_fused.py); one launch of the CUDA merge-block
  kernel per bucket per block on a card, each block replayed as one CUDA
  graph by the model's ``ops/gibbs_fused.FusedBlocks``, kept across calls;
* ``sweep="dense"``: the exact per-position sweep over (D, K) lanes
  (ops/gibbs.exact_sweep); on a card a count commit and a draw kernel per
  type position, each bucket's sweep captured once as a CUDA graph and
  replayed (ops/gibbs.ExactSweep);
* ``sweep="compact"``: the same exact sampler on each document's compact
  label slots (ops/gibbs.compact_sweep), in plain PyTorch, each bucket's
  sweep replayed the same way (ops/gibbs.CompactSweep).

Each save (φ̂/θ̂ estimates, the thinned means and the perplexity) runs
through the model's ``ops/gibbs.SaveStep``, on a card one replayed CUDA
graph, as the JAX package's save block runs inside its jitted loop.

The runners are made at the first training call and kept: the fused path's
``FusedBlocks`` (``_fused``), the exact paths' ``ExactBuckets``
(``_exact``, which keeps the state position-major, ``z_t (U_g, D_g)``, and
writes ``counts.z`` back in the JAX package's (D_g, U_g) layout at each
call's end) and the ``SaveStep`` (``_save``).  ``counts``, ``ph_hat`` and
the per-bucket θ̂ are their static state, updated in place by every call; a
state assigned from elsewhere (a checkpoint load) is copied into the
runners at the next ``run_training``.

The model runs on ``device`` (CUDA unless the caller passes ``"cpu"``) and
draws from one ``torch.Generator`` on that device, seeded by ``seed``.  The
draw stream differs from the JAX package's, so chains agree in
distribution, not draw for draw.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.buckets import BucketedDocs, bucket_encode
from ..data.encode import binarize_labels, build_labelmap, compact_labels, encode_bow_types
from ..ops.gibbs import (
    CompactSweep,
    ExactBuckets,
    ExactSweep,
    FoldinSweep,
    LogLikelihood,
    SaveStep,
    init_bucket_counts,
    init_bucket_counts_compact,
    theta_from_compact,
    training_perplexity,
)
from ..ops.gibbs_fused import (
    FusedBlocks,
    init_fused_buckets,
    select_merge_block,
    theta_from_fused,
)
from ..utils.tracing import annotate
from .state import phi_from_counts, running_average, theta_from_counts

__all__ = ["LabeledLDA", "fold_in_test", "check_merge_block", "fused_blocks", "exact_sweeps"]


def check_merge_block(model, merge: int) -> None:
    """Resume guard: a model whose state was recorded under merge block M
    (``_ckpt_merge_M``) refuses to continue under a different M, which
    would draw a different chain; records the M in use as ``_merge_M``."""
    ckpt = getattr(model, "_ckpt_merge_M", None)
    if ckpt is not None and int(ckpt) != int(merge):
        raise ValueError(
            f"fused merge-block mismatch: checkpoint used M={ckpt}, this "
            f"run selected M={merge} — pass total_iters= (the full planned "
            f"sweep count of the original run) so the resumed chain is "
            f"bit-identical")
    model._merge_M = int(merge)


def _kept(model, attr: str, make):
    """The runner ``model.<attr>`` over ``model.counts``, made by ``make()``
    at the model's first training call and kept, so later calls replay its
    graphs; ``model.counts`` becomes the runner's static state.  A state
    that replaced ``model.counts`` since (a checkpoint load) is copied into
    the runner."""
    run = getattr(model, attr)
    if run is None:
        run = make()
        setattr(model, attr, run)
    elif not run.holds(model.counts):
        run.load(model.counts)
    model.counts = run.state
    return run


def fused_blocks(model, alpha: float, beta: float) -> FusedBlocks:
    """The fused merge-block runner of ``model`` (a ``LabeledLDA`` or a
    ``LocalLDA``), kept as ``model._fused`` (:func:`_kept`)."""
    return _kept(model, "_fused", lambda: FusedBlocks(
        model.counts, model._toks_v_t, model._toks_f_t, model.lab_ids_t,
        model._lab_valid_tt, alpha, beta))


def exact_sweeps(model, alpha: float, beta: float) -> ExactBuckets:
    """The exact sweeps of ``model`` (``sweep="dense"``: an ``ExactSweep``
    per bucket; ``"compact"``: a ``CompactSweep``), kept as ``model._exact``
    (:func:`_kept`)."""
    vbeta = float(model.V * beta)

    def make(g, z_t, n_dk, n_vk, n_k):
        tv, tf = model._toks_v_t[g], model._toks_f_t[g]
        if model.sweep == "dense":
            return ExactSweep(z_t, n_dk, n_vk, n_k, tv, tf, model.labs_t[g], alpha, beta,
                              vbeta)
        return CompactSweep(z_t, n_dk, n_vk, n_k, tv, tf, model.lab_ids_t[g],
                            model.lab_valid_t[g], alpha, beta, vbeta)

    return _kept(model, "_exact", lambda: ExactBuckets(model.counts, make))


def _fold_in_init(phi: torch.Tensor, tok_v: torch.Tensor, tok_f: torch.Tensor,
                  topic_mask: torch.Tensor, u: torch.Tensor):
    """:func:`fold_in_test`'s init pass with uniforms ``u (U, D)``: z drawn
    from φ̂'s column for each type (uniform over the real topics of
    ``topic_mask`` where that column is all zero), and its ``n_dk``."""
    D, U = tok_v.shape
    ff = tok_f.to(torch.float32)
    n_dk = torch.zeros((D, phi.shape[1]), dtype=torch.float32, device=phi.device)
    z = torch.empty((D, U), dtype=torch.int32, device=phi.device)
    for p in range(U):
        w = phi[tok_v[:, p]]
        dead = w.sum(dim=1, keepdim=True) <= 0.0
        c = torch.cumsum(torch.where(dead, topic_mask[None, :], w), dim=1)
        zp = (c < (u[p] * c[:, -1])[:, None]).sum(dim=1, dtype=torch.int32)
        n_dk.scatter_add_(1, zp.long()[:, None], ff[:, p, None])
        z[:, p] = zp
    return z, n_dk


def fold_in_test(phi: torch.Tensor, tok_v: torch.Tensor, tok_f: torch.Tensor,
                 topic_mask: torch.Tensor, alpha: float, it: int, thinning: int,
                 generator: torch.Generator) -> torch.Tensor:
    """Fold-in θ̂ ``(D, Kp)`` of held-out documents ``tok_v/tok_f (D, U)``
    against a frozen ``phi (V, Kp)`` (LabeledLDA.py:155-212).

    z is initialised from φ̂'s column for each type (uniform over the real
    topics of ``topic_mask`` where that column is all zero); then ``it``
    frozen-φ̂ sweeps, averaging the normalised doc-topic counts at
    multiples of ``thinning``; trailing sweeps run unsaved, as in the
    reference.  The sweeps run through ``ops/gibbs.FoldinSweep`` (on a card,
    one replayed CUDA graph from the second sweep on), with the bits of
    ``foldin_sweep``.
    """
    D, U = tok_v.shape
    with annotate("foldin.init"):
        u = torch.rand((U, D), generator=generator, device=phi.device)
        z, n_dk = _fold_in_init(phi, tok_v, tok_f, topic_mask, u)
    with annotate("foldin.sweeps"):
        sweep = FoldinSweep(z, n_dk, tok_v, tok_f, phi, alpha)
        avg = torch.zeros_like(n_dk)
        s = 0
        for i in range(int(it)):
            sweep(generator)
            if (i + 1) % int(thinning) == 0:
                s += 1
                cur = n_dk / torch.clamp(n_dk.sum(dim=1, keepdim=True), min=1.0)
                avg = running_average(avg, cur, s)
    return avg


class LabeledLDA:
    """Labeled LDA with collapsed-Gibbs training on a CUDA device.

    ``counts`` is a ``FusedBucketState`` (fused), ``BucketLDAState``
    (dense) or ``CompactBucketState`` (compact), as in the JAX package.
    """

    def __init__(
        self,
        docs: Sequence[Sequence[str]],
        labs: Sequence[Sequence[str]],
        labelset: Sequence[str],
        dicti,
        alpha: float,
        beta: float,
        seed: int = 0,
        k_pad: int = 128,
        n_buckets: int = 4,
        sweep: str = "auto",
        merge_every: int = 25,
        device=None,
    ):
        if sweep == "auto":
            sweep = "fused"
        if sweep not in ("fused", "dense", "compact"):
            raise ValueError(f"unknown sweep {sweep!r}")
        self.sweep = sweep
        self.device = torch.device("cuda" if device is None else device)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.merge_every = max(int(merge_every), 1)
        self.dicti = dicti
        self.labelmap = build_labelmap(labelset)
        self.K = len(self.labelmap)
        self.vocab = dicti.values()
        self.w_to_v = dicti.token2id
        self.v_to_w = dicti.id2token
        self.V = len(dicti)
        self.D = len(docs)

        bows = [dicti.doc2bow(doc) for doc in docs]
        lab_mask = binarize_labels(labs, self.labelmap)
        # pad the topic axis; padded topics are masked off
        self.Kp = ((self.K + k_pad - 1) // k_pad) * k_pad
        lab_mask = np.pad(lab_mask, ((0, 0), (0, self.Kp - self.K)))
        self.topic_mask = self._t(np.arange(self.Kp) < self.K, torch.float32)

        self.buckets: BucketedDocs = bucket_encode(bows, n_buckets=n_buckets)
        self.n_tokens = int(sum(int(x.sum()) for x in self.buckets.tok_f))
        lab_ids, lab_valid = compact_labels(lab_mask)
        self.A = lab_ids.shape[1]
        ix = self.buckets.doc_idx
        self.toks_v = tuple(self._t(x, torch.int64) for x in self.buckets.tok_v)
        self.toks_f = tuple(self._t(x, torch.int64) for x in self.buckets.tok_f)
        self._toks_v_t = tuple(tv.T.contiguous() for tv in self.toks_v)
        self._toks_f_t = tuple(
            self._t(x.T, torch.float32) for x in self.buckets.tok_f)
        # per bucket (tok_v, tok_f as float32, token count): the perplexity's sums
        self._ll_toks = tuple((tv, tf.to(torch.float32), tf.sum().to(torch.float32))
                              for tv, tf in zip(self.toks_v, self.toks_f))
        self.lab_ids_t = tuple(self._t(lab_ids[i], torch.int64) for i in ix)
        self.lab_valid_t = tuple(self._t(lab_valid[i], torch.float32) for i in ix)
        self._lab_valid_tt = tuple(lv.T.contiguous() for lv in self.lab_valid_t)

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        if sweep == "dense":
            self.labs_t = tuple(self._t(lab_mask[i], torch.float32) for i in ix)
            self.counts = init_bucket_counts(
                self.toks_v, self.toks_f, self.labs_t, self.V, generator=self._gen)
        elif sweep == "compact":
            self.counts = init_bucket_counts_compact(
                self.toks_v, self.toks_f, self.lab_ids_t, self.lab_valid_t,
                self.V, self.Kp, generator=self._gen)
        else:
            self.counts = init_fused_buckets(
                self.toks_v, self.toks_f, self.lab_ids_t, self.lab_valid_t,
                self.V, self.Kp, generator=self._gen)

        self.ph_hat = torch.zeros((self.V, self.Kp), dtype=torch.float32,
                                  device=self.device)
        self._th_hat_t: Tuple[torch.Tensor, ...] = tuple(
            torch.zeros((len(ix), self.Kp), dtype=torch.float32, device=self.device)
            for ix in self.buckets.doc_idx)
        self._avg_s = 0  # number of thinned saves folded into ph_hat/th_hat
        self.cur_perplx: List[float] = []
        self._ll: Optional[List[LogLikelihood]] = None
        # the training runners, made at the first training call and kept
        self._fused: Optional[FusedBlocks] = None  # the fused path's merge blocks
        self._exact: Optional[ExactBuckets] = None  # the exact paths' sweeps
        self._save: Optional[SaveStep] = None  # the saves

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x)).to(
            device=self.device, dtype=dtype)

    # ---------------------------------------------------------------- train

    def _theta(self, g: int) -> torch.Tensor:
        """(D_g, Kp) label-masked θ of bucket ``g`` from the current counts."""
        ndk = self.counts.n_dk[g]
        if self.sweep == "dense":
            return theta_from_counts(ndk, self.labs_t[g], self.alpha)
        theta = theta_from_compact if self.sweep == "compact" else theta_from_fused
        return theta(ndk, self.lab_ids_t[g], self.lab_valid_t[g], self.alpha, self.Kp)

    def _cur_estimates(self):
        cur_ph = phi_from_counts(self.counts.n_vk, self.counts.n_k, self.beta,
                                 self.topic_mask)
        return cur_ph, tuple(self._theta(g) for g in range(self.buckets.n_buckets))

    def _saves(self) -> SaveStep:
        """The model's save runner (kept as ``_save``); ``ph_hat`` and the
        per-bucket θ̂ become its static means, and means that replaced them
        since (a checkpoint load) are copied in."""
        run = self._save
        if run is None:
            run = self._save = SaveStep(self.ph_hat, self._th_hat_t)
        elif not run.holds(self.ph_hat, self._th_hat_t):
            run.load(self.ph_hat, self._th_hat_t)
        self.ph_hat, self._th_hat_t = run.ph_hat, run.th_hat
        return run

    def run_training(
        self,
        iters: int,
        thinning: int,
        perplexity: bool = True,
        continue_avg: bool = False,
        total_iters: Optional[int] = None,
    ) -> None:
        """``iters`` Gibbs sweeps (reference run_training, LabeledLDA.py:127-153).

        Thinned φ̂/θ̂ saves land at exact ``thinning`` multiples and the
        trailing ``iters % thinning`` sweeps run unsaved.  The fused sampler
        runs in merge blocks of M (a divisor of ``thinning``, see
        ``select_merge_block``), so each save sees freshly committed counts
        and the last block is cut short; ``total_iters`` is the full planned
        sweep count of a chunked run, so its merge block matches the
        uninterrupted run's.  The exact samplers run sweep by sweep.
        ``continue_avg=True`` carries the running means across calls.  Every
        block or sweep and every save runs through the model's kept runners
        (on a card, replayed CUDA graphs).  The perplexities of the saves
        stay on the device until the call's end, where the positive ones are
        appended to ``cur_perplx`` in order.
        """
        iters, thinning = int(iters), int(thinning)
        if self.sweep == "fused":
            budget = int(total_iters) if total_iters else iters
            merge = select_merge_block(self.merge_every, thinning, budget)
            check_merge_block(self, merge)
            blocks = fused_blocks(self, self.alpha, self.beta)
        else:
            merge = 1
            blocks = exact_sweeps(self, self.alpha, self.beta)
        saves = self._saves()
        if not (continue_avg and self._avg_s > 0):
            saves.reset()
            self._avg_s = 0
        loglik = self._perplexity_of if perplexity else None
        perps = []
        n_save_blocks = iters // thinning
        for _ in range(n_save_blocks):
            for _ in range(thinning // merge):
                blocks(merge, generator=self._gen)
            self._avg_s += 1
            p = saves(self._avg_s, self._cur_estimates, loglik)
            if perplexity:
                perps.append(p.clone())
        left = iters - n_save_blocks * thinning
        while left > 0:
            m = min(merge, left)
            blocks(m, generator=self._gen)
            left -= m
        if self.sweep != "fused":
            blocks.doc_major()
        if perps:
            self.cur_perplx.extend(p for p in torch.stack(perps).tolist() if p > 0)
        self._check_ph_hat()

    def _perplexity_of(self, phi, thetas) -> torch.Tensor:
        """The training perplexity of a save, a float32 scalar on the
        device (``ops/gibbs.training_perplexity``, inside the save's body)."""
        return training_perplexity(phi, thetas, self._ll_toks)

    @property
    def th_hat(self) -> np.ndarray:
        """(D, Kp) thinned θ̂ in original document order (host array)."""
        return self.buckets.scatter_rows([t.cpu().numpy() for t in self._th_hat_t])

    def _check_ph_hat(self) -> None:
        """The reference's runtime guards (LabeledLDA.py:146-153)."""
        ph = self.ph_hat[:, : self.K]
        neg, nan, dead = torch.stack(
            [(ph < 0).any(), torch.isnan(ph).any(), (ph.sum(dim=1) == 0).any()]
        ).tolist()
        if neg:
            raise ValueError("A negative value occurred in ph_hat")
        if nan:
            raise ValueError("A nan has creeped into ph_hat")
        if dead:
            raise ValueError("A word in dictionary has no z-value")

    # ----------------------------------------------------------------- test

    def run_test(self, newdocs, it: int, thinning: int) -> np.ndarray:
        """Fold-in θ̂ for held-out documents (LabeledLDA.py:155-212); returns
        (n, K) including the root.

        z is initialised from φ̂'s column for each type (uniform over the
        real topics where that column is all zero); then ``it`` frozen-φ̂
        sweeps, averaging the normalised doc-topic counts at multiples of
        ``thinning``; trailing sweeps run unsaved, as in the reference.
        """
        with annotate("predict.prepare"):
            bows = [self.dicti.doc2bow(doc) for doc in newdocs]
            tv_np, tf_np = encode_bow_types(bows)
            tv, tf = self._t(tv_np, torch.int64), self._t(tf_np, torch.int64)
        avg = fold_in_test(self.ph_hat, tv, tf, self.topic_mask, self.alpha, it, thinning,
                           self._gen)
        with annotate("predict.scores"):
            return avg[:, : self.K].cpu().numpy()

    # ------------------------------------------------------------ estimators

    def get_phi(self) -> np.ndarray:
        """(K, V) smoothed φ — reference orientation (LabeledLDA.py:231-234)."""
        phi = phi_from_counts(self.counts.n_vk, self.counts.n_k, self.beta,
                              self.topic_mask)
        return phi[:, : self.K].T.cpu().numpy()

    def get_theta(self) -> np.ndarray:
        """(D, K) label-masked θ (LabeledLDA.py:236-239)."""
        per_bucket = [self._theta(g).cpu().numpy()
                      for g in range(self.buckets.n_buckets)]
        return self.buckets.scatter_rows(per_bucket)[:, : self.K]

    # ------------------------------------------------------------ diagnostics

    def get_pred(self, single_th: np.ndarray, n: int = 5):
        labels = np.array(list(self.labelmap.keys()))
        top = np.argsort(-single_th)[:n]
        return list(zip(labels[top], single_th[top]))

    def get_preds(self, all_th: np.ndarray, n: int = 5):
        with annotate("predict.rank"):
            return [self.get_pred(all_th[d], n) for d in range(all_th.shape[0])]

    def topwords_per_topic(self, topwords: int = 10):
        ph = self.get_phi()
        labels = list(self.labelmap.keys())
        out = []
        for k in range(self.K):
            idx = np.argsort(-ph[k])[:topwords]
            out.append([labels[k]] + [self.v_to_w[int(v)] for v in idx])
        return out

    def perplexity(self) -> float:
        """Training perplexity exp(−ll/N) of the current counts; the log
        likelihood is summed per bucket on the host in float64, as in the
        JAX model."""
        phi, thetas = self._cur_estimates()
        if self._ll is None:  # one LogLikelihood per bucket, kept (a replayed graph)
            self._ll = [LogLikelihood(tv, tf) for tv, tf in zip(self.toks_v, self.toks_f)]
        ll, n = 0.0, 0
        for run, th in zip(self._ll, thetas):
            llg, ng = run(th, phi)
            ll += float(llg)
            n += int(ng)
        return float(np.exp(-ll / max(n, 1)))
