"""Labeled LDA trained by variational inference (CAVI or SVI), on PyTorch.

Counterpart of ``lda_thesis_tpu/models/labeled_lda_vi.py``: the same
constructor and estimator surface as the collapsed-Gibbs ``LabeledLDA``,
with deterministic optimisation instead of sampling.  ``fit()`` runs batch
CAVI (monotone ELBO); ``fit_svi()`` runs stochastic VI with a Robbins-Monro
step-size schedule; held-out inference reuses the CAVI machinery with λ
frozen.  The model runs on ``device`` (CUDA unless the caller passes
``"cpu"``); λ's start noise and SVI's minibatch permutations come from one
``torch.Generator`` seeded by ``seed``, so they differ from the JAX
package's draws.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..data.encode import binarize_labels, build_labelmap, encode_bow_types
from ..ops.gibbs import LogLikelihood
from ..ops.vi import VIState, _expect_logs, _gamma_stats, cavi_step, svi_epoch, vi_init

__all__ = ["LabeledLDAVI"]


class LabeledLDAVI:
    """Label-constrained LDA with mean-field variational inference."""

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
        device=None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.dicti = dicti
        self.labelmap = build_labelmap(labelset)
        self.K = len(self.labelmap)
        self.V = len(dicti)
        self.D = len(docs)
        self.v_to_w = dicti.id2token

        bows = [dicti.doc2bow(doc) for doc in docs]
        tok_v, tok_f = encode_bow_types(bows)
        lab_mask = binarize_labels(labs, self.labelmap)

        self.Kp = ((self.K + k_pad - 1) // k_pad) * k_pad
        lab_mask = np.pad(lab_mask, ((0, 0), (0, self.Kp - self.K)))
        self.tok_v = self._t(tok_v, torch.int64)
        self.tok_f = self._t(tok_f, torch.int64)
        self.n_tokens = int(tok_f.sum())
        self.labs = self._t(lab_mask, torch.float32)

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))
        self.state = vi_init(self.labs, self.V, self.alpha, self.beta, generator=self._gen)
        self.elbo_history: List[float] = []
        self._ll = LogLikelihood(self.tok_v, self.tok_f)  # on a card a replayed CUDA graph

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------ train

    def fit(self, iters: int = 50, tol: float = 1e-4) -> None:
        """Batch CAVI until ``iters`` or relative-ELBO convergence."""
        prev = -np.inf
        for _ in range(int(iters)):
            self.state, e = cavi_step(self.state, self.tok_v, self.tok_f, self.labs,
                                      self.alpha, self.beta)
            e = float(e)
            self.elbo_history.append(e)
            if np.isfinite(prev) and abs(e - prev) <= tol * abs(prev):
                break
            prev = e

    def fit_svi(
        self,
        epochs: int = 60,
        batch_size: int = 2048,
        tau: float = 1.0,
        kappa: float = 0.8,
        local_iters: int = 1,
    ) -> None:
        """Stochastic VI (Hoffman '13): ρ_t = (τ₀ + t)^−κ per global
        minibatch update, ``local_iters`` inner γ iterations per batch; the
        defaults are the JAX package's (its benchmarks/svi_sweep.py winner).
        Ends with one full CAVI pass, whose ELBO is recorded."""
        batch_size = min(batch_size, self.D)
        n_batches = max(self.D // batch_size, 1)
        for t in range(int(epochs)):
            self.state = svi_epoch(
                self.state, self.tok_v, self.tok_f, self.labs, self.alpha, self.beta,
                t * n_batches, batch_size, local_iters=int(local_iters), tau=float(tau),
                kappa=float(kappa), generator=self._gen)
        self.state, e = cavi_step(self.state, self.tok_v, self.tok_f, self.labs,
                                  self.alpha, self.beta)
        self.elbo_history.append(float(e))

    # ------------------------------------------------------------ estimators

    def get_phi(self) -> np.ndarray:
        """(K, V) posterior-mean topic-word distribution."""
        lam = self.state.lam[:, : self.K].cpu().numpy()
        return (lam / lam.sum(axis=0, keepdims=True)).T

    def get_theta(self) -> np.ndarray:
        """(D, K) posterior-mean doc-topic distribution (masked)."""
        g = self.state.gamma[:, : self.K].cpu().numpy()
        return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-38)

    # ------------------------------------------------------------------- test

    def infer(self, newdocs: Sequence[Sequence[str]], iters: int = 50) -> np.ndarray:
        """Fold-in θ̂ for held-out docs: CAVI on γ with λ frozen, every real
        topic admissible (the Gibbs fold-in's unconstrained test inference,
        LabeledLDA.py:185-194).  Only γ is updated, so the λ statistics and
        the ELBO that the JAX function computes and drops are skipped."""
        bows = [self.dicti.doc2bow(doc) for doc in newdocs]
        tok_v, tok_f = encode_bow_types(bows)
        tok_v, tok_f = self._t(tok_v, torch.int64), self._t(tok_f, torch.int64)
        mask = torch.zeros((tok_v.shape[0], self.Kp), dtype=torch.float32,
                           device=self.device)
        mask[:, : self.K] = 1.0
        sub = VIState(gamma=mask * self.alpha + mask, lam=self.state.lam)
        for _ in range(int(iters)):
            el_theta, el_beta = _expect_logs(sub, mask)
            sub = VIState(gamma=mask * self.alpha
                          + _gamma_stats(tok_v, tok_f, el_theta, el_beta),
                          lam=self.state.lam)
        g = sub.gamma[:, : self.K].cpu().numpy()
        return g / np.maximum(g.sum(axis=1, keepdims=True), 1e-38)

    # ------------------------------------------------------------ diagnostics

    def perplexity(self) -> float:
        theta = torch.from_numpy(self.get_theta()).to(self.device)
        phi_vk = torch.from_numpy(np.ascontiguousarray(self.get_phi().T)).to(self.device)
        ll, ntok = self._ll(theta, phi_vk)
        return float(np.exp(-float(ll) / max(int(ntok), 1)))

    def topwords_per_topic(self, topwords: int = 10):
        ph = self.get_phi()
        labels = list(self.labelmap.keys())
        out = []
        for k in range(self.K):
            idx = np.argsort(-ph[k])[:topwords]
            out.append([labels[k]] + [self.v_to_w[int(v)] for v in idx])
        return out
