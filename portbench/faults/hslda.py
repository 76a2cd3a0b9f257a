"""Faults under HSLDA's calls, by the traffic's ``call``: the training
cycle (``train``) and the fold-in with its label probabilities
(``predict``)."""

from __future__ import annotations

import torch

from portbench.faults.labeled_lda import _foldin


def _hslda_cycle(kind):
    """HSLDA's cycle broken: the z-sweep's state unchanged or half of the
    documents left out; or the thinned φ̂, the call's answer, altered where
    the save makes it."""
    from lda_thesis_tpu_torch.models import hslda

    if kind == "altered":
        real_estimates = hslda.HSLDA._estimates

        def altered(self):
            ph, th = real_estimates(self)
            ph = ph.clone()
            ph[0, 0] += 0.01
            return ph, th

        return "lda_thesis_tpu_torch.models.hslda.HSLDA._estimates", altered
    real = hslda._sweep_

    def broken(st, z_t, n_dk, n_vk, n_k, M, *rest):
        if kind == "half":
            keep = torch.ones_like(st.m_t)
            keep[:, st.D // 2:] = 0
            st = st._replace(m_t=st.m_t * keep, neg_m_t=st.neg_m_t * keep,
                             mf_t=st.mf_t * keep[:, :, None])
            real(st, z_t, n_dk, n_vk, n_k, M, *rest)

    return "lda_thesis_tpu_torch.models.hslda._sweep_", broken


def _hslda_predict(kind):
    """HSLDA's fold-in broken as Labeled LDA's; or the label probabilities,
    the request's answer, altered where they are made."""
    if kind != "altered":
        return _foldin(kind)
    from lda_thesis_tpu_torch.models import hslda

    real = hslda.chain_scores

    def altered(*a, **k):
        out = real(*a, **k)
        out[0, 0] += 0.01
        return out

    return "lda_thesis_tpu_torch.models.hslda.chain_scores", altered


FAULTS = {"train": _hslda_cycle, "predict": _hslda_predict}
