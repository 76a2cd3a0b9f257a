"""Faults under Labeled LDA's calls, by the traffic's ``call``: the merge
block's sampler (``train``) and the fold-in (``predict``)."""

from __future__ import annotations

import torch


def _llda_block(kind):
    """Kernel 1 (the merge block's sampler) broken: its state unchanged,
    half of the documents left out, or one draw altered where it is made."""
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    real = fbc.fused_block

    def broken(cv, f, u, z0, nkg, valid, ndk0, alpha, beta):
        if kind == "unchanged":
            return z0.clone(), ndk0.clone()
        z, ndk = real(cv, f, u, z0, nkg, valid, ndk0, alpha, beta)
        if kind == "half":
            h = z.shape[1] // 2
            z[:, h:], ndk[:, h:] = z0[:, h:], ndk0[:, h:]
        else:  # one live position of a two-slot document moved to its other slot
            p, d = [int(i) for i in torch.nonzero((f > 0) & (valid[1] > 0)[None])[0]]
            new = 1 - int(z[p, d]) if int(z[p, d]) < 2 else 0
            ndk[int(z[p, d]), d] -= f[p, d]
            ndk[new, d] += f[p, d]
            z[p, d] = new
        return z, ndk

    return "lda_thesis_tpu_torch.ops.gibbs_fused.fused_block", broken


def _foldin(kind):
    """The fold-in sweep broken: state unchanged or half of the documents
    left out; or one document's θ̂ altered where the fold-in returns it."""
    from lda_thesis_tpu_torch.models import labeled_lda
    from lda_thesis_tpu_torch.ops import gibbs

    if kind == "altered":
        real = labeled_lda.fold_in_test

        def altered(*a, **k):
            out = real(*a, **k)
            out[0, 0] += 0.01
            return out

        return "lda_thesis_tpu_torch.models.labeled_lda.fold_in_test", altered
    real = gibbs._foldin_positions

    def broken(z, n_dk, tv, ff, phi, alpha, u):
        if kind == "half":
            h = z.shape[0] // 2
            a = alpha[:h] if torch.is_tensor(alpha) and alpha.dim() == 2 else alpha
            real(z[:h], n_dk[:h], tv[:h], ff[:h], phi, a, u[:, :h])

    return "lda_thesis_tpu_torch.ops.gibbs._foldin_positions", broken


FAULTS = {"train": _llda_block, "predict": _foldin}
