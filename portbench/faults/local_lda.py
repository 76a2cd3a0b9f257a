"""Faults under LocalLDA's training call: the merge block's sampler (kernel
1, as under Labeled LDA's) and the thinned φ̂."""

from __future__ import annotations

from portbench.faults.labeled_lda import _llda_block


def _local_lda(kind):
    """Kernel 1 broken (``unchanged``, ``half``), or the φ̂ that each save
    averages altered where the model estimates it (``altered``)."""
    if kind != "altered":
        return _llda_block(kind)
    from lda_thesis_tpu_torch.models import local_lda

    real = local_lda.phi_from_counts

    def altered(*a, **k):
        out = real(*a, **k)
        out[0, 0] *= 1.01
        return out

    return "lda_thesis_tpu_torch.models.local_lda.phi_from_counts", altered


FAULTS = {"train": _local_lda}
