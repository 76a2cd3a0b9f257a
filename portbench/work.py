"""The operations and bytes of the measured steps, counted from shapes.

A frozen copy of the arithmetic that ``chip_smoke.py`` uses for kernel 1's
bound (``bound``) and kernel 2's (``draw_bound``, ``sweep_bound_ms``),
with each formula's derivation beside it, so that a later change to the
program cannot change the yardstick.  Everything here is counted from the
corpus and the launch shapes, never timed, and is the same whatever
implements the step.

Labeled LDA's sampler moves one *type position* (a word type of a
document with its frequency f) per draw, over the document's label slots.
"""

from __future__ import annotations

from typing import Iterable, Sequence

from . import peaks

# float32 operations per (slot, type position, sweep) of the merge-block
# draw: the own-count select against the block-start slot and the live
# n_dk's decrement (2), +α and ·valid (2), cv − own and +β (2), the product
# (1), n_k − own and its reciprocal and product (3), the scan's add (1) and
# the comparison with u·total (1).
OPS_PER_SLOT_DRAW = 12

# float32 operations per (topic, type position, sweep) of a fold-in draw:
# n_dk + α, the product with φ̂[v, k], the cumsum's add, the comparison with
# u·total and the count of the comparisons.
OPS_PER_TOPIC_FOLDIN = 5

# HSLDA, per (token, topic) of a z draw: three logs and three adds of the
# collapsed-LDA weight, the Gumbel's add and the argmax's comparison; and
# per (token, topic, positive label) of the probit coupling: M − a, the
# product with η and the sum, and M's update.  The truncated normal's
# inverse CDF: about 30 per draw (two Φ, the clamp, ndtri, the reflection).
OPS_PER_TOPIC_Z = 8
OPS_PER_LABEL_TOPIC = 4
OPS_PER_TRUNCNORM = 30

# float32 operations per (word, topic) of a save's φ estimate (n_vk + β,
# n_k + Vβ, the division and the topic mask) and of a running mean's update
# (keep·avg, cur·(1/s), their sum).
OPS_PER_PHI_CELL = 4
OPS_PER_MEAN_CELL = 3


def kernel1_launch_bound_s(live_slots: int, live: int, U: int, D: int, slots: int,
                           M: int) -> float:
    """The least time of one kernel-1 launch on the card (``chip_smoke.bound``,
    counted as :func:`llda_sweep_ops` counts: padded slots and padded
    positions are the implementation's, not the algorithm's).

    ``live`` is the number of live positions (f > 0) of the launch,
    ``live_slots`` the sum over them of their document's label slots (the
    root included), ``slots`` the sum of the documents' label slots.
    Bytes: f and z read once and z written once (3·U·D words); the
    per-slot inputs nkg, valid and n_dk read and n_dk written (4·slots);
    at each live position its document's cv entries (``live_slots``) and
    its M uniforms.  Operations: ``OPS_PER_SLOT_DRAW`` per label slot of a
    live position and sweep.  The bound is the larger of bytes over HBM
    bandwidth and operations over the float32 peak."""
    n_bytes = 4 * (live_slots + live * M + 3 * U * D + 4 * slots)
    n_ops = OPS_PER_SLOT_DRAW * live_slots * M
    return max(n_bytes / peaks.HBM_BYTES_PER_S, n_ops / peaks.FP32_FLOP_PER_S)


def llda_sweep_ops(types_per_doc: Sequence[int], labels_per_doc: Sequence[int]) -> int:
    """Operations of one collapsed-Gibbs sweep of Labeled LDA: every type
    position of every document draws over that document's labels (the
    root included), ``OPS_PER_SLOT_DRAW`` each.  Padded slots and padded
    positions are the implementation's, not the algorithm's, and are not
    counted."""
    return OPS_PER_SLOT_DRAW * sum(int(t) * int(l)
                                   for t, l in zip(types_per_doc, labels_per_doc))


def llda_save_ops(V: int, K: int, labels_per_doc: Iterable[int]) -> int:
    """Operations of one thinned save: φ's estimate and mean over V·K cells
    and θ's estimate and mean over each document's labels (its other
    topics are zero)."""
    theta_cells = sum(int(l) for l in labels_per_doc)
    return (OPS_PER_PHI_CELL + OPS_PER_MEAN_CELL) * V * K \
        + (OPS_PER_PHI_CELL + OPS_PER_MEAN_CELL) * theta_cells


def foldin_ops(positions_per_doc: Sequence[int], K: int, sweeps: int) -> int:
    """Operations of a fold-in of these documents: ``sweeps`` frozen-φ̂
    sweeps and the init pass, each position (a type for Labeled LDA, a
    token for HSLDA) drawing over the ``K`` real topics."""
    return OPS_PER_TOPIC_FOLDIN * K * sum(int(t) for t in positions_per_doc) * (int(sweeps) + 1)


def hslda_cycle_ops(tokens_per_doc: Sequence[int], labels_per_doc: Sequence[int], K: int,
                    L: int, S: int) -> int:
    """Operations of one HSLDA blocked-Gibbs cycle with the coupling of
    ``--opt 1``.

    z: each token draws over K topics, ``OPS_PER_TOPIC_Z`` each for the
    collapsed-LDA weight and the Gumbel-max, and ``OPS_PER_LABEL_TOPIC``
    for each of its document's positive labels (M − a, its product with
    η_lk and the sum, and M's update); only positive labels couple.
    η: the Gram terms z̄ᵀz̄ and z̄ᵀa (2·D·K² + 2·D·K·L), the Cholesky factor
    (K³/3) and the two solves with the draw (6·K²·L).  a: the means z̄ηᵀ
    (2·D·K·L) and ``OPS_PER_TRUNCNORM`` per (document, label).  m: three
    per (document, topic, table count).  β: a few per topic, not counted."""
    D = len(tokens_per_doc)
    z = sum(int(n) * K * (OPS_PER_TOPIC_Z + OPS_PER_LABEL_TOPIC * int(l))
            for n, l in zip(tokens_per_doc, labels_per_doc))
    eta = 2 * D * K * K + 2 * D * K * L + K ** 3 // 3 + 6 * K * K * L
    a = 2 * D * K * L + OPS_PER_TRUNCNORM * D * L
    return z + eta + a + 3 * D * K * S
