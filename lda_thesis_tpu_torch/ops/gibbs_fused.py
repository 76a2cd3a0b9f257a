"""Merge-block collapsed-Gibbs sampler for Labeled LDA, on tensors.

Counterpart of ``lda_thesis_tpu/ops/gibbs_fused.py``.  A merge block runs
``M`` sweeps against a topic-word table frozen at block start (each slot's
own block-start count is excluded exactly), with the doc-topic counts live
throughout; then one scatter commits the block's count deltas.  Per block:

1. :func:`gather_cv` reads the frozen per-slot counts, one element gather;
2. the frozen totals are picked per slot (``n_k[lab_ids]``, pre-biased by V·β);
3. the block's uniforms are drawn;
4. the sampler runs: the CUDA kernel on a card, its plain version on the
   CPU (:mod:`.fused_block_cuda`);
5. :func:`_scatter_deltas` commits ``f`` from each slot's first to its last
   topic.

All per-document state lives on the compact A-slot label axis; ``z`` is
position-major ``(U, D)`` and ``n_dk`` is ``(A, D)``, as in the JAX package.

**Chains.**  The merge block (steps 1–5 and :func:`fused_train_block`,
:func:`fused_train_block_buckets`) also takes a leading chain axis: ``z (L,
U, D)``, ``n_dk (L, A, D)``, ``n_vk (L, V, K)``, ``n_k (L, K)``, one table
per chain over the same documents.  The ``L`` chains' documents are laid
side by side on the kernel's document axis (``L·D`` documents, chain-major),
so one launch runs every chain; the kernel computes each document alone
and every count update is an exact integer sum, so the result is bitwise
that of ``L`` single-chain calls with the same uniforms.  The distributed
trainer (parallel/) runs its local chains this way.

**Replayed blocks.**  A training loop runs its merge blocks through
:class:`FusedBlocks`, which keeps the state in static tensors and, on a
card, replays each block as one CUDA graph (kernel 1 inside it), as the
JAX package runs its blocks inside one jitted program
(``lda_thesis_tpu/models/labeled_lda.py:248-349``).  Its body is
:func:`fused_train_block_buckets` itself, so a replay has the eager bits.
"""

from __future__ import annotations

import sys
from typing import NamedTuple, Optional, Sequence, Tuple

import torch

from ..utils.tracing import annotate, count
from . import fused_block_cuda as fbc
from .fused_block_cuda import fused_block
from .gibbs import (
    _copy_state,
    _Replayed,
    _state_tensors,
    _StaticState,
    _uniforms,
    densify_ndk,
    fill_uniforms,
    init_counts_compact,
    theta_from_compact,
)

# Bumped whenever the port's fused sampler changes its floating-point
# operation order (in fused_block.cu and fused_block_torch together).
# Checkpoints of a fused run carry this stamp; utils/checkpoint.restore_model
# warns when a chain recorded under another version is resumed, since its
# draws are then no longer bit-identical to the uninterrupted run.  The JAX
# package keeps its own numbering.
SAMPLER_FORMULA_VERSION = 1

# The merge-block kernel takes its document count as a C int (its offsets
# are size_t), so one launch holds fewer than 2^31 documents.
MAX_KERNEL_DOCS = 2**31 - 1

# Number of topic-word table entries that :func:`gather_cv` has read since
# import (or since a caller reset it), one per element gathered.
# :class:`FusedBlocks` names it among its replayed counters.
table_entries = 0

__all__ = [
    "SAMPLER_FORMULA_VERSION",
    "MAX_KERNEL_DOCS",
    "FusedLDAState",
    "FusedBucketState",
    "select_merge_block",
    "init_fused",
    "init_fused_buckets",
    "fused_train_block",
    "fused_train_block_buckets",
    "FusedBlocks",
    "gather_cv",
    "slot_totals",
    "block_uniforms",
    "theta_from_fused",
    "densify_ndk_fused",
]


class FusedLDAState(NamedTuple):
    """Gibbs state in the fused layout.

    ``z (U, D)`` int32 compact slot of each type position, ``n_dk (A, D)``
    compact doc-topic counts, ``n_vk (V, K)`` / ``n_k (K,)`` dense tables.
    """

    z: torch.Tensor
    n_dk: torch.Tensor
    n_vk: torch.Tensor
    n_k: torch.Tensor


class FusedBucketState(NamedTuple):
    """Fused-layout state over length buckets: per-bucket ``z (U_g, D_g)``
    and ``n_dk (A, D_g)``, shared global tables."""

    z: Tuple[torch.Tensor, ...]
    n_dk: Tuple[torch.Tensor, ...]
    n_vk: torch.Tensor
    n_k: torch.Tensor


def select_merge_block(merge_every: int, thinning: int, budget: int) -> int:
    """Merge-block size M for a training run.

    Largest divisor of ``thinning`` ≤ ``merge_every`` — so thinned saves
    always land on freshly committed counts — additionally capped at
    ``budget // 8`` for tiny total budgets: freezing the table for half of
    a 4-sweep run costs real AUC (measured ~−0.03 at the reference's (4; 4)
    config, PARITY.md), while at thesis scale the cap is inactive.  Both
    the single-chip model and the distributed trainer MUST use this one
    function: chunk-invariant (bit-identical) resume requires the same M
    for the chunked and the uninterrupted run, which is why ``budget`` is
    the *total planned* sweeps, not the current call's.
    """
    cap = min(int(merge_every), max(1, int(budget) // 8))
    return max((m for m in range(1, cap + 1) if int(thinning) % m == 0),
               default=1)


def gather_cv(n_vk: torch.Tensor, tok_v_t: torch.Tensor,
              lab_ids: torch.Tensor) -> torch.Tensor:
    """Per-slot topic-word counts ``n_vk[v_ud, lab_ids[d, a]]``, shape (D, U, A).

    Doc-major, so the kernel reads one document's A slots at one position as
    one contiguous row (the JAX function returns the (U, A, D) transpose).
    An element gather is exact, so no one-hot contraction is needed.  With
    ``n_vk (L, V, K)``: ``(L·D, U, A)``, the chains' documents side by side.
    """
    global table_entries
    v = tok_v_t.T.long()[:, :, None]
    a = lab_ids.long()[:, None, :]
    if n_vk.dim() == 2:
        cv = n_vk[v, a]
    else:
        chain = torch.arange(n_vk.shape[0], device=n_vk.device)[:, None, None, None]
        cv = n_vk[chain, v, a].flatten(0, 1)
    table_entries += cv.numel()
    return cv


def slot_totals(n_k: torch.Tensor, lab_ids: torch.Tensor, vbeta: float) -> torch.Tensor:
    """(A, D) frozen topic totals per slot, ``n_k[lab_ids[d, a]] + V·β``;
    with ``n_k (L, K)``: (A, L·D)."""
    t = n_k[..., lab_ids.long()]  # (..., D, A)
    return (t.movedim(-1, 0).reshape(t.shape[-1], -1) + vbeta).contiguous()


def _side_by_side(x: torch.Tensor) -> torch.Tensor:
    """``(L, ..., D)`` -> ``(..., L·D)``: the chains' documents side by side."""
    return x.movedim(0, -2).flatten(-2)


def _split_chains(x: torch.Tensor, L: int) -> torch.Tensor:
    """``(..., L·D)`` -> ``(L, ..., D)``."""
    return x.unflatten(-1, (L, -1)).movedim(-2, 0).contiguous()


def block_uniforms(shape, like: torch.Tensor, uniforms=None, generator=None) -> torch.Tensor:
    """A merge block's uniforms of ``shape``: ``uniforms`` if given, else
    drawn from ``generator``; a sequence of generators, one per chain, draws
    ``shape[1:]`` from each in chain order."""
    if uniforms is not None or not isinstance(generator, (list, tuple)):
        return _uniforms(shape, like, uniforms, generator)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for {shape[0]} chains")
    u = torch.empty(shape, dtype=torch.float32, device=like.device)
    for j, gen in enumerate(generator):
        torch.rand(shape[1:], generator=gen, out=u[j])
    return u


def _scatter_deltas(n_vk, tok_v_t, tok_f_t, lab_ids, z0, z1):
    """Commit a block's count deltas: only each slot's first and last z matter.

    One accumulating scatter of −f at the block-start topic and +f at the
    block-end topic into a copy of the table; exact in any order (integer
    counts below 2^24), so ``index_add_``'s atomics on a card give the same
    table as a sequential sum.  With ``n_vk (L, V, K)``, ``z0``/``z1`` are
    ``(U, L·D)``, the chains side by side.
    """
    V, K = n_vk.shape[-2:]
    U, D = tok_v_t.shape
    L = n_vk.shape[0] if n_vk.dim() == 3 else 1
    lab_t = lab_ids.long().T[:, None, :].expand(-1, L, -1)  # (A, L, D)
    row = tok_v_t.long()[:, None, :] * K  # (U, 1, D)
    if n_vk.dim() == 3:
        row = row + torch.arange(L, device=row.device)[:, None] * (V * K)  # (U, L, D)
    flat = torch.cat([(row + torch.gather(lab_t, 0, z.long().view(U, L, D))).reshape(-1)
                      for z in (z0, z1)])
    f = tok_f_t.reshape(U, 1, D).expand(U, L, D).reshape(-1)
    n_vk = n_vk.clone()
    n_vk.view(-1).index_add_(0, flat, torch.cat([-f, f]))
    return n_vk, n_vk.sum(dim=-2)


def fused_train_block(
    state: FusedLDAState,
    tok_v_t: torch.Tensor,  # (U, D) int, position-major
    tok_f_t: torch.Tensor,  # (U, D) float32
    lab_ids: torch.Tensor,  # (D, A) int
    lab_valid_t: torch.Tensor,  # (A, D) float32
    alpha: float,
    beta: float,
    M: int,
    uniforms: Optional[torch.Tensor] = None,  # (M, U, D); chains: (L, M, U, D)
    generator=None,  # chains: one per chain
    vbeta: Optional[float] = None,
) -> FusedLDAState:
    """``M`` Gibbs sweeps against the block-start table + one delta commit.

    ``vbeta`` — the posterior denominator's smoothing constant ``V*beta``
    (LabeledLDA.py:116); defaults to the table's own row count times β,
    which is exact for unpadded tables.  A state with a leading chain axis
    runs every chain in one kernel launch (module docstring).
    """
    U, D = tok_v_t.shape
    V = state.n_vk.shape[-2]
    if vbeta is None:
        vbeta = float(V * beta)
    L = state.n_vk.shape[0] if state.n_vk.dim() == 3 else 0
    if max(L, 1) * D > MAX_KERNEL_DOCS:
        raise ValueError(f"{max(L, 1)} chains x {D} documents exceed the merge-block "
                         f"kernel's {MAX_KERNEL_DOCS} documents per launch")
    cv = gather_cv(state.n_vk, tok_v_t, lab_ids)
    nkg = slot_totals(state.n_k, lab_ids, vbeta)
    lead = (L,) if L else ()
    u = block_uniforms(lead + (M, U, D), tok_v_t, uniforms, generator)
    z0, ndk0, f, valid = state.z, state.n_dk, tok_f_t, lab_valid_t
    if L:
        u, z0, ndk0 = _side_by_side(u), _side_by_side(z0), _side_by_side(ndk0)
        f, valid = f.repeat(1, L), valid.repeat(1, L)
    z1, ndk = fused_block(cv, f.contiguous(), u.contiguous(), z0.contiguous(), nkg,
                          valid.contiguous(), ndk0.contiguous(), alpha, beta)
    n_vk, n_k = _scatter_deltas(state.n_vk, tok_v_t, tok_f_t, lab_ids, z0, z1)
    if L:
        z1, ndk = _split_chains(z1, L), _split_chains(ndk, L)
    return FusedLDAState(z=z1, n_dk=ndk, n_vk=n_vk, n_k=n_k)


def init_fused(
    tok_v: torch.Tensor,  # (D, U) int, doc-major
    tok_f: torch.Tensor,  # (D, U) int
    lab_ids: torch.Tensor,  # (D, A)
    lab_valid: torch.Tensor,  # (D, A)
    V: int,
    K: int,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> FusedLDAState:
    """z ~ uniform over each doc's admissible labels (LabeledLDA.py:85-92),
    in the fused (position-major / (A, D)) layout."""
    c = init_counts_compact(tok_v, tok_f, lab_ids, lab_valid, V, K,
                            uniforms=uniforms, generator=generator)
    return FusedLDAState(z=c.z.T.contiguous(), n_dk=c.n_dk.T.contiguous(),
                         n_vk=c.n_vk, n_k=c.n_k)


def init_fused_buckets(
    toks_v: Sequence[torch.Tensor],
    toks_f: Sequence[torch.Tensor],
    lab_ids_t: Sequence[torch.Tensor],
    lab_valid_t: Sequence[torch.Tensor],
    V: int,
    K: int,
    uniforms: Optional[Sequence[torch.Tensor]] = None,  # per bucket (U_g, D_g)
    generator: Optional[torch.Generator] = None,
) -> FusedBucketState:
    """Per-bucket :func:`init_fused` with shared global tables."""
    zs, ndks = [], []
    n_vk = n_k = None
    for g, (tv, tf, li, lv) in enumerate(zip(toks_v, toks_f, lab_ids_t, lab_valid_t)):
        c = init_fused(tv, tf, li, lv, V, K,
                       uniforms=None if uniforms is None else uniforms[g],
                       generator=generator)
        zs.append(c.z)
        ndks.append(c.n_dk)
        n_vk = c.n_vk if n_vk is None else n_vk + c.n_vk
        n_k = c.n_k if n_k is None else n_k + c.n_k
    return FusedBucketState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


def fused_train_block_buckets(
    state: FusedBucketState,
    toks_v_t: Sequence[torch.Tensor],  # per bucket (U_g, D_g)
    toks_f_t: Sequence[torch.Tensor],  # per bucket (U_g, D_g) float32
    lab_ids_t: Sequence[torch.Tensor],  # per bucket (D_g, A)
    lab_valid_tt: Sequence[torch.Tensor],  # per bucket (A, D_g)
    alpha: float,
    beta: float,
    M: int,
    uniforms: Optional[Sequence[torch.Tensor]] = None,  # per bucket (M, U_g, D_g)
    generator=None,
    vbeta: Optional[float] = None,
) -> FusedBucketState:
    """One ``M``-sweep merge block over all buckets, one after another; each
    bucket's delta commit lands before the next bucket gathers.  With a
    leading chain axis, one kernel launch per bucket runs every chain."""
    n_vk, n_k = state.n_vk, state.n_k
    zs, ndks = [], []
    for g, (tv, tf, li, lv) in enumerate(
        zip(toks_v_t, toks_f_t, lab_ids_t, lab_valid_tt)
    ):
        st = FusedLDAState(z=state.z[g], n_dk=state.n_dk[g], n_vk=n_vk, n_k=n_k)
        st = fused_train_block(
            st, tv, tf, li, lv, alpha, beta, M,
            uniforms=None if uniforms is None else uniforms[g],
            generator=generator, vbeta=vbeta,
        )
        n_vk, n_k = st.n_vk, st.n_k
        zs.append(st.z)
        ndks.append(st.n_dk)
    return FusedBucketState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


class FusedBlocks(_StaticState, _Replayed):
    """Repeated merge blocks (:func:`fused_train_block_buckets`) over one
    static state, which every call updates in place: the runner of a
    training loop's blocks (JAX: the merge-block scan of
    ``lda_thesis_tpu/models/labeled_lda.py:248-349``).

    ``state`` (a :class:`FusedBucketState`, with or without a leading chain
    axis) is copied into the runner's own tensors, ``self.state``.  A call
    ``run(M, generator)`` fills one static uniforms buffer per bucket,
    ``(M, U_g, D_g)`` or ``(L, M, U_g, D_g)``, outside any graph and in the
    eager order (bucket by bucket, and within a bucket chain by chain, each
    chain from its own generator, as :func:`block_uniforms` draws them),
    then runs the body: :func:`fused_train_block_buckets` on the static
    state and uniforms, its outputs copied into the static state.  So a call
    has the bits of the eager block by construction.  Under
    :class:`_Replayed`'s rule the body of each M (a call's trailing block
    may be shorter) is captured once as a CUDA graph on a card and replayed,
    kernel 1's launches inside it; the replay adds them to the wrappers'
    counters.  Nothing outside the runner may keep the body's outputs: they
    live in the graph's pool.  A state set from elsewhere is taken in by
    :meth:`load` (``holds``/``load``: ``ops/gibbs._StaticState``).  A call
    is the span ``merge_block``.

    A call counts ``merge_block.table_entries``, the topic-word table
    entries that its body read (the module counter ``table_entries``, which
    :func:`gather_cv` counts: D·U·A per bucket, the chains' documents side
    by side), and ``merge_block.live_table_entries``, the entries of live
    positions (f > 0) on valid slots, which a block needs whatever reads
    them: a number of the layout, taken at construction.
    """

    _layer = "merge_block"
    _counters = ((fbc, ("launches", "warp_launches", "wide_launches", "general_launches")),
                 (sys.modules[__name__], ("table_entries",)))

    def __init__(self, state: FusedBucketState, toks_v_t, toks_f_t, lab_ids_t, lab_valid_tt,
                 alpha: float, beta: float, vbeta: Optional[float] = None):
        super().__init__(state.n_vk.device)
        self.state = _copy_state(FusedBucketState(*state))
        self._inputs = tuple(tuple(x) for x in (toks_v_t, toks_f_t, lab_ids_t, lab_valid_tt))
        self._consts = (float(alpha), float(beta))
        self._vbeta = vbeta
        self._u = {}  # M -> per-bucket static uniforms
        chains = state.n_vk.shape[0] if state.n_vk.dim() == 3 else 1
        self._live_entries = chains * sum(
            int(((tf > 0).sum(dim=0) * (lv > 0).sum(dim=0)).sum())
            for tf, lv in zip(toks_f_t, lab_valid_tt))

    def _body(self, u) -> None:
        M = u[0].shape[-3]
        out = fused_train_block_buckets(self.state, *self._inputs, *self._consts, M,
                                        uniforms=u, vbeta=self._vbeta)
        for dst, src in zip(_state_tensors(self.state), _state_tensors(out)):
            dst.copy_(src)

    def __call__(self, M: int, generator=None,
                 uniforms: Optional[Sequence[torch.Tensor]] = None) -> FusedBucketState:
        """One ``M``-sweep merge block; returns the static state.
        ``generator``: a ``torch.Generator``, or one per chain; or
        ``uniforms`` per bucket."""
        M = int(M)
        read = table_entries
        with annotate(self._layer):
            u = self._u.get(M)
            if u is None:
                lead = tuple(self.state.n_vk.shape[:-2])
                u = self._u[M] = tuple(
                    torch.empty(lead + (M, *tv.shape), dtype=torch.float32, device=tv.device)
                    for tv in self._inputs[0])
            for g, ug in enumerate(u):
                fill_uniforms(ug, generator, None if uniforms is None else uniforms[g])
            self._run(M, lambda: self._body(u))
        count(f"{self._layer}.table_entries", table_entries - read)
        count(f"{self._layer}.live_table_entries", self._live_entries)
        return self.state

    def __getstate__(self):
        state = super().__getstate__()
        state["_u"] = {}  # scratch, drawn anew every call
        return state


def densify_ndk_fused(n_dk_t: torch.Tensor, lab_ids: torch.Tensor, K: int) -> torch.Tensor:
    """(A, D) compact counts -> dense (D, K)."""
    return densify_ndk(n_dk_t.T, lab_ids, K)


def theta_from_fused(n_dk_t, lab_ids, lab_valid, alpha: float, K: int) -> torch.Tensor:
    """Dense (D, K) label-masked θ (LabeledLDA.py:236-239); ``lab_valid (D, A)``.
    The counts are taken doc-major (a contiguous copy), so each document's
    sum over its slots has the same bits whatever other rows lie beside it:
    a rank's chains side by side (``parallel/fused_sharded.theta_chains``)
    give each chain's single-chain θ."""
    return theta_from_compact(n_dk_t.T.contiguous(), lab_ids, lab_valid, alpha, K)
