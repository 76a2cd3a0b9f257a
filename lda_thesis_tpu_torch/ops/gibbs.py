"""Collapsed-Gibbs sweeps and their helpers, on tensors.

Counterpart of ``lda_thesis_tpu/ops/gibbs.py``: the dense and compact-support
inits, the exact per-position sweeps (dense through the CUDA draw and
count-commit kernels, :mod:`.draw_update_cuda`, replayed as one CUDA graph
per sweep state by :class:`ExactSweep`; compact in plain PyTorch, replayed
the same way by :class:`CompactSweep`) and their bucket variants, the
compact → dense doc-topic helpers, the frozen-φ fold-in sweep, CascadeLDA's
batched node-level fold-in and the training log-likelihood.  The last three
are JAX scans that a model runs again and again: :class:`FoldinSweep`
(one kernel launch per sweep, :mod:`.foldin_cuda`), :class:`CascadeSweep`
and :class:`LogLikelihood` replay each as one CUDA graph per sweep (or
sum) on a card, with the bits of the eager function.
A training loop's exact sweeps live in :class:`ExactBuckets` (one runner
per bucket over a static state, kept across calls) and its saves in
:class:`SaveStep` (the estimates, the thinned means and the perplexity as
one graph).  Every runner follows one replay rule (``_Replayed``), which
the fused merge block's runner (``ops/gibbs_fused.FusedBlocks``) shares.
Counts are float32 tensors holding integers below 2^24, so every count
update is exact in any order.

An exact sweep visits the type positions in order; at each position all
documents decrement their counts, draw, and increment, so documents that
share a word at one position see each other's decrements before the draw
(``lda_thesis_tpu/ops/gibbs.py:202-221``).  The sweeps run position-major
internally (``z_t (U, D)``): the public functions take and return the JAX
package's doc-major ``z (D, U)`` and transpose once per call; a model keeps
the position-major layout for a whole training call.

Every function that draws takes an optional ``uniforms`` tensor of the JAX
function's shape and otherwise draws from ``generator`` (a
``torch.Generator`` on the tensors' device).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..models.state import AverageWeights, running_average_
from ..utils.tracing import annotate, count
from . import draw_update_cuda as duc
from . import foldin_cuda
from .draw_update_cuda import Slots, commit_counts, draw_rows
from .sampling import gumbel, gumbel_argmax, mask_to_logits

__all__ = [
    "LDACounts",
    "BucketLDAState",
    "CompactLDACounts",
    "CompactBucketState",
    "init_counts",
    "init_bucket_counts",
    "init_counts_compact",
    "init_bucket_counts_compact",
    "train_sweep",
    "train_sweep_buckets",
    "train_sweep_compact",
    "train_sweep_buckets_compact",
    "exact_sweep",
    "ExactSweep",
    "live_rows",
    "compact_sweep",
    "CompactSweep",
    "ExactBuckets",
    "SaveStep",
    "fill_uniforms",
    "densify_ndk",
    "theta_from_compact",
    "capture_graph",
    "foldin_sweep",
    "FoldinSweep",
    "cascade_sweep",
    "CascadeSweep",
    "cascade_test_loop",
    "log_likelihood",
    "LogLikelihood",
    "training_perplexity",
]


class LDACounts(NamedTuple):
    """Dense Gibbs state: ``z (D, U)`` int32 topic of each type slot,
    ``n_dk (D, K)``, ``n_vk (V, K)``, ``n_k (K,)`` float32 counts."""

    z: torch.Tensor
    n_dk: torch.Tensor
    n_vk: torch.Tensor
    n_k: torch.Tensor


class BucketLDAState(NamedTuple):
    """Dense state over length buckets: per-bucket ``z (D_g, U_g)`` and
    ``n_dk (D_g, K)``, shared global tables.  Buckets are swept one after
    another, which is just a document visiting order."""

    z: Tuple[torch.Tensor, ...]
    n_dk: Tuple[torch.Tensor, ...]
    n_vk: torch.Tensor
    n_k: torch.Tensor


class CompactLDACounts(NamedTuple):
    """Gibbs state over each document's compact label support.

    ``z (D, U)`` int32 slot of each type, ``n_dk (D, A)`` compact doc-topic
    counts, ``n_vk (V, K)`` / ``n_k (K,)`` dense global tables.
    """

    z: torch.Tensor
    n_dk: torch.Tensor
    n_vk: torch.Tensor
    n_k: torch.Tensor


class CompactBucketState(NamedTuple):
    """Compact-support state over length buckets: per-bucket
    ``z (D_g, U_g)`` slot indices and ``n_dk (D_g, A)``, shared tables."""

    z: Tuple[torch.Tensor, ...]
    n_dk: Tuple[torch.Tensor, ...]
    n_vk: torch.Tensor
    n_k: torch.Tensor


def _uniforms(shape, like: torch.Tensor, uniforms, generator) -> torch.Tensor:
    if uniforms is not None:
        if tuple(uniforms.shape) != tuple(shape):
            raise ValueError(f"uniforms must have shape {tuple(shape)}, "
                             f"got {tuple(uniforms.shape)}")
        return uniforms.to(device=like.device, dtype=torch.float32)
    return torch.rand(shape, generator=generator, device=like.device,
                      dtype=torch.float32)


def init_counts_compact(
    tok_v: torch.Tensor,  # (D, U) int
    tok_f: torch.Tensor,  # (D, U) int
    lab_ids: torch.Tensor,  # (D, A) int, ascending, pads = 0
    lab_valid: torch.Tensor,  # (D, A) float 1/0
    V: int,
    K: int,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> CompactLDACounts:
    """z ~ uniform over each document's admissible labels, and its counts.

    The draw of every position depends only on its uniform and the doc's
    label count, so all positions are drawn at once; the counts follow by
    scatter-add (exact: integer values in float32).
    """
    D, U = tok_v.shape
    A = lab_ids.shape[1]
    u = _uniforms((U, D), tok_v, uniforms, generator)
    c_valid = torch.cumsum(lab_valid, dim=1)  # (D, A)
    total = c_valid[:, -1]  # (D,)
    zc = (c_valid[None, :, :] < (u * total[None, :])[:, :, None]).sum(
        dim=2, dtype=torch.int32).T  # (D, U)
    lab = lab_ids.long()
    zg = torch.gather(lab, 1, zc.long())  # (D, U) global topic ids
    ff = tok_f.to(torch.float32)
    n_dk = torch.zeros((D, A), dtype=torch.float32, device=tok_v.device)
    n_dk.scatter_add_(1, zc.long(), ff)
    n_vk = torch.zeros((V, K), dtype=torch.float32, device=tok_v.device)
    n_vk.index_put_((tok_v.reshape(-1).long(), zg.reshape(-1)), ff.reshape(-1),
                    accumulate=True)
    return CompactLDACounts(z=zc.contiguous(), n_dk=n_dk, n_vk=n_vk,
                            n_k=n_vk.sum(dim=0))


def _table_counts(tok_v, tok_f, z_global, V: int, K: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """``n_vk (V, K)`` and ``n_k (K,)`` of an assignment, by one exact
    ``index_add_`` on the flat table (integer counts below 2^24)."""
    n_vk = torch.zeros((V, K), dtype=torch.float32, device=tok_v.device)
    flat = (tok_v.long() * K + z_global.long()).reshape(-1)
    n_vk.view(-1).index_add_(0, flat, tok_f.to(torch.float32).reshape(-1))
    return n_vk, n_vk.sum(dim=0)


def init_counts(
    tok_v: torch.Tensor,  # (D, U) int
    tok_f: torch.Tensor,  # (D, U) int
    labs: torch.Tensor,  # (D, K) float mask
    V: int,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> LDACounts:
    """z ~ uniform over each document's admissible labels, and its counts
    (reference init, LabeledLDA.py:85-92).

    The draw is #{k : cumsum(labs)[k] < u·Σlabs}, the JAX function's
    inverse CDF; the cumsum of a 0/1 mask is exact, so a sorted search gives
    the same count for all positions at once.
    """
    D, U = tok_v.shape
    K = labs.shape[1]
    u = _uniforms((U, D), tok_v, uniforms, generator)
    c_labs = torch.cumsum(labs, dim=1).contiguous()  # (D, K)
    r = (u * c_labs[:, -1][None, :]).T.contiguous()  # (D, U)
    z = torch.searchsorted(c_labs, r, side="left").clamp_(max=K - 1)
    ff = tok_f.to(torch.float32)
    n_dk = torch.zeros((D, K), dtype=torch.float32, device=tok_v.device)
    n_dk.scatter_add_(1, z, ff)
    n_vk, n_k = _table_counts(tok_v, tok_f, z, V, K)
    return LDACounts(z=z.to(torch.int32), n_dk=n_dk, n_vk=n_vk, n_k=n_k)


def _per_bucket(uniforms, g):
    return None if uniforms is None else uniforms[g]


def init_bucket_counts(toks_v, toks_f, labs_t, V: int,
                       uniforms: Optional[Sequence[torch.Tensor]] = None,
                       generator: Optional[torch.Generator] = None) -> BucketLDAState:
    """Per-bucket :func:`init_counts` with a shared topic-word table;
    ``uniforms`` per bucket ``(U_g, D_g)``."""
    zs, ndks = [], []
    n_vk = n_k = None
    for g, (tv, tf, lb) in enumerate(zip(toks_v, toks_f, labs_t)):
        c = init_counts(tv, tf, lb, V, uniforms=_per_bucket(uniforms, g),
                        generator=generator)
        zs.append(c.z)
        ndks.append(c.n_dk)
        n_vk = c.n_vk if n_vk is None else n_vk + c.n_vk
        n_k = c.n_k if n_k is None else n_k + c.n_k
    return BucketLDAState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


def init_bucket_counts_compact(toks_v, toks_f, lab_ids_t, lab_valid_t, V: int, K: int,
                               uniforms: Optional[Sequence[torch.Tensor]] = None,
                               generator: Optional[torch.Generator] = None
                               ) -> CompactBucketState:
    """Per-bucket :func:`init_counts_compact` with shared global tables."""
    zs, ndks = [], []
    n_vk = n_k = None
    for g, (tv, tf, li, lv) in enumerate(zip(toks_v, toks_f, lab_ids_t, lab_valid_t)):
        c = init_counts_compact(tv, tf, li, lv, V, K,
                                uniforms=_per_bucket(uniforms, g), generator=generator)
        zs.append(c.z)
        ndks.append(c.n_dk)
        n_vk = c.n_vk if n_vk is None else n_vk + c.n_vk
        n_k = c.n_k if n_k is None else n_k + c.n_k
    return CompactBucketState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


def live_rows(tok_v_t: torch.Tensor,
              tok_f_t: torch.Tensor) -> List[Tuple[torch.Tensor, torch.Tensor]]:
    """Per position of ``tok_f_t (U, D)``, the rows with f > 0 in ascending
    order (int32) and their words from ``tok_v_t (U, D)`` (int64), as views
    of two tensors built at once (one host sync)."""
    live = tok_f_t > 0
    n = live.sum(dim=1).tolist()
    order = torch.sort((~live).to(torch.uint8), dim=1, stable=True).indices
    words = torch.gather(tok_v_t, 1, order)
    order = order.to(torch.int32)
    return [(order[p, :n[p]], words[p, :n[p]]) for p in range(len(n))]


def exact_sweep(
    z_t: torch.Tensor,  # (U, D) or (L, U, D) int32, position-major, updated in place
    n_dk: torch.Tensor,  # (D, K) or (L, D, K), updated in place
    n_vk: torch.Tensor,  # (V, K) or (L, V, K), updated in place
    n_k: torch.Tensor,  # (K,) or (L, K), updated in place
    tok_v_t: torch.Tensor,  # (U, D) int64
    tok_f_t: torch.Tensor,  # (U, D) float32
    labs: torch.Tensor,  # (D, K) float32
    alpha: float,
    beta: float,
    vbeta: float,
    uniforms: torch.Tensor,  # (U, D) or (L, U, D)
    live: Optional[Sequence[Tuple[torch.Tensor, torch.Tensor]]] = None,  # live_rows
) -> torch.Tensor:
    """One exact dense sweep in the position-major layout; updates ``z_t``
    and the counts in place and returns ``z_t``.

    Per position, as the reference (``lda_thesis_tpu/ops/gibbs.py:175-188``):
    one commit lands the previous position's increments and this position's
    decrements on ``n_vk`` and ``n_k``; then the draw reads each live row's
    table row ``n_vk[v]`` in place with ``recip = 1/(n_k⁻ + V·β)``, draws,
    and updates ``n_dk`` and ``z_t[p]``.  A last commit lands the final
    increments.  On a card each step is one kernel launch
    (:mod:`.draw_update_cuda`), skipped where a position has no live row.

    With a leading chain axis of L on the state and the uniforms, the L
    chains sweep the same corpus, each against its own table: each step is
    still one launch, for every chain, and chain c ends as a single-chain
    sweep of its slices would, bit for bit.
    """
    if live is None:
        live = live_rows(tok_v_t, tok_f_t)
    chained = n_dk.dim() == 3
    prev = None
    for p in range(tok_v_t.shape[0]):
        rows, words = live[p]
        z_p, u_p = (z_t[:, p], uniforms[:, p]) if chained else (z_t[p], uniforms[p])
        cur = Slots(tok_v_t[p], z_p, tok_f_t[p], rows)
        commit_counts(n_vk, n_k, dec=cur, inc=prev)
        draw_rows(u_p, tok_f_t[p], z_p, labs, n_dk, n_vk, words, n_k, rows, alpha, beta,
                  vbeta)
        prev = cur
    if prev is not None:
        commit_counts(n_vk, n_k, dec=None, inc=prev)
    return z_t


def fill_uniforms(u: torch.Tensor, generator=None,
                  uniforms: Optional[torch.Tensor] = None) -> None:
    """Fill a runner's static uniforms buffer ``u`` in place: with
    ``uniforms``, or from ``generator`` as ``torch.rand`` of ``u``'s shape
    draws, or, given one generator per leading index (a chain), ``u[c]``
    from generator c in chain order, as ``c`` single-chain draws would."""
    if uniforms is not None:
        if tuple(uniforms.shape) != tuple(u.shape):
            raise ValueError(f"uniforms must have shape {tuple(u.shape)}, "
                             f"got {tuple(uniforms.shape)}")
        u.copy_(uniforms)
    elif isinstance(generator, (list, tuple)):
        if len(generator) != u.shape[0]:
            raise ValueError(f"{len(generator)} generators for {u.shape[0]} chains")
        for uc, gen in zip(u, generator):
            torch.rand(tuple(uc.shape), generator=gen, out=uc)
    else:
        torch.rand(tuple(u.shape), generator=generator, out=u)


def capture_graph(fn, device) -> "torch.cuda.CUDAGraph":
    """One CUDA graph of the work ``fn()`` launches on ``device``, captured
    on a side stream.  Capture runs nothing: the caller replays the graph.
    Tensors that ``fn`` allocates live in the graph's private pool for the
    graph's lifetime."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(device)
    stream.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(stream):
        graph.capture_begin()
        try:
            fn()
        finally:
            graph.capture_end()
    torch.cuda.current_stream(device).wait_stream(stream)
    return graph


class _Replayed:
    """The replay rule of the training and test-time loops (:class:`ExactSweep`,
    :class:`CompactSweep`, :class:`SaveStep`, :class:`FoldinSweep`,
    :class:`CascadeSweep`, :class:`LogLikelihood`,
    ``ops/gibbs_fused.FusedBlocks``): on a card the
    first call of each key runs its body eagerly (it loads what the body
    needs), the second captures the body as one CUDA graph and every call of
    that key from then on replays it; on the CPU every call runs eagerly.  A
    subclass fills its static inputs, then ``_run``s its body (by default
    ``_sweep``) under a key, the default ``None`` where it has one body; a
    runner whose body has several shapes keeps one graph per shape.

    The kernel wrappers count their launches in module counters, which a
    subclass names in ``_counters``: the launches counted while capturing
    are taken back, and each replay adds them again.  A captured graph does
    not pickle: a pickled instance captures again.

    Each call's phase is a span and a counter (``utils/tracing``) named
    ``<layer>.eager``, ``<layer>.capture`` or ``<layer>.replay``, where the
    layer is the subclass's ``_layer``: a capturing call counts one capture
    and one replay."""

    _counters: Tuple[Tuple[object, Tuple[str, ...]], ...] = ()
    _layer: str  # each subclass's span and counter prefix

    def __init__(self, device):
        self._device = torch.device(device)
        self._graphed = self._device.type == "cuda"
        self._graphs = {}  # key -> (graph, the counter increments of one replay)
        self._key_calls = {}
        self.calls = 0

    @property
    def _graph(self) -> Optional["torch.cuda.CUDAGraph"]:
        """The graph of the body under key ``None``, once captured."""
        entry = self._graphs.get(None)
        return None if entry is None else entry[0]

    def _sweep(self) -> None:
        raise NotImplementedError

    def _read_counters(self) -> List[int]:
        return [getattr(mod, name) for mod, names in self._counters for name in names]

    def _write_counters(self, values: Sequence[int]) -> None:
        it = iter(values)
        for mod, names in self._counters:
            for name in names:
                setattr(mod, name, next(it))

    def _run(self, key=None, body=None) -> None:
        body = self._sweep if body is None else body
        layer = self._layer
        seen = self._key_calls.get(key, 0)
        if not self._graphed or seen == 0:
            with annotate(f"{layer}.eager"):
                body()
            count(f"{layer}.eager")
        else:
            if key not in self._graphs:
                before = self._read_counters()
                with annotate(f"{layer}.capture"):
                    graph = capture_graph(body, self._device)
                count(f"{layer}.capture")
                added = [n - b for n, b in zip(self._read_counters(), before)]
                self._write_counters(before)
                self._graphs[key] = (graph, added)
            graph, added = self._graphs[key]
            with annotate(f"{layer}.replay"):
                graph.replay()
                self._write_counters([n + a for n, a in zip(self._read_counters(), added)])
            count(f"{layer}.replay")
        self._key_calls[key] = seen + 1
        self.calls += 1

    def __getstate__(self):
        state = self.__dict__.copy()
        state["_graphs"], state["_key_calls"], state["calls"] = {}, {}, 0
        return state


def _state_tensors(state) -> Tuple[torch.Tensor, ...]:
    """The tensors of a bucketed state (``z`` and ``n_dk`` per bucket, the
    tables), in one order."""
    return (*state.z, *state.n_dk, state.n_vk, state.n_k)


def _copy_state(state):
    """A copy of a state tuple whose fields are tensors or tuples of them."""
    return type(state)(*(tuple(x.clone() for x in part) if isinstance(part, (tuple, list))
                         else part.clone() for part in state))


def _load_into(dst: Sequence[torch.Tensor], src: Sequence[torch.Tensor]) -> None:
    """Copy ``src`` into ``dst`` in place, tensor by tensor; each must keep
    its shape (a state of another bucket count or sampler is refused)."""
    for d, x in zip(dst, src, strict=True):
        if x.shape != d.shape:
            raise ValueError(f"a loaded state must keep the shape {tuple(d.shape)}, "
                             f"got {tuple(x.shape)}")
        d.copy_(x)


class _StaticState:
    """A runner whose static bucketed state ``self.state`` stands in for a
    model's counts across its calls.  A state set from elsewhere (a
    checkpoint load, a resumed chunk) is told apart by tensor identity
    (:meth:`holds`) and copied in (:meth:`load`), so captured graphs keep
    their addresses."""

    def holds(self, state) -> bool:
        """Whether ``state``'s tensors are this runner's static ones."""
        return all(a is b for a, b in zip(_state_tensors(state), _state_tensors(self.state)))

    def load(self, state) -> None:
        """Copy ``state`` into the static state in place; every tensor must
        keep its shape."""
        _load_into(_state_tensors(self.state), _state_tensors(state))


class ExactSweep(_Replayed):
    """Repeated exact dense sweeps (:func:`exact_sweep`) over one set of
    state tensors, which every call updates in place.

    The live rows of each position are listed once.  Each call fills a
    static uniforms buffer, from ``generator`` as ``torch.rand`` would
    (``out=``) or from the given ``uniforms (U, D)``, then sweeps under
    :class:`_Replayed`'s rule: on a card the first call runs eagerly (it
    also loads the kernels), the second captures the sweep as one CUDA graph
    and every call from then on replays it: ``2·U + 1`` launches at most,
    with no host work per position.  The replay adds its captured launches
    to the wrappers' counters.  On the CPU every call runs eagerly.

    State with a leading chain axis (``z_t (L, U, D)``, ``n_dk (L, D, K)``,
    ``n_vk (L, V, K)``, ``n_k (L, K)``) sweeps L chains over the one corpus
    and live lists: still ``2·U + 1`` launches at most, one graph.  A call
    then takes one generator per chain, chain c's uniforms ``u[c]`` drawn
    from generator c in chain order as a single-chain ``ExactSweep`` draws
    them, or uniforms ``(L, U, D)``.
    """

    _layer = "exact_sweep"
    _counters = ((duc, ("launches", "commit_launches")),)

    def __init__(self, z_t, n_dk, n_vk, n_k, tok_v_t, tok_f_t, labs, alpha: float,
                 beta: float, vbeta: float):
        super().__init__(tok_v_t.device)
        self.z_t = z_t
        self._args = (z_t, n_dk, n_vk, n_k, tok_v_t, tok_f_t, labs, alpha, beta, vbeta)
        self.live = live_rows(tok_v_t, tok_f_t)
        self.u = torch.empty(tuple(z_t.shape), dtype=torch.float32, device=tok_v_t.device)

    @property
    def sweeps(self) -> int:
        return self.calls

    def _sweep(self) -> None:
        exact_sweep(*self._args, self.u, live=self.live)

    def __call__(self, generator=None, uniforms: Optional[torch.Tensor] = None
                 ) -> torch.Tensor:
        """One sweep; returns ``z_t``.  ``generator``: a ``torch.Generator``,
        or one per chain where the state has a chain axis."""
        fill_uniforms(self.u, generator, uniforms)
        self._run()
        return self.z_t


def _vbeta(V: int, beta: float, vbeta: Optional[float]) -> float:
    return float(V * beta) if vbeta is None else float(vbeta)


def _position_major(tok_v, tok_f) -> Tuple[torch.Tensor, torch.Tensor]:
    return tok_v.T.long().contiguous(), tok_f.T.to(torch.float32).contiguous()


def train_sweep(
    counts: LDACounts,
    tok_v: torch.Tensor,  # (D, U)
    tok_f: torch.Tensor,  # (D, U)
    labs: torch.Tensor,  # (D, K)
    alpha: float,
    beta: float,
    vbeta: Optional[float] = None,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> LDACounts:
    """One full exact collapsed-Gibbs sweep over all (doc, type) slots.

    Posterior per slot (reference LabeledLDA.py:113-117):
    p(z=k) ∝ labs_k · (n_dk + α) · (n_vk[v] + β) / (n_k + V·β).
    ``vbeta`` is V·β; it defaults to the table's row count × β, and a caller
    whose table pads the vocabulary must pass the true V·β.  The input
    counts are not modified.
    """
    D, U = tok_v.shape
    V = counts.n_vk.shape[0]
    u = _uniforms((U, D), tok_v, uniforms, generator)
    tv_t, tf_t = _position_major(tok_v, tok_f)
    n_dk = counts.n_dk.to(torch.float32).clone()
    n_vk = counts.n_vk.to(torch.float32).clone()
    n_k = counts.n_k.to(torch.float32).clone()
    # a private copy: the sweep writes z in place, and a transpose of a
    # (1, U) or (D, 1) z would still be the caller's storage
    z_t = counts.z.to(torch.int32).T.clone(memory_format=torch.contiguous_format)
    exact_sweep(z_t, n_dk, n_vk, n_k, tv_t, tf_t, labs.contiguous(), alpha, beta,
                _vbeta(V, beta, vbeta), u)
    return LDACounts(z=z_t.T.contiguous(), n_dk=n_dk, n_vk=n_vk, n_k=n_k)


def train_sweep_buckets(state: BucketLDAState, toks_v, toks_f, labs_t, alpha: float,
                        beta: float,
                        uniforms: Optional[Sequence[torch.Tensor]] = None,
                        generator: Optional[torch.Generator] = None) -> BucketLDAState:
    """One full sweep over all buckets, one after another (exact counts)."""
    n_vk, n_k = state.n_vk, state.n_k
    zs, ndks = [], []
    for g, (tv, tf, lb) in enumerate(zip(toks_v, toks_f, labs_t)):
        c = train_sweep(LDACounts(state.z[g], state.n_dk[g], n_vk, n_k), tv, tf, lb,
                        alpha, beta, uniforms=_per_bucket(uniforms, g),
                        generator=generator)
        n_vk, n_k = c.n_vk, c.n_k
        zs.append(c.z)
        ndks.append(c.n_dk)
    return BucketLDAState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


def _compact_positions(z_t, n_dk, n_vk, n_k, tok_v_t, tok_f_t, lab_ids, lab_valid,
                       alpha: float, beta: float, vbeta: float, uniforms) -> None:
    """:func:`compact_sweep`'s positions, in order, on ``z_t`` and the
    counts in place: position p reads ``z_t[p]`` before it writes it."""
    K = n_vk.shape[1]
    flat = n_vk.view(-1)
    ids = lab_ids.long()
    neg_f = -tok_f_t
    for p in range(tok_v_t.shape[0]):
        v, f = tok_v_t[p], tok_f_t[p]
        zc_old = z_t[p].long()
        zg_old = ids.gather(1, zc_old[:, None])[:, 0]
        n_dk.scatter_add_(1, zc_old[:, None], neg_f[p][:, None])
        flat.index_add_(0, v * K + zg_old, neg_f[p])
        n_k.index_add_(0, zg_old, neg_f[p])
        cv = flat[v[:, None] * K + ids]
        w = lab_valid * (n_dk + alpha) * (cv + beta) * (1.0 / (n_k[ids] + vbeta))
        c = torch.cumsum(w, dim=1)
        r = uniforms[p] * c[:, -1]
        zc_new = (c < r[:, None]).sum(dim=1)
        zc_new = torch.where(f > 0, zc_new, zc_old)
        zg_new = ids.gather(1, zc_new[:, None])[:, 0]
        n_dk.scatter_add_(1, zc_new[:, None], f[:, None])
        flat.index_add_(0, v * K + zg_new, f)
        n_k.index_add_(0, zg_new, f)
        z_t[p] = zc_new


def compact_sweep(
    z_t: torch.Tensor,  # (U, D) int32 slot indices, position-major
    n_dk: torch.Tensor,  # (D, A), updated in place
    n_vk: torch.Tensor,  # (V, K), updated in place
    n_k: torch.Tensor,  # (K,), updated in place
    tok_v_t: torch.Tensor,  # (U, D) int64
    tok_f_t: torch.Tensor,  # (U, D) float32
    lab_ids: torch.Tensor,  # (D, A) int
    lab_valid: torch.Tensor,  # (D, A) float32
    alpha: float,
    beta: float,
    vbeta: float,
    uniforms: torch.Tensor,  # (U, D)
) -> torch.Tensor:
    """One exact sweep on the compact label support, position-major, in
    plain PyTorch; returns the new ``z_t`` (the input's is left as it was)
    and updates the counts in place.

    The same sampler as :func:`exact_sweep` with the zero lanes removed
    (``lda_thesis_tpu/ops/gibbs.py:465-524``): with ascending slot ids the
    draw lands on the same global topic as the dense sweep's.
    """
    z_t = z_t.to(torch.int32).clone(memory_format=torch.contiguous_format)
    _compact_positions(z_t, n_dk, n_vk, n_k, tok_v_t, tok_f_t, lab_ids, lab_valid, alpha,
                       beta, vbeta, uniforms)
    return z_t


class CompactSweep(_Replayed):
    """Repeated compact sweeps (:func:`compact_sweep`) of one bucket over
    one set of state tensors, which every call updates in place: ``z_t (U,
    D)`` int32, ``n_dk (D, A)``, and the tables ``n_vk``/``n_k`` that the
    buckets' runners share.

    Each call fills a static uniforms buffer ``(U, D)``, from ``generator``
    as ``torch.rand`` would or from ``uniforms``, then runs
    :func:`compact_sweep`'s positions in its order, writing ``z_t`` in place
    (:class:`_Replayed`: on a card one replayed CUDA graph per sweep from
    the second call on), so each call has the eager sweep's bits."""

    _layer = "compact_sweep"

    def __init__(self, z_t, n_dk, n_vk, n_k, tok_v_t, tok_f_t, lab_ids, lab_valid,
                 alpha: float, beta: float, vbeta: float):
        super().__init__(tok_v_t.device)
        self.z_t = z_t
        self.u = torch.empty(tuple(z_t.shape), dtype=torch.float32, device=tok_v_t.device)
        self._args = (z_t, n_dk, n_vk, n_k, tok_v_t.long(), tok_f_t.to(torch.float32),
                      lab_ids, lab_valid, alpha, beta, vbeta, self.u)

    def _sweep(self) -> None:
        _compact_positions(*self._args)

    def __call__(self, generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One sweep; returns ``z_t``."""
        fill_uniforms(self.u, generator, uniforms)
        self._run()
        return self.z_t


class ExactBuckets(_StaticState):
    """A training loop's exact sweeps of a bucketed state (dense or
    compact): one runner per bucket (:class:`ExactSweep` or
    :class:`CompactSweep`, made by ``make(g, z_t, n_dk, n_vk, n_k)``) over
    one static state, which a model keeps across its training calls, so on a
    card every sweep after a model's second replays a graph.

    ``state`` is copied into ``self.state`` (``z`` doc-major ``(D_g,
    U_g)``, as the JAX package keeps it) and its position-major ``z_t``,
    which the sweeps update in place; :meth:`doc_major` writes ``z_t`` back
    into ``state.z`` (a call's end).  The live rows of each position depend
    only on the corpus, so a runner's stay valid across calls.  A state set
    from elsewhere is taken in by :meth:`load`, ``z`` into both layouts.
    """

    def __init__(self, state, make):
        self.state = _copy_state(state)
        self.z_t = [z.T.clone(memory_format=torch.contiguous_format) for z in self.state.z]
        self.runs = [make(g, z_t, self.state.n_dk[g], self.state.n_vk, self.state.n_k)
                     for g, z_t in enumerate(self.z_t)]

    def load(self, state) -> None:
        super().load(state)
        for z_t, z in zip(self.z_t, state.z):
            z_t.copy_(z.T)

    def __call__(self, M: int, generator=None) -> None:
        """``M`` sweeps, each over the buckets in order."""
        for _ in range(int(M)):
            for run in self.runs:
                run(generator)

    def doc_major(self) -> None:
        """Write the position-major ``z_t`` into ``state.z`` (doc-major)."""
        for z, z_t in zip(self.state.z, self.z_t):
            z.copy_(z_t.T)


class SaveStep(_Replayed):
    """The save step of a training loop: the current estimates, the thinned
    means and, on request, the training perplexity, as one body (JAX: the
    ``save_block`` of ``lda_thesis_tpu/models/labeled_lda.py:302-329``, with
    its traced save index).

    The runner owns the static means ``ph_hat`` and ``th_hat`` (one per
    bucket; copied from the given tensors), the save's weights
    (``models/state.AverageWeights``) and a static ``perplexity`` scalar.  A
    call ``save(s, estimates, perplexity=None)`` refills the weights of
    save ``s`` on the host, then runs the body: ``cur_ph, cur_th =
    estimates()`` (over the loop's static state), the two running means in
    place (``models/state.running_average_``) and, where ``perplexity`` is
    given, ``perplexity(cur_ph, cur_th)`` into the static scalar, which the
    call returns.  Under :class:`_Replayed`'s rule the body is one CUDA
    graph per value of "perplexity on" on a card, replayed with each save's
    weights; on the CPU it runs eagerly.  The means escape as the runner's
    own tensors: a reader that keeps them past the next save clones them.
    Means set from elsewhere are taken in by :meth:`load`.  A call is the
    span ``save_step``.
    """

    _layer = "save_step"

    def __init__(self, ph_hat: torch.Tensor, th_hat: Sequence[torch.Tensor]):
        super().__init__(ph_hat.device)
        self.ph_hat = ph_hat.clone()
        self.th_hat = tuple(t.clone() for t in th_hat)
        self.w = AverageWeights(ph_hat.device)
        self.perplexity = torch.zeros((), dtype=torch.float32, device=ph_hat.device)

    def holds(self, ph_hat, th_hat) -> bool:
        """Whether ``ph_hat``/``th_hat`` are this runner's static means."""
        return ph_hat is self.ph_hat and all(
            a is b for a, b in zip(th_hat, self.th_hat, strict=True))

    def load(self, ph_hat, th_hat) -> None:
        """Copy means set from elsewhere into the static ones, in place."""
        _load_into((self.ph_hat, *self.th_hat), (ph_hat, *th_hat))

    def reset(self) -> None:
        """Zero the means in place (a run that does not carry them on)."""
        for t in (self.ph_hat, *self.th_hat):
            t.zero_()

    def _body(self, estimates, perplexity) -> None:
        cur_ph, cur_th = estimates()
        running_average_(self.ph_hat, cur_ph, self.w)
        for avg, cur in zip(self.th_hat, cur_th, strict=True):
            running_average_(avg, cur, self.w)
        if perplexity is not None:
            self.perplexity.copy_(perplexity(cur_ph, cur_th))

    def __call__(self, s: int, estimates, perplexity=None) -> Optional[torch.Tensor]:
        """Save ``s`` (1-based); returns the static perplexity scalar where
        ``perplexity`` is given, else ``None``."""
        with annotate(self._layer):
            self.w.set(s)
            self._run(perplexity is not None, lambda: self._body(estimates, perplexity))
        return None if perplexity is None else self.perplexity


def train_sweep_compact(
    counts: CompactLDACounts,
    tok_v: torch.Tensor,
    tok_f: torch.Tensor,
    lab_ids: torch.Tensor,  # (D, A)
    lab_valid: torch.Tensor,  # (D, A)
    alpha: float,
    beta: float,
    vbeta: Optional[float] = None,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> CompactLDACounts:
    """One exact sweep on the compact support (see :func:`compact_sweep`);
    the input counts are not modified."""
    D, U = tok_v.shape
    V = counts.n_vk.shape[0]
    u = _uniforms((U, D), tok_v, uniforms, generator)
    tv_t, tf_t = _position_major(tok_v, tok_f)
    n_dk = counts.n_dk.to(torch.float32).clone()
    n_vk = counts.n_vk.to(torch.float32).clone()
    n_k = counts.n_k.to(torch.float32).clone()
    z_t = compact_sweep(counts.z.T.to(torch.int32).contiguous(), n_dk, n_vk, n_k, tv_t,
                        tf_t, lab_ids, lab_valid, alpha, beta, _vbeta(V, beta, vbeta), u)
    return CompactLDACounts(z=z_t.T.contiguous(), n_dk=n_dk, n_vk=n_vk, n_k=n_k)


def train_sweep_buckets_compact(state: CompactBucketState, toks_v, toks_f, lab_ids_t,
                                lab_valid_t, alpha: float, beta: float,
                                uniforms: Optional[Sequence[torch.Tensor]] = None,
                                generator: Optional[torch.Generator] = None
                                ) -> CompactBucketState:
    """One full compact sweep over all buckets, one after another."""
    n_vk, n_k = state.n_vk, state.n_k
    zs, ndks = [], []
    for g, (tv, tf, li, lv) in enumerate(zip(toks_v, toks_f, lab_ids_t, lab_valid_t)):
        c = train_sweep_compact(CompactLDACounts(state.z[g], state.n_dk[g], n_vk, n_k),
                                tv, tf, li, lv, alpha, beta,
                                uniforms=_per_bucket(uniforms, g), generator=generator)
        n_vk, n_k = c.n_vk, c.n_k
        zs.append(c.z)
        ndks.append(c.n_dk)
    return CompactBucketState(z=tuple(zs), n_dk=tuple(ndks), n_vk=n_vk, n_k=n_k)


def densify_ndk(n_dk_c: torch.Tensor, lab_ids: torch.Tensor, K: int) -> torch.Tensor:
    """Scatter compact (D, A) doc-topic values into dense (D, K)."""
    D = n_dk_c.shape[0]
    rows = torch.arange(D, device=n_dk_c.device)[:, None].expand_as(lab_ids)
    out = torch.zeros((D, K), dtype=torch.float32, device=n_dk_c.device)
    return out.index_put_((rows, lab_ids.long()), n_dk_c, accumulate=True)


def theta_from_compact(n_dk_c, lab_ids, lab_valid, alpha: float, K: int) -> torch.Tensor:
    """Dense (D, K) label-masked θ from compact counts (LabeledLDA.py:236-239)."""
    num = n_dk_c + lab_valid * alpha
    den = num.sum(dim=1, keepdim=True)
    return densify_ndk(num / torch.clamp(den, min=1e-38), lab_ids, K)


def _foldin_positions(z, n_dk, tv, ff, phi, alpha, u) -> None:
    """:func:`foldin_sweep`'s positions, in order, on ``z``/``n_dk`` in place:
    the plain version of the fold-in kernel (``foldin_cuda``), which
    repeats these ops and ``torch.cumsum``'s order on a card bit for bit."""
    for p in range(tv.shape[1]):
        f_p = ff[:, p]
        z_old = z[:, p].long()[:, None]
        n_dk.scatter_add_(1, z_old, -f_p[:, None])
        c = torch.cumsum((n_dk + alpha) * phi[tv[:, p]], dim=1)
        z_new = (c < (u[p] * c[:, -1])[:, None]).sum(dim=1, dtype=torch.int32)
        z_new = torch.where(f_p > 0, z_new, z[:, p])
        n_dk.scatter_add_(1, z_new.long()[:, None], f_p[:, None])
        z[:, p] = z_new


def foldin_sweep(
    z: torch.Tensor,  # (D, U) int32
    n_dk: torch.Tensor,  # (D, K) float32
    tok_v: torch.Tensor,  # (D, U)
    tok_f: torch.Tensor,  # (D, U)
    phi: torch.Tensor,  # (V, K) frozen topic-word distribution
    alpha: float,
    uniforms: Optional[torch.Tensor] = None,  # (U, D)
    generator: Optional[torch.Generator] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fold-in Gibbs sweep for held-out documents with φ frozen.

    p(z=k) ∝ (n_dk + α)·φ[v, k] (reference LabeledLDA.py:185-194), drawn by
    inverse CDF; positions run in order, all documents at once.  Returns
    ``(z, n_dk)``.
    """
    D, U = tok_v.shape
    u = _uniforms((U, D), tok_v, uniforms, generator)
    z = z.clone()
    n_dk = n_dk.clone()
    _foldin_positions(z, n_dk, tok_v.long(), tok_f.to(torch.float32), phi, alpha, u)
    return z, n_dk


class FoldinSweep(_Replayed):
    """Repeated fold-in sweeps (:func:`foldin_sweep` bit for bit) over one
    state ``z (D, U)`` int32 and ``n_dk (D, K)`` float32, which every call
    updates in place.

    ``phi (V, K)`` is read in place and must not change while the instance
    is used.  ``alpha`` is a number, or a float32 tensor that broadcasts
    against ``n_dk`` (HSLDA's α·β, ``(K,)`` or one row per document),
    copied into a static buffer.  Each call fills a static ``(U, D)``
    uniforms buffer outside the graph, from ``generator`` as
    :func:`foldin_sweep` draws it (``torch.rand(..., out=)``) or from the
    given ``uniforms``, then sweeps: on a card one launch of the fold-in
    kernel (``foldin_cuda.foldin_positions``), replayed as a one-node CUDA
    graph from the second call on (:class:`_Replayed`); on the CPU the
    plain :func:`_foldin_positions`.  A state of C chains' documents side by
    side is a taller D: one launch for all chains.  A call is the span
    ``foldin_sweep``.
    """

    _layer = "foldin_sweep"
    _counters = ((foldin_cuda, ("launches",)),)

    def __init__(self, z, n_dk, tok_v, tok_f, phi, alpha):
        super().__init__(n_dk.device)
        D, U = tok_v.shape
        self.z, self.n_dk = z, n_dk
        self._tv = tok_v.long().contiguous()
        self._ff = tok_f.to(torch.float32).contiguous()
        self._phi = phi.contiguous()
        self._alpha = alpha.clone() if torch.is_tensor(alpha) else alpha
        self.u = torch.empty((U, D), dtype=torch.float32, device=n_dk.device)

    def _sweep(self) -> None:
        foldin_cuda.foldin_positions(self.z, self.n_dk, self._tv, self._ff, self._phi,
                                     self._alpha, self.u)

    def __call__(self, generator: Optional[torch.Generator] = None,
                 uniforms: Optional[torch.Tensor] = None) -> None:
        """One sweep of the state, with these uniforms ``(U, D)`` or the
        generator's."""
        with annotate(self._layer):
            if uniforms is None:
                torch.rand(tuple(self.u.shape), generator=generator, out=self.u)
            else:
                self.u.copy_(uniforms)
            self._run()


def _cascade_init(tv, ff, phi_vk, ids, lab_mask, mask_logits, beta, init_gumbels,
                  generator) -> Tuple[torch.Tensor, torch.Tensor]:
    """:func:`cascade_test_loop`'s init pass: ``z (U, R)`` int64 and
    ``n_dk (R, Kt)``."""
    R, U = tv.shape
    Kt = ids.shape[1]
    ld = torch.clamp((ff > 0).sum(dim=1), min=1).to(torch.float32)
    n_dk = torch.zeros((R, Kt), dtype=torch.float32, device=tv.device)
    z = torch.zeros((U, R), dtype=torch.int64, device=tv.device)
    for p in range(U):
        q = phi_vk[tv[:, p][:, None], ids] + beta
        q = q / torch.clamp((q * lab_mask).sum(dim=1, keepdim=True), min=1e-38)
        q[:, 0] = 1.0 / ld
        logits = torch.log(torch.clamp(q, min=1e-38)) + mask_logits
        z[p] = gumbel_argmax(logits, 1, gumbels=None if init_gumbels is None else init_gumbels[p],
                             generator=generator)
        n_dk.scatter_add_(1, z[p][:, None], ff[:, p, None])
    return z, n_dk


def _cascade_positions(z, n_dk, tv, ff, phi_vk, ids, mask_logits, alpha: float, beta: float,
                       gumbels, generator) -> None:
    """:func:`cascade_sweep`'s positions, in order, on ``z``/``n_dk`` in
    place; position p's noise is ``gumbels[p]``, else the generator's."""
    for p in range(tv.shape[1]):
        f = ff[:, p]
        z_old = z[p]
        n_dk.scatter_add_(1, z_old[:, None], -f[:, None])
        lp_doc = torch.log(n_dk + alpha)
        phi_l = phi_vk[tv[:, p][:, None], ids]
        logp = (lp_doc + torch.log(torch.clamp(phi_l, min=0.0))) + mask_logits
        dead = ~torch.isfinite(logp).any(dim=1, keepdim=True)
        logp_fb = (lp_doc + torch.log(phi_l + beta)) + mask_logits
        logp = torch.where(dead, logp_fb, logp)
        z_new = gumbel_argmax(logp, 1, gumbels=None if gumbels is None else gumbels[p],
                              generator=generator)
        z[p] = torch.where(f > 0, z_new, z_old)
        n_dk.scatter_add_(1, z[p][:, None], f[:, None])


def cascade_sweep(
    z: torch.Tensor,  # (U, R) int64, position-major, updated in place
    n_dk: torch.Tensor,  # (R, Kt), updated in place
    tok_v: torch.Tensor,  # (R, U)
    tok_f: torch.Tensor,  # (R, U)
    phi_vk: torch.Tensor,  # (V, Kglob)
    lab_ids: torch.Tensor,  # (R, Kt)
    lab_mask: torch.Tensor,  # (R, Kt)
    alpha: float,
    beta: float,
    gumbels: Optional[torch.Tensor] = None,  # (U, R, Kt)
    generator: Optional[torch.Generator] = None,
) -> None:
    """One sweep of :func:`cascade_test_loop` over its state, eagerly, each
    position's Gumbel noise drawn where the draw is made (or taken from
    ``gumbels``): p(z=k) ∝ (n_dk+α)·φ[v, k], with the (n_dk+α)·(φ[v, k]+β)
    fallback for a row whose posterior is all zero."""
    _cascade_positions(z, n_dk, tok_v.long(), tok_f.to(torch.float32), phi_vk,
                       lab_ids.long(), mask_to_logits(lab_mask), alpha, beta, gumbels,
                       generator)


class CascadeSweep(_Replayed):
    """Repeated :func:`cascade_sweep` over one state ``z (U, R)`` int64 and
    ``n_dk (R, Kt)``, which every call updates in place.

    Each call fills a static ``(U, R, Kt)`` Gumbel buffer outside the graph:
    one :func:`~.sampling.gumbel` per position into its slice, in the order
    the eager sweep draws them (a single ``(U, R, Kt)`` draw would take other
    numbers: a card's generator advances per call), or a copy of the given
    ``gumbels``; then sweeps (:class:`_Replayed`).  ``phi_vk`` is read in
    place and must not change while the instance is used.
    """

    _layer = "cascade_sweep"

    def __init__(self, z, n_dk, tok_v, tok_f, phi_vk, lab_ids, lab_mask, alpha: float,
                 beta: float):
        super().__init__(n_dk.device)
        U, R = z.shape
        self.z, self.n_dk = z, n_dk
        self._args = (tok_v.long(), tok_f.to(torch.float32), phi_vk, lab_ids.long(),
                      mask_to_logits(lab_mask), float(alpha), float(beta))
        self.g = torch.empty((U, R, lab_ids.shape[1]), dtype=torch.float32,
                             device=n_dk.device)

    def _sweep(self) -> None:
        _cascade_positions(self.z, self.n_dk, *self._args, self.g, None)

    def __call__(self, generator: Optional[torch.Generator] = None,
                 gumbels: Optional[torch.Tensor] = None) -> None:
        """One sweep, with this noise ``(U, R, Kt)`` or the generator's."""
        if gumbels is None:
            for p in range(self.g.shape[0]):
                gumbel(self.g.shape[1:], self.g.device, generator, out=self.g[p])
        else:
            self.g.copy_(gumbels)
        self._run()


def cascade_test_loop(
    tok_v: torch.Tensor,  # (R, U) one row per (doc, tree-node) task
    tok_f: torch.Tensor,  # (R, U)
    phi_vk: torch.Tensor,  # (V, Kglob) trained global topic-word table
    lab_ids: torch.Tensor,  # (R, Kt) task-local topic -> global topic id
    lab_mask: torch.Tensor,  # (R, Kt) 1 valid local topic, 0 padding
    it: int,
    thinning: int,
    alpha: float,
    beta: float,
    init_gumbels: Optional[torch.Tensor] = None,  # (U, R, Kt)
    sweep_gumbels: Optional[torch.Tensor] = None,  # (it, U, R, Kt)
    generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Batched CascadeLDA node-level fold-in (CascadeLDA.py:186-247).

    Each row is one (document, tree-node) task whose local topic axis is an
    indexed slice of the global φ (slot 0 = the node's local root).  The
    reference's semantics, as in the JAX function:

    * init (``prep4test``): z ~ Categorical over ``(φ[v]+β)/Σ`` with the
      local root's probability forced to ``1/ld`` (ld = # unique types),
    * sweeps: p(z=k) ∝ (n_dk+α)·φ[v, k]; a row whose posterior is all zero
      falls back to (n_dk+α)·(φ[v, k]+β) (CascadeLDA.py:224-229),
    * the thinned running average of the normalised local counts.

    Draws are Gumbel-max in the log domain.  ``init_gumbels`` and
    ``sweep_gumbels`` are the noise of each position's draw; without them
    the noise comes from ``generator``.  The init pass and the thinning run
    eagerly; the sweeps run through :class:`CascadeSweep`, so on a card
    every sweep from the second on is one replayed CUDA graph, with the
    bits of :func:`cascade_sweep`.  Returns ``avg (R, Kt)``.
    """
    R, Kt = lab_ids.shape
    tv, ff, ids = tok_v.long(), tok_f.to(torch.float32), lab_ids.long()
    z, n_dk = _cascade_init(tv, ff, phi_vk, ids, lab_mask, mask_to_logits(lab_mask), beta,
                            init_gumbels, generator)
    sweep = CascadeSweep(z, n_dk, tv, ff, phi_vk, ids, lab_mask, alpha, beta)
    avg = torch.zeros((R, Kt), dtype=torch.float32, device=tok_v.device)
    s = 0
    for i in range(int(it)):
        sweep(generator, gumbels=None if sweep_gumbels is None else sweep_gumbels[i])
        if (i + 1) % int(thinning) == 0:
            s += 1
            cur = n_dk / torch.clamp(n_dk.sum(dim=1, keepdim=True), min=1.0)
            if s == 1:
                avg = cur
            else:
                s32 = np.float32(s)
                avg = float((s32 - np.float32(1.0)) / s32) * avg + cur / float(s32)
    return avg


def _ll_positions(theta, phi_vk, tv, ff) -> torch.Tensor:
    """:func:`log_likelihood`'s sum, positions in order."""
    acc = torch.zeros((), dtype=torch.float32, device=theta.device)
    for p in range(tv.shape[1]):
        inner = (theta * phi_vk[tv[:, p]]).sum(dim=1)
        safe = torch.where(ff[:, p] > 0, torch.log(torch.clamp(inner, min=1e-38)), 0.0)
        acc = acc + (ff[:, p] * safe).sum()
    return acc


def log_likelihood(theta, phi_vk, tok_v, tok_f) -> Tuple[torch.Tensor, torch.Tensor]:
    """Σ_{d,v} f · log ⟨θ_d, φ_v⟩ and the total token count (float32).

    Used for training perplexity exp(−ll/N) (reference LabeledLDA.py:256-265);
    positions are summed one after another, as in the JAX function.
    """
    return _ll_positions(theta, phi_vk, tok_v.long(), tok_f.to(torch.float32)), tok_f.sum()


class LogLikelihood(_Replayed):
    """:func:`log_likelihood` of one set of tokens ``tok_v/tok_f (D, U)``,
    called again and again with new θ (D, K) and φ (V, K) of one shape: a
    model's ``perplexity()``, one instance per bucket (a training loop's
    saves sum inside the save's body, :func:`training_perplexity`).

    Each call copies θ and φ into static buffers (made at the first call)
    and sums (:class:`_Replayed`: one replayed CUDA graph on a card from the
    second call on), in :func:`log_likelihood`'s order, so the result has
    its bits.  Returns ``(ll, n)`` as it does.
    """

    _layer = "log_likelihood"

    def __init__(self, tok_v, tok_f):
        super().__init__(tok_v.device)
        self._tv = tok_v.long()
        self._ff = tok_f.to(torch.float32)
        self.n_tokens = tok_f.sum()
        self._inputs = None  # static θ, φ
        self._ll = None

    def _sweep(self) -> None:
        self._ll = _ll_positions(*self._inputs, self._tv, self._ff)

    def __call__(self, theta, phi_vk) -> Tuple[torch.Tensor, torch.Tensor]:
        if self._inputs is None:
            self._inputs = tuple(x.clone(memory_format=torch.contiguous_format)
                                 for x in (theta, phi_vk))
        else:
            for buf, x, name in zip(self._inputs, (theta, phi_vk), ("theta", "phi_vk")):
                if x.shape != buf.shape:
                    raise ValueError(f"{name} must keep the shape {tuple(buf.shape)}, "
                                     f"got {tuple(x.shape)}")
                buf.copy_(x)
        self._run()
        return self._ll.clone(), self.n_tokens

    def __getstate__(self):
        state = super().__getstate__()
        state["_inputs"] = state["_ll"] = None
        return state


def training_perplexity(phi: torch.Tensor, thetas: Sequence[torch.Tensor], toks) -> torch.Tensor:
    """A save's training perplexity exp(−ll/N), a float32 scalar on the
    device: :func:`log_likelihood` of each bucket, summed in bucket order.
    ``toks`` holds per bucket ``(tok_v int64, tok_f float32, n float32)``,
    ``n`` the bucket's token count."""
    ll = torch.zeros((), dtype=torch.float32, device=phi.device)
    n = torch.zeros((), dtype=torch.float32, device=phi.device)
    for theta, (tv, ff, ng) in zip(thetas, toks, strict=True):
        ll = ll + _ll_positions(theta, phi, tv, ff)
        n = n + ng
    return torch.exp(-ll / torch.clamp(n, min=1.0))
