"""Carry a trained Labeled-LDA, LocalLDA, HSLDA or distributed state from NumPy arrays into the port.

The distributed trainers' global ``(C, …)`` arrays load through
:func:`sharded_state_from_numpy` (``DistributedLabeledLDA``) and
:func:`hslda_sharded_state_from_numpy` (``DistributedHSLDA``), each rank
keeping its part.

The arrays are those that ``lda_thesis_tpu/utils/checkpoint.save_model``
writes for a ``LabeledLDA`` or a ``LocalLDA``: per bucket ``z_{g}`` and
``n_dk_{g}``, the tables ``n_vk (V, Kp)`` and ``n_k (Kp,)``, and the thinned
means.  The per-bucket layout depends on the sampler (the checkpoint meta's
``sweep``):

* ``fused``: ``z_{g} (U_g, D_g)`` slot indices, ``n_dk_{g} (A, D_g)``;
* ``dense``: ``z_{g} (D_g, U_g)`` topics, ``n_dk_{g} (D_g, Kp)``;
* ``compact`` (Labeled LDA only): ``z_{g} (D_g, U_g)`` slot indices,
  ``n_dk_{g} (D_g, A)``.

An ``HSLDA``'s arrays are ``z (D, N)``, ``n_dk (D, K)``, ``n_vk (V, K)``,
``n_k (K,)`` (int32), ``eta (L, K)``, ``a (D, L)``, ``beta_vec (K,)`` and,
where it has trained, ``ph (K, V)`` and ``th (D, K)``.

A ``LabeledLDA``'s means are ``ph_hat (V, Kp)`` and ``th_hat (D, Kp)`` in
original document order; a ``LocalLDA``'s, where it has trained, are
``ph_hat (K, V)`` and ``th_hat (D, K)``.  The target model must be built
with the same sampler over the same documents (and, for Labeled LDA, labels
and dictionary) and ``n_buckets``, so that its buckets match.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .ops.gibbs import BucketLDAState, CompactBucketState
from .ops.gibbs_fused import FusedBucketState
from .parallel.sharded import local_chains

__all__ = ["labeled_lda_state_from_numpy", "local_lda_state_from_numpy",
           "hslda_state_from_numpy", "sharded_state_from_numpy",
           "hslda_sharded_state_from_numpy", "local_state_from_global"]


def _taker(arrays, device):
    def take(name, shape, dtype):
        if name not in arrays:
            raise ValueError(f"missing array {name!r}")
        a = np.asarray(arrays[name])
        if a.shape != tuple(shape):
            raise ValueError(f"{name} has shape {a.shape}, model needs {tuple(shape)}")
        return torch.tensor(a, dtype=dtype, device=device)  # a copy: sweeps update in place
    return take


def _bucket_state(arrays, model, meta):
    """The model's bucketed Gibbs state from ``arrays``, checked against its
    sampler, bucket count and shapes."""
    sweep = (meta or {}).get("sweep", model.sweep)
    if sweep != model.sweep:
        raise ValueError(f"sweep mismatch: arrays are {sweep!r}, model {model.sweep!r}")
    G = model.buckets.n_buckets
    got_g = sum(1 for k in arrays if k.startswith("z_"))
    if got_g != G:
        raise ValueError(f"bucket count mismatch: arrays have {got_g}, model {G}")
    take = _taker(arrays, model.device)
    zs, ndks = [], []
    for g in range(G):
        U_g, D_g = model._toks_v_t[g].shape
        if sweep == "fused":
            z_shape, ndk_shape = (U_g, D_g), (model.A, D_g)
        else:
            z_shape = (D_g, U_g)
            ndk_shape = (D_g, model.Kp if sweep == "dense" else model.A)
        zs.append(take(f"z_{g}", z_shape, torch.int32))
        ndks.append(take(f"n_dk_{g}", ndk_shape, torch.float32))
    table = (model.V, model.Kp)
    state = {"fused": FusedBucketState, "dense": BucketLDAState,
             "compact": CompactBucketState}[sweep]
    return state(z=tuple(zs), n_dk=tuple(ndks),
                 n_vk=take("n_vk", table, torch.float32),
                 n_k=take("n_k", (model.Kp,), torch.float32))


def labeled_lda_state_from_numpy(arrays: Mapping[str, np.ndarray], model,
                                 meta: Optional[Mapping[str, Any]] = None) -> None:
    """Load ``arrays`` into ``model`` (a port ``LabeledLDA``) on its device.

    ``meta`` is the checkpoint's metadata; where it names a ``sweep``, that
    must be the model's.  Raises ``ValueError`` when the sampler, the bucket
    count or any shape differs from the model's.
    """
    model.counts = _bucket_state(arrays, model, meta)
    take = _taker(arrays, model.device)
    model.ph_hat = take("ph_hat", (model.V, model.Kp), torch.float32)
    th = take("th_hat", (model.D, model.Kp), torch.float32)
    model._th_hat_t = tuple(th[torch.as_tensor(ix, device=model.device)]
                            for ix in model.buckets.doc_idx)


def local_lda_state_from_numpy(arrays: Mapping[str, np.ndarray], model,
                               meta: Optional[Mapping[str, Any]] = None) -> None:
    """Load ``arrays`` into ``model`` (a port ``LocalLDA``) on its device:
    the bucketed counts, and the thinned means ``ph_hat (K, V)`` and
    ``th_hat (D, K)`` (host arrays) where the arrays hold them.  Raises
    ``ValueError`` as :func:`labeled_lda_state_from_numpy` does."""
    model.counts = _bucket_state(arrays, model, meta)
    if "ph_hat" not in arrays:
        model.ph_hat = model.th_hat = None
        return
    take = _taker(arrays, "cpu")
    model.ph_hat = take("ph_hat", (model.K, model.V), torch.float32).numpy()
    model.th_hat = take("th_hat", (model.D, model.K), torch.float32).numpy()


def hslda_state_from_numpy(arrays: Mapping[str, np.ndarray], model) -> None:
    """Load ``arrays`` into ``model`` (a port ``HSLDA``) on its device: the
    counts (in place, so a captured sweep graph stays valid), η, a, β and,
    where the arrays hold them, the thinned means ``ph``/``th`` (host
    arrays).  Raises ``ValueError`` when an array is missing or a shape
    differs from the model's."""
    from .ops.hslda_gibbs import HSLDACounts

    D, N = model.tok_v.shape
    K, L, V = model.K, model.L, model.V
    take = _taker(arrays, model.device)
    model.counts = HSLDACounts(z=take("z", (D, N), torch.int32),
                               n_dk=take("n_dk", (D, K), torch.int32),
                               n_vk=take("n_vk", (V, K), torch.int32),
                               n_k=take("n_k", (K,), torch.int32))
    model.eta = take("eta", (L, K), torch.float32)
    model.a = take("a", (D, L), torch.float32)
    model.beta = take("beta_vec", (K,), torch.float32)
    if "ph" in arrays:
        host = _taker(arrays, "cpu")
        model.ph = host("ph", (K, V), torch.float32).numpy()
        model.th = host("th", (D, K), torch.float32).numpy()


# the axis of each distributed state array (counting the chain axis) that is
# sharded over the data mesh: the documents', or the vocabulary rows' of a
# vocab-sharded table
DENSE_AXES = {"z": 1, "n_dk": 1, "th_hat": 1}
FUSED_AXES = {"z": 2, "n_dk": 2, "th_hat": 1}
VOCAB_AXES = dict(FUSED_AXES, n_vk=1, ph_hat=1)


def sharded_state_from_numpy(arrays: Mapping[str, np.ndarray], model,
                             meta: Optional[Mapping[str, Any]] = None) -> None:
    """Load a JAX ``DistributedLabeledLDA``'s global arrays into this rank's
    part of ``model`` (a port ``DistributedLabeledLDA``), on its device.

    The arrays are those of JAX's ``ShardedLDAState`` (dense: ``z (C, D_p,
    U)``, ``n_dk (C, D_p, K)``), ``FusedShardedState`` (``z (C, U, D_p)``,
    ``n_dk (C, A, D_p)``), ``BucketedShardedState`` (``z_{g}``,
    ``n_dk_{g}``, ``th_hat_{g}`` per bucket) or the vocab-sharded states
    (``n_vk``/``ph_hat (C, V_p, K)``; the single-chain state has no chain
    axis), with ``n_vk``, ``n_k``, ``ph_hat``, ``th_hat (C, D_p, K)`` and
    ``s``.  This rank keeps its chains, its documents and, vocab-sharded,
    its table rows.  Raises ``ValueError`` where the layout (``meta``'s
    ``sweep``/``table_shard``) or a shape differs from the model's.
    """
    meta = meta or {}
    for key, want in (("sweep", model.sweep), ("table_shard", model.table_shard)):
        if key in meta and meta[key] != want:
            raise ValueError(f"{key} mismatch: arrays are {meta[key]!r}, model {want!r}")
    axes = (DENSE_AXES if model.sweep == "dense"
            else VOCAB_AXES if model.table_shard == "vocab" else FUSED_AXES)
    model.state = local_state_from_global(arrays, model.state, model.mesh,
                                          model.n_chains, axes)


# the DistributedHSLDA state's document axes; vocab-sharded, the table's rows too
HSLDA_AXES = {"z": 1, "n_dk": 1, "a": 1}
HSLDA_VOCAB_AXES = dict(HSLDA_AXES, n_vk=1)


def hslda_sharded_state_from_numpy(arrays: Mapping[str, np.ndarray], model,
                                   meta: Optional[Mapping[str, Any]] = None) -> None:
    """Load a JAX ``DistributedHSLDA``'s global arrays into this rank's part
    of ``model`` (a port ``DistributedHSLDA``), on its device.

    The arrays are those of JAX's ``HSLDAShardedState`` as its checkpoint
    names them: ``z (C, D_p, N)``, ``n_dk (C, D_p, K)``, ``n_vk (C, V, K)``
    (vocab-sharded: ``(C, V_p, K)``), ``n_k (C, K)`` (int32), ``eta (C, L,
    K)``, ``a (C, D_p, L)``, ``beta_vec (C, K)`` and, where a save was
    folded in, ``ph_hat (C, K, V or V_p)``.  This rank keeps its chains, its
    documents and, vocab-sharded, its table rows.  Raises ``ValueError``
    where ``meta``'s ``table_shard`` or a shape differs from the model's.
    The threefry key has no counterpart: the model's generators stay."""
    from .parallel.sharded_io import HSLDA_ARRAYS
    from .parallel.vocab_sharded import vocab_rows

    meta = meta or {}
    if "table_shard" in meta and meta["table_shard"] != model.table_shard:
        raise ValueError(f"table_shard mismatch: arrays are {meta['table_shard']!r}, "
                         f"model {model.table_shard!r}")
    vocab = model.table_shard == "vocab"
    named = {f: arrays[a] for f, a in HSLDA_ARRAYS.items() if a in arrays}
    model.state = local_state_from_global(named, model.state, model.mesh, model.n_chains,
                                          HSLDA_VOCAB_AXES if vocab else HSLDA_AXES)
    if "ph_hat" not in arrays:
        model._ph_hat = None
        return
    L, g0 = local_chains(model.mesh, model.n_chains)
    ph = np.asarray(arrays["ph_hat"], np.float32)[g0:g0 + L]
    rows = vocab_rows(model.mesh, model.V) if vocab else slice(None)
    ph = np.ascontiguousarray(ph[:, :, rows])
    want = (L, model.K, model.state.n_vk.shape[1])
    if ph.shape != want:
        raise ValueError(f"ph_hat has shape {ph.shape}, model needs {want}")
    model._ph_hat = torch.tensor(ph, device=model.device)


def local_state_from_global(arrays: Mapping[str, np.ndarray], state, mesh, n_chains: int,
                            axes: Mapping[str, Any]):
    """A state of ``state``'s type and shapes holding this rank's part of the
    global ``(C, …)`` arrays: its chains and, along the axis that ``axes``
    names for a field, its slice of the data-sharded axis."""
    L, g0 = local_chains(mesh, n_chains)
    di = mesh.coords[1]
    fields = {"s": int(np.asarray(arrays.get("s", 0)))} if "s" in state._fields else {}
    for name, value in state._asdict().items():
        if name == "s":
            continue
        tuple_field = isinstance(value, tuple)
        parts = []
        for g, local in enumerate(value if tuple_field else (value,)):
            key = f"{name}_{g}" if tuple_field else name
            if key not in arrays:
                raise ValueError(f"missing array {key!r}")
            a = np.asarray(arrays[key])
            if a.ndim == local.dim() - 1:  # JAX's single-chain vocab state
                a = a[None]
            if a.shape[0] != n_chains:
                raise ValueError(f"{key} holds {a.shape[0]} chains, model {n_chains}")
            a = a[g0:g0 + L]
            if name in axes:
                axis = axes[name]
                n = local.shape[axis]
                if a.shape[axis] != n * mesh.shape["data"]:
                    raise ValueError(f"{key} has {a.shape[axis]} rows on axis {axis}, "
                                     f"model {n} per shard x {mesh.shape['data']}")
                a = np.take(a, np.arange(di * n, (di + 1) * n), axis=axis)
            if a.shape != tuple(local.shape):
                raise ValueError(f"{key} has shape {a.shape}, model needs "
                                 f"{tuple(local.shape)}")
            parts.append(torch.tensor(a, dtype=local.dtype, device=local.device))
        fields[name] = tuple(parts) if tuple_field else parts[0]
    return type(state)(**fields)
