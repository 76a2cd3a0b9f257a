"""Sharded checkpoints of the distributed Labeled-LDA and HSLDA trainers.

Counterpart of ``lda_thesis_tpu/parallel/sharded_io.py``.  A checkpoint at
``path`` is:

* one shard per rank, ``{path}.it{N}.rank{r}.npz`` (+ ``.json``), written
  by that rank with ``utils/checkpoint.save_checkpoint``: its local state
  as it lies on the rank (``z``, ``n_dk``, ``th_hat``, or ``z_{g}``,
  ``n_dk_{g}``, ``th_hat_{g}`` per bucket; the chains' tables ``n_vk``,
  ``n_k`` and means ``ph_hat``, whole or, vocab-sharded, the rank's rows)
  and ``gen_states``, the uint8 states of its chains' generators; its
  metadata names the rank's first global chain, chain count and data
  shard;
* the marker ``{path}.npz`` + ``{path}.json``, written by rank 0 once every
  shard is on disk: the layout (``sweep``, ``table_shard``, ``n_buckets``,
  ``mesh``), ``n_chains``, ``K``, ``Kp``, ``V``, ``D``, ``alpha``,
  ``beta``, ``iters_done``, ``merge_M``, the save count ``s``, the shard
  files, and the fold-in generator's state ``rng_state``.  Only then are
  the shards of older iterations deleted, so a kill at any point leaves a
  marker whose shards exist.

A ``DistributedHSLDA`` checkpoint (:func:`save_hslda_sharded`) has the same
layout: each shard holds the rank's ``z``, ``n_dk`` and ``a``, its chains'
``n_vk``, ``n_k``, ``eta``, ``beta_vec`` and, once a save has been folded
in, ``ph_hat`` (whole or, vocab-sharded, the rank's rows), and the states
of both kinds of chain generator (``gen_states``, ``chain_gen_states``);
the marker holds ``kind``, ``table_shard``, ``mesh``, ``n_chains``, ``K``,
``L``, ``V``, ``D``, ``n_saves``, ``iters_done`` and ``cycles_done``.

A resume needs the same data-mesh size (a chain's generator belongs to its
data shard); the chains axis may differ, since every rank gathers its
global chains from whichever shards hold them.  A checkpoint that the JAX
package wrote (global ``(C, …)`` arrays) loads through
:func:`..convert.sharded_state_from_numpy`; its threefry key has no torch
counterpart, so the constructor's generators stay, with a warning; a JAX
``DistributedHSLDA`` checkpoint loads through
:func:`..convert.hslda_sharded_state_from_numpy` in the same way.
"""

from __future__ import annotations

import os
import re
import warnings
from typing import Any, Dict

import numpy as np
import torch

from ..utils.checkpoint import load_checkpoint, save_checkpoint
from .sharded import local_chains

__all__ = ["save_sharded", "restore_sharded", "save_hslda_sharded", "restore_hslda_sharded"]


def _layout(model) -> Dict[str, Any]:
    return {"sweep": model.sweep, "table_shard": model.table_shard,
            "n_buckets": int(model.n_buckets)}


def _shard_name(path: str, iters_done: int, rank: int) -> str:
    return f"{path}.it{int(iters_done)}.rank{int(rank)}"


def _state_arrays(state) -> Dict[str, np.ndarray]:
    out = {}
    for name, value in state._asdict().items():
        if name == "s":
            continue
        if isinstance(value, tuple):
            for g, v in enumerate(value):
                out[f"{name}_{g}"] = v.cpu().numpy()
        else:
            out[name] = value.cpu().numpy()
    return out


def _gen_states(gens) -> np.ndarray:
    return np.stack([g.get_state().numpy() for g in gens])


def _write(path: str, model, iters_done: int, arrays: Dict[str, np.ndarray],
           meta: Dict[str, Any]) -> None:
    """Every rank writes its shard, then rank 0 the marker (``meta`` and the
    shard list) and drops older shards.  Called on every rank."""
    mesh = model.mesh
    L, g0 = local_chains(mesh, model.n_chains)
    shard = _shard_name(path, iters_done, mesh.rank)
    save_checkpoint(shard, arrays, {"rank": mesh.rank, "chain0": g0, "chains": L,
                                    "di": mesh.coords[1], "iters_done": int(iters_done)})
    mesh.barrier()
    if mesh.rank == 0:
        meta = {"framework": "torch", "rng_device": model.device.type,
                "mesh": dict(mesh.shape), "n_chains": int(model.n_chains),
                "iters_done": int(iters_done), **meta,
                "shards": [os.path.basename(_shard_name(path, iters_done, r))
                           for r in range(mesh.world_size)]}
        save_checkpoint(path, {"rng_state": model._gen.get_state().numpy()}, meta)
        _drop_stale_shards(path, iters_done)
    mesh.barrier()


def save_sharded(path: str, model, iters_done: int = 0) -> None:
    """Snapshot a DistributedLabeledLDA: every rank writes its shard, then
    rank 0 the marker.  Called on every rank."""
    from ..ops.gibbs_fused import SAMPLER_FORMULA_VERSION

    arrays = _state_arrays(model.state)
    arrays["gen_states"] = _gen_states(model._gens)
    _write(path, model, iters_done, arrays, {
        "kind": "DistributedLabeledLDA", **_layout(model), "K": int(model.K),
        "Kp": int(model.Kp), "V": int(model.V), "D": int(model.D), "alpha": model.alpha,
        "beta": model.beta, "merge_M": getattr(model, "_merge_M", None),
        "s": int(model.state.s), "sampler_formula": SAMPLER_FORMULA_VERSION})


def _drop_stale_shards(path: str, iters_done: int) -> None:
    d = os.path.dirname(os.path.abspath(path))
    pat = re.compile(re.escape(os.path.basename(path)) + r"\.it(\d+)\.rank\d+\.(npz|json)$")
    for name in os.listdir(d):
        m = pat.match(name)
        if m and int(m.group(1)) != int(iters_done):
            os.unlink(os.path.join(d, name))


def _check(meta, model) -> None:
    if meta["kind"] != "DistributedLabeledLDA":
        raise ValueError(f"checkpoint is {meta['kind']}")
    for name, got in (("n_chains", model.n_chains), ("V", model.V), ("D", model.D)):
        if int(meta[name]) != int(got):
            raise ValueError(f"{name} mismatch: checkpoint {meta[name]}, model {got}")
    buckets = int(meta.get("n_buckets", 1))
    if buckets != model.n_buckets:
        raise ValueError(f"bucket count mismatch: checkpoint {buckets}, model "
                         f"{model.n_buckets} (construct with n_buckets={buckets})")
    sweep = meta.get("sweep", "dense")
    if sweep != model.sweep:
        raise ValueError(f"checkpoint layout is {sweep!r}, model sweep is "
                         f"{model.sweep!r} (construct with sweep={sweep!r})")
    shard = meta.get("table_shard", "replicated")
    if shard != model.table_shard:
        raise ValueError(f"checkpoint table_shard is {shard!r}, model is "
                         f"{model.table_shard!r}")


def _gather_local(path: str, meta, model) -> Dict[str, np.ndarray]:
    """This rank's chains at its data shard, from the shards that hold them."""
    mesh = model.mesh
    L, g0 = local_chains(mesh, model.n_chains)
    di = mesh.coords[1]
    d = os.path.dirname(os.path.abspath(path))
    parts = []  # (first global chain, arrays)
    for name in meta["shards"]:
        arrays, smeta = load_checkpoint(os.path.join(d, name))
        lo, n = int(smeta["chain0"]), int(smeta["chains"])
        if int(smeta["di"]) != di or lo + n <= g0 or lo >= g0 + L:
            continue
        a, b = max(lo, g0) - lo, min(lo + n, g0 + L) - lo
        parts.append((max(lo, g0), {k: v[a:b] for k, v in arrays.items()}))
    parts.sort(key=lambda p: p[0])
    if sum(p[1]["gen_states"].shape[0] for p in parts) != L:
        raise ValueError(f"checkpoint shards do not hold chains {g0}..{g0 + L - 1} "
                         f"of data shard {di}")
    return {k: np.concatenate([p[1][k] for p in parts]) for k in parts[0][1]}


def _warn_jax() -> None:
    warnings.warn(
        "checkpoint was recorded by the JAX package, whose threefry key does not "
        "carry over to a torch.Generator; the chains continue from the "
        "constructor's generators: statistically valid but not bit-identical to "
        "an uninterrupted run", stacklevel=3)


def _check_port(meta, model) -> None:
    """A port checkpoint restores on the same data-mesh size and device type."""
    if meta["mesh"]["data"] != model.mesh.shape["data"]:
        raise ValueError(f"data-mesh mismatch: checkpoint {meta['mesh']['data']} data "
                         f"shards, model {model.mesh.shape['data']} (each chain's "
                         "generator belongs to its data shard)")
    if meta["rng_device"] != model.device.type:
        raise ValueError(
            f"checkpoint holds {meta['rng_device']} generator states, the model draws "
            f"on {model.device.type}: CPU (mt19937) and CUDA (Philox) states do not "
            f"interchange; restore on a {meta['rng_device']} device")


def _set_states(gens, states) -> None:
    for gen, st in zip(gens, states):
        gen.set_state(torch.from_numpy(np.ascontiguousarray(st)))


def restore_sharded(path: str, model) -> Dict[str, Any]:
    """Restore a snapshot into a compatibly constructed trainer (on every
    rank).  Validates the chain count, corpus shape and layout; returns the
    checkpoint metadata."""
    from ..convert import sharded_state_from_numpy

    arrays, meta = load_checkpoint(path)
    _check(meta, model)
    model._sweeps_done = int(meta.get("iters_done", 0))
    if meta.get("merge_M") is not None:
        model._ckpt_merge_M = int(meta["merge_M"])
    if meta.get("framework") is None:
        sharded_state_from_numpy(arrays, model, meta)
        _warn_jax()
        return meta
    _check_port(meta, model)
    local = _gather_local(path, meta, model)
    dev = model.device
    fields = {"s": int(meta["s"])}
    for name, value in model.state._asdict().items():
        if name == "s":
            continue
        names = ([f"{name}_{g}" for g in range(len(value))] if isinstance(value, tuple)
                 else [name])
        have = value if isinstance(value, tuple) else (value,)
        for n, v in zip(names, have):
            if local[n].shape != tuple(v.shape):
                raise ValueError(f"state shape mismatch in {n}: checkpoint "
                                 f"{local[n].shape}, model {tuple(v.shape)}")
        loaded = tuple(torch.tensor(local[n], device=dev) for n in names)
        fields[name] = loaded if isinstance(value, tuple) else loaded[0]
    model.state = type(model.state)(**fields)
    _set_states(model._gens, local["gen_states"])
    model._gen.set_state(torch.from_numpy(arrays["rng_state"]))
    return meta


# DistributedHSLDA: state field -> array name (the JAX checkpoint's names)
HSLDA_ARRAYS = {"z": "z", "n_dk": "n_dk", "n_vk": "n_vk", "n_k": "n_k", "eta": "eta",
                "a": "a", "beta": "beta_vec"}


def save_hslda_sharded(path: str, model, iters_done: int = 0) -> None:
    """Snapshot a DistributedHSLDA: every rank writes its shard, then rank 0
    the marker.  Called on every rank."""
    st = model.state
    arrays = {HSLDA_ARRAYS[f]: getattr(st, f).cpu().numpy() for f in st._fields}
    if model._ph_hat is not None:
        arrays["ph_hat"] = model._ph_hat.cpu().numpy()
    arrays["gen_states"] = _gen_states(model._gens.local)
    arrays["chain_gen_states"] = _gen_states(model._gens.chain)
    _write(path, model, iters_done, arrays, {
        "kind": "DistributedHSLDA", "table_shard": model.table_shard, "K": int(model.K),
        "L": int(model.L), "V": int(model.V), "D": int(model.D),
        "n_saves": int(model._n_saves), "cycles_done": int(model._cycles_done)})


def _check_hslda(meta, model) -> None:
    if meta["kind"] != "DistributedHSLDA":
        raise ValueError(f"checkpoint is {meta['kind']}")
    for name, got in (("n_chains", model.n_chains), ("K", model.K), ("L", model.L),
                      ("V", model.V), ("D", model.D)):
        if int(meta[name]) != int(got):
            raise ValueError(f"{name} mismatch: checkpoint {meta[name]}, model {got}")
    shard = meta.get("table_shard", "replicated")
    if shard != model.table_shard:
        raise ValueError(f"checkpoint table_shard is {shard!r}, model is "
                         f"{model.table_shard!r}")


def restore_hslda_sharded(path: str, model) -> Dict[str, Any]:
    """Restore a DistributedHSLDA snapshot into a compatibly constructed
    trainer (on every rank): its state, thinned φ̂ mean, save and cycle
    counts and every generator.  Validates the chain count, K, L, V, D and
    ``table_shard``; returns the checkpoint metadata.  A checkpoint of the
    JAX package loads its global arrays (the constructor's generators stay,
    with a warning)."""
    from ..convert import hslda_sharded_state_from_numpy
    from .hslda_sharded import HSLDAShardedState

    arrays, meta = load_checkpoint(path)
    _check_hslda(meta, model)
    model._n_saves = int(meta.get("n_saves", 0))
    model._cycles_done = int(meta.get("cycles_done", meta.get("iters_done", 0)))
    if meta.get("framework") is None:
        hslda_sharded_state_from_numpy(arrays, model, meta)
        _warn_jax()
        return meta
    _check_port(meta, model)
    local = _gather_local(path, meta, model)
    fields = {}
    for f, have in model.state._asdict().items():
        got = local[HSLDA_ARRAYS[f]]
        if got.shape != tuple(have.shape):
            raise ValueError(f"state shape mismatch in {f}: checkpoint {got.shape}, "
                             f"model {tuple(have.shape)}")
        fields[f] = torch.tensor(got, dtype=have.dtype, device=model.device)
    model.state = HSLDAShardedState(**fields)
    model._ph_hat = (torch.tensor(local["ph_hat"], device=model.device)
                     if "ph_hat" in local else None)
    _set_states(model._gens.local, local["gen_states"])
    _set_states(model._gens.chain, local["chain_gen_states"])
    model._gen.set_state(torch.from_numpy(arrays["rng_state"]))
    return meta
