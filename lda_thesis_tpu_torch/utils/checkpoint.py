"""Checkpoint / resume: count-tensor and generator-state snapshots.

Counterpart of ``lda_thesis_tpu/utils/checkpoint.py``, with its layout:

* arrays in one ``.npz`` (count tensors, thinned means, the generator's
  state), metadata (hyperparameters, labelmap) as JSON; no pickled code
  objects, so checkpoints survive refactors;
* writes are atomic: both files are written in full to temporary names and
  then renamed, the ``.npz`` first, so an interrupted run never leaves a
  corrupt file and the ``.json`` that marks a checkpoint appears last; the
  ``.npz`` carries its own copy of the metadata (``meta_json``), which
  :func:`load_checkpoint` prefers, so a kill between the two renames cannot
  pair new arrays with old metadata;
* :func:`save_model` / :func:`restore_model` round-trip the training state of
  ``LabeledLDA`` (fused, dense and compact), ``LocalLDA`` (fused and dense),
  ``CascadeLDA`` and ``HSLDA``; training resumes mid-chain with the same
  draws as the uninterrupted run.  A ``DistributedLabeledLDA`` or a
  ``DistributedHSLDA`` goes to ``parallel/sharded_io.py`` (one shard per
  rank and a marker).

The array names and meta keys are the JAX package's, except that the port
has no ``rng_key``: it stores its ``torch.Generator`` state as ``rng_state``
(uint8) with the generator's device type as meta ``rng_device``, and stamps
``framework: "torch"``.  A CPU (mt19937) state and a CUDA (Philox) state do
not interchange, so a state restores only into a generator of its own
device type.  :func:`restore_model` also reads a checkpoint that the JAX
package wrote: its counts and means load as they are, and the chain then
continues from the constructor's generator, in distribution but not draw
for draw.
"""

from __future__ import annotations

import json
import os
import tempfile
import warnings
from typing import Any, Dict, Tuple

import numpy as np
import torch

__all__ = ["save_checkpoint", "load_checkpoint", "save_model", "restore_model"]

# every model kind of the JAX package; the distributed ones go to
# parallel/sharded_io.py
_KINDS = ("LabeledLDA", "LocalLDA", "CascadeLDA", "HSLDA", "DistributedLabeledLDA",
          "DistributedHSLDA")
# the array of a port checkpoint's ``.npz`` that holds its metadata
META_ARRAY = "meta_json"


def _write_tmp(path: str, write_fn) -> str:
    d = os.path.dirname(os.path.abspath(path)) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "wb") as f:
            write_fn(f)
    except BaseException:
        os.unlink(tmp)
        raise
    return tmp


def save_checkpoint(path: str, arrays: Dict[str, Any], meta: Dict[str, Any]) -> None:
    """Atomically write ``{path}.npz`` (arrays) and ``{path}.json`` (metadata).

    The metadata also goes into the ``.npz`` as the uint8 array
    ``meta_json``, so the arrays and their metadata land in one rename: a
    kill between the two renames leaves a new ``.npz`` beside an old
    ``.json``, and :func:`load_checkpoint` still pairs the arrays with their
    own metadata.
    """
    text = json.dumps(meta, indent=1).encode()
    np_arrays = {k: np.asarray(v) for k, v in arrays.items()}
    np_arrays[META_ARRAY] = np.frombuffer(text, dtype=np.uint8)
    tmps = []
    try:
        tmps.append(_write_tmp(path + ".npz", lambda f: np.savez(f, **np_arrays)))
        tmps.append(_write_tmp(path + ".json", lambda f: f.write(text)))
        os.replace(tmps[0], path + ".npz")
        os.replace(tmps[1], path + ".json")
    finally:
        for tmp in tmps:
            if os.path.exists(tmp):
                os.unlink(tmp)


def load_checkpoint(path: str) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """The arrays and metadata of a checkpoint.  The metadata is the copy
    inside the ``.npz`` where there is one; a checkpoint that the JAX package
    wrote has none, and its metadata comes from the ``.json``."""
    with np.load(path + ".npz") as z:
        arrays = {k: z[k] for k in z.files}
    text = arrays.pop(META_ARRAY, None)
    if text is not None:
        return arrays, json.loads(text.tobytes().decode())
    with open(path + ".json") as f:
        meta = json.load(f)
    return arrays, meta


# --------------------------------------------------------------------------
# model-level snapshots
# --------------------------------------------------------------------------


def _model_kind(model) -> str:
    kind = type(model).__name__
    if kind not in _KINDS:
        raise TypeError(f"unknown model kind: {kind}")
    return kind


def save_model(path: str, model, extra_meta: Dict[str, Any] = None) -> None:
    """Snapshot a LabeledLDA / LocalLDA / CascadeLDA / HSLDA /
    DistributedLabeledLDA / DistributedHSLDA training state.

    ``extra_meta`` lets callers record run-level progress (e.g. the CLI's
    ``iters_done``) alongside the model state; a distributed trainer's
    checkpoint records ``iters_done`` alone (and is written on every rank).
    """
    kind = _model_kind(model)
    if kind in ("DistributedLabeledLDA", "DistributedHSLDA"):
        from ..parallel.sharded_io import save_hslda_sharded, save_sharded

        save = save_sharded if kind == "DistributedLabeledLDA" else save_hslda_sharded
        return save(path, model, iters_done=int((extra_meta or {}).get("iters_done", 0)))
    arrays: Dict[str, Any] = {"rng_state": model._gen.get_state().numpy()}
    meta: Dict[str, Any] = {"kind": kind, "framework": "torch",
                            "rng_device": model._gen.device.type}
    if extra_meta:
        meta.update(extra_meta)

    if kind in ("LabeledLDA", "LocalLDA"):
        # bucketed state: one z/n_dk pair per length bucket
        meta["n_buckets"] = len(model.counts.z)
        for g in range(len(model.counts.z)):
            arrays[f"z_{g}"] = model.counts.z[g].cpu().numpy()
            arrays[f"n_dk_{g}"] = model.counts.n_dk[g].cpu().numpy()
        arrays.update(n_vk=model.counts.n_vk.cpu().numpy(),
                      n_k=model.counts.n_k.cpu().numpy())
        if kind == "LabeledLDA":
            arrays.update(ph_hat=model.ph_hat.cpu().numpy(), th_hat=model.th_hat)
            meta.update(alpha=model.alpha, beta=model.beta, K=model.K,
                        Kp=model.Kp, V=model.V, D=model.D,
                        sweep=model.sweep, avg_s=int(model._avg_s),
                        merge_M=getattr(model, "_merge_M", None),
                        labelmap=model.labelmap,
                        cur_perplx=list(map(float, model.cur_perplx)))
        else:
            if model.ph_hat is not None:
                arrays.update(ph_hat=model.ph_hat, th_hat=model.th_hat)
            meta.update(alpha=model.a, beta=model.b, K=model.K, Kp=model.Kp,
                        V=model.V, D=model.D, token2id=model.word2id.token2id,
                        sweep=model.sweep,
                        merge_M=getattr(model, "_merge_M", None))
        if model.sweep == "fused":
            from ..ops.gibbs_fused import SAMPLER_FORMULA_VERSION

            meta["sampler_formula"] = SAMPLER_FORMULA_VERSION
    elif kind == "CascadeLDA":
        arrays.update(ph=model.ph)
        meta.update(alpha=model.alpha, beta=model.beta, K=model.K, V=model.V,
                    D=model.D, labelmap=model.labelmap)
    else:
        c = model.counts
        arrays.update(z=c.z.cpu().numpy(), n_dk=c.n_dk.cpu().numpy(),
                      n_vk=c.n_vk.cpu().numpy(), n_k=c.n_k.cpu().numpy(),
                      eta=model.eta.cpu().numpy(), a=model.a.cpu().numpy(),
                      beta_vec=model.beta.cpu().numpy())
        if model.ph is not None:
            arrays.update(ph=model.ph, th=model.th)
        meta.update(K=model.K, L=model.L, V=model.V, D=model.D,
                    alpha=model.alpha, aprime=model.aprime, gamma=model.gamma,
                    mu=model.mu, sigma=model.sigma, xi=model.xi,
                    avg_s=int(model._avg_s), cycles_done=int(model._cycles_done),
                    labelmap=model.labelmap, token2id=model.w_to_v)
    save_checkpoint(path, arrays, meta)


def _stream_warning(what: str) -> None:
    warnings.warn(
        f"checkpoint was recorded {what}: the resumed chain is statistically "
        f"valid but not bit-identical to an uninterrupted run", stacklevel=3)


def restore_model(path: str, model) -> Dict[str, Any]:
    """Restore a snapshot into a *compatibly constructed* model instance.

    The instance must be built over the same corpus/vocabulary (shapes are
    validated); counts, thinned means and the generator's state are replaced
    so training continues exactly where the snapshot left off.  Returns the
    checkpoint metadata (including any ``extra_meta`` recorded at save time,
    e.g. ``iters_done``).
    """
    from ..convert import (
        hslda_state_from_numpy,
        labeled_lda_state_from_numpy,
        local_lda_state_from_numpy,
    )

    kind = _model_kind(model)
    if kind in ("DistributedLabeledLDA", "DistributedHSLDA"):
        from ..parallel.sharded_io import restore_hslda_sharded, restore_sharded

        restore = restore_sharded if kind == "DistributedLabeledLDA" else restore_hslda_sharded
        return restore(path, model)
    arrays, meta = load_checkpoint(path)
    if meta["kind"] != kind:
        raise ValueError(f"checkpoint is {meta['kind']}, model is {kind}")

    def _chk(name, got, want):
        if int(got) != int(want):
            raise ValueError(f"{name} mismatch: checkpoint {want}, model {got}")

    _chk("V", model.V, meta["V"])
    _chk("D", model.D, meta["D"])
    from_jax = meta.get("framework") is None
    if not from_jax:
        want, got = meta["rng_device"], model._gen.device.type
        if want != got:
            raise ValueError(
                f"checkpoint holds a {want} generator state, the model draws on "
                f"{got}: CPU (mt19937) and CUDA (Philox) states do not "
                f"interchange; restore on a {want} device")

    if kind in ("LabeledLDA", "LocalLDA"):
        G = int(meta["n_buckets"])
        if len(model.counts.z) != G:
            raise ValueError(
                f"bucket count mismatch: checkpoint {G}, model "
                f"{len(model.counts.z)} (construct with n_buckets={G}; "
                f"CLI: --n-buckets {G})"
            )
        sweep = meta.get("sweep", "dense")
        if sweep != model.sweep:
            raise ValueError(
                f"sweep kernel mismatch: checkpoint {sweep!r}, model "
                f"{model.sweep!r} (construct with sweep={sweep!r})"
            )
        if kind == "LabeledLDA":
            labeled_lda_state_from_numpy(arrays, model, meta)
            model.cur_perplx = list(meta.get("cur_perplx", []))
            model._avg_s = int(meta.get("avg_s", 0))
        else:
            local_lda_state_from_numpy(arrays, model, meta)
        if meta.get("merge_M") is not None:
            model._ckpt_merge_M = int(meta["merge_M"])
        if sweep == "fused" and not from_jax:
            from ..ops.gibbs_fused import SAMPLER_FORMULA_VERSION

            got = meta.get("sampler_formula")
            if got is None or int(got) != SAMPLER_FORMULA_VERSION:
                _stream_warning(f"with fused sampler formula v{got}, current is "
                                f"v{SAMPLER_FORMULA_VERSION}")
    elif kind == "CascadeLDA":
        model.ph = np.array(arrays["ph"], dtype=np.float32)
    else:
        hslda_state_from_numpy(arrays, model)
        model._avg_s = int(meta.get("avg_s", 0))
        model._cycles_done = int(meta.get("cycles_done", 0))

    if from_jax:
        # a JAX key has no torch counterpart: the constructor's generator
        # stays, so the chain goes on in distribution, not draw for draw
        _stream_warning("by the JAX package, whose threefry key does not carry "
                        "over to a torch.Generator; the chain continues from the "
                        "constructor's generator")
    else:
        model._gen.set_state(torch.from_numpy(arrays["rng_state"]))
    return meta
