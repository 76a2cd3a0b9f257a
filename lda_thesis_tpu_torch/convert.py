"""Carry a trained Labeled-LDA state from NumPy arrays into the port.

The arrays are those that ``lda_thesis_tpu/utils/checkpoint.save_model``
writes for a ``LabeledLDA``: per bucket ``z_{g}`` and ``n_dk_{g}``, the
tables ``n_vk (V, Kp)`` and ``n_k (Kp,)``, and the thinned means
``ph_hat (V, Kp)`` and ``th_hat (D, Kp)`` in original document order.  The
per-bucket layout depends on the sampler (the checkpoint meta's ``sweep``):

* ``fused``: ``z_{g} (U_g, D_g)`` slot indices, ``n_dk_{g} (A, D_g)``;
* ``dense``: ``z_{g} (D_g, U_g)`` topics, ``n_dk_{g} (D_g, Kp)``;
* ``compact``: ``z_{g} (D_g, U_g)`` slot indices, ``n_dk_{g} (D_g, A)``.

The target model must be built with the same sampler over the same
documents, labels, dictionary and ``n_buckets``, so that its buckets match.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import numpy as np
import torch

from .ops.gibbs import BucketLDAState, CompactBucketState
from .ops.gibbs_fused import FusedBucketState

__all__ = ["labeled_lda_state_from_numpy"]


def labeled_lda_state_from_numpy(arrays: Mapping[str, np.ndarray], model,
                                 meta: Optional[Mapping[str, Any]] = None) -> None:
    """Load ``arrays`` into ``model`` (a port ``LabeledLDA``) on its device.

    ``meta`` is the checkpoint's metadata; where it names a ``sweep``, that
    must be the model's.  Raises ``ValueError`` when the sampler, the bucket
    count or any shape differs from the model's.
    """
    sweep = (meta or {}).get("sweep", model.sweep)
    if sweep != model.sweep:
        raise ValueError(f"sweep mismatch: arrays are {sweep!r}, model {model.sweep!r}")
    G = model.buckets.n_buckets
    got_g = sum(1 for k in arrays if k.startswith("z_"))
    if got_g != G:
        raise ValueError(f"bucket count mismatch: arrays have {got_g}, model {G}")

    def take(name, shape, dtype):
        if name not in arrays:
            raise ValueError(f"missing array {name!r}")
        a = np.asarray(arrays[name])
        if a.shape != tuple(shape):
            raise ValueError(f"{name} has shape {a.shape}, model needs {tuple(shape)}")
        return torch.tensor(a, dtype=dtype, device=model.device)  # a copy: sweeps update in place

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
    model.counts = state(
        z=tuple(zs), n_dk=tuple(ndks),
        n_vk=take("n_vk", table, torch.float32),
        n_k=take("n_k", (model.Kp,), torch.float32))
    model.ph_hat = take("ph_hat", table, torch.float32)
    th = take("th_hat", (model.D, model.Kp), torch.float32)
    model._th_hat_t = tuple(th[torch.as_tensor(ix, device=model.device)]
                            for ix in model.buckets.doc_idx)
