"""Carry a trained Labeled-LDA state from NumPy arrays into the port.

The arrays are those that ``lda_thesis_tpu/utils/checkpoint.save_model``
writes for a fused ``LabeledLDA``: per bucket ``z_{g} (U_g, D_g)`` and
``n_dk_{g} (A, D_g)``, the tables ``n_vk (V, Kp)`` and ``n_k (Kp,)``, and the
thinned means ``ph_hat (V, Kp)`` and ``th_hat (D, Kp)`` in original document
order.  The target model must be built over the same documents, labels,
dictionary and ``n_buckets``, so that its buckets match.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from .ops.gibbs_fused import FusedBucketState

__all__ = ["labeled_lda_state_from_numpy"]


def labeled_lda_state_from_numpy(arrays: Mapping[str, np.ndarray], model) -> None:
    """Load ``arrays`` into ``model`` (a port ``LabeledLDA``) on its device.

    Raises ``ValueError`` when the bucket count or any shape differs from
    the model's.
    """
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
        return torch.as_tensor(np.ascontiguousarray(a)).to(device=model.device, dtype=dtype)

    zs, ndks = [], []
    for g in range(G):
        U_g, D_g = model._toks_v_t[g].shape
        zs.append(take(f"z_{g}", (U_g, D_g), torch.int32))
        ndks.append(take(f"n_dk_{g}", (model.A, D_g), torch.float32))
    table = (model.V, model.Kp)
    model.counts = FusedBucketState(
        z=tuple(zs), n_dk=tuple(ndks),
        n_vk=take("n_vk", table, torch.float32),
        n_k=take("n_k", (model.Kp,), torch.float32))
    model.ph_hat = take("ph_hat", table, torch.float32)
    th = take("th_hat", (model.D, model.Kp), torch.float32)
    model._th_hat_t = tuple(th[torch.as_tensor(ix, device=model.device)]
                            for ix in model.buckets.doc_idx)
