"""Exact-sweep draw-update kernel: CUDA wrapper and its plain PyTorch version.

:func:`draw_update` runs one type position of the exact dense collapsed-Gibbs
sweep for every document row: decrement ``n_dk`` at ``z_old``, form the
posterior weights, draw the new topic by inverse CDF, increment ``n_dk`` and
return the topic totals' change.  It is the counterpart of
``lda_thesis_tpu/ops/gibbs_pallas.fused_draw_update``, whose Pallas kernel
``_build`` the CUDA kernel ``csrc/draw_update.cu`` replaces; the ``(K, K)``
triangular matrix that the TPU kernel takes for its cumsum is not needed.

On a CUDA tensor it launches that kernel; on a CPU tensor it runs
:func:`draw_update_torch`, which repeats the kernel's floating-point
operations in the same order, so the two agree bit for bit.  Both update
``n_dk`` in place (the TPU kernel aliases it to its output) and return it.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from . import _nvcc

__all__ = ["draw_update", "draw_update_torch", "build"]

SOURCE = _nvcc.CSRC / "draw_update.cu"
LANES = 32  # one warp per document row

# Number of kernel launches since import (or since a caller reset it).
launches = 0


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; see :func:`._nvcc.build`."""
    return _nvcc.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.draw_update_launch.argtypes = [ptr] * 9 + [i32, i32, f32, f32, ptr]
    lib.draw_update_launch.restype = ctypes.c_int
    return lib


def _check_inputs(u, f, z_old, labs, n_dk, cv, recip) -> Tuple[int, int]:
    if n_dk.dim() != 2:
        raise ValueError(f"n_dk must be (D, K), got shape {tuple(n_dk.shape)}")
    D, K = n_dk.shape
    want = {
        "u": (u, (D,), torch.float32),
        "f": (f, (D,), torch.float32),
        "z_old": (z_old, (D,), torch.int32),
        "labs": (labs, (D, K), torch.float32),
        "n_dk": (n_dk, (D, K), torch.float32),
        "cv": (cv, (D, K), torch.float32),
        "recip": (recip, (K,), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != n_dk.device:
            raise ValueError(f"{name} is on {t.device}, n_dk on {n_dk.device}")
    if K < 1:
        raise ValueError("the topic axis is empty")
    return D, K


def draw_update(u, f, z_old, labs, n_dk, cv, recip, alpha: float,
                beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact-sweep position; returns ``(n_dk, z_new (D,) int32, dnk (K,))``.

    ``u (D,)`` uniforms, ``f (D,)`` type frequencies, ``z_old (D,)`` current
    topics, ``labs (D, K)`` label mask, ``n_dk (D, K)`` doc-topic counts
    (updated in place), ``cv (D, K)`` the rows ``n_vk[v]`` after the
    position's decrement, ``recip (K,)`` ``1/(n_k⁻ + V·β)``.  ``dnk`` is the
    change of the topic totals, increments minus decrements.  CPU tensors
    take :func:`draw_update_torch`; CUDA tensors launch the kernel.
    """
    global launches
    D, K = _check_inputs(u, f, z_old, labs, n_dk, cv, recip)
    if n_dk.device.type == "cpu":
        return draw_update_torch(u, f, z_old, labs, n_dk, cv, recip, alpha, beta)
    if n_dk.device.type != "cuda":
        raise ValueError(f"no kernel for device {n_dk.device}")
    tensors = (u, f, z_old, labs, n_dk, cv, recip)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("draw_update inputs must be contiguous")
    lib = _library()
    z_new = torch.empty((D,), dtype=torch.int32, device=n_dk.device)
    dnk = torch.zeros((K,), dtype=torch.float32, device=n_dk.device)
    if D == 0:
        return n_dk, z_new, dnk
    with torch.cuda.device(n_dk.device):
        stream = torch.cuda.current_stream(n_dk.device).cuda_stream
        err = lib.draw_update_launch(
            *(t.data_ptr() for t in tensors), z_new.data_ptr(), dnk.data_ptr(),
            D, K, float(alpha), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"draw_update kernel launch failed: CUDA error {err}")
    launches += 1
    return n_dk, z_new, dnk


def _lane_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over dim 1 in the kernel's order: each of 32 lanes
    sums its ``ceil(K/32)`` contiguous topics from 0, the lane totals are
    scanned Hillis–Steele across the lanes, and each lane adds the scan at
    the lane before it (0 for lane 0)."""
    D, K = w.shape
    per = (K + LANES - 1) // LANES
    wl = torch.nn.functional.pad(w, (0, LANES * per - K)).view(D, LANES, per)
    p = torch.empty_like(wl)
    s = torch.zeros((D, LANES), dtype=w.dtype, device=w.device)
    for j in range(per):
        s = s + wl[:, :, j]
        p[:, :, j] = s
    incl = s
    off = 1
    while off < LANES:
        incl = torch.cat([incl[:, :off], incl[:, off:] + incl[:, :-off]], dim=1)
        off *= 2
    base = torch.cat([torch.zeros_like(incl[:, :1]), incl[:, :-1]], dim=1)
    return (base[:, :, None] + p).view(D, LANES * per)[:, :K]


def draw_update_torch(u, f, z_old, labs, n_dk, cv, recip, alpha: float,
                      beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`draw_update`, all rows at once.

    Same operations in the same order as ``csrc/draw_update.cu`` (see its
    header): ``((labs·(n_dk−own+α))·(cv+β))·recip`` and the lane-then-warp
    cumsum of :func:`_lane_cumsum`, no matmul.  Rows with ``f == 0`` are
    computed and their draw discarded, which leaves the same bits as the
    kernel's skip.  ``n_dk`` is updated in place.
    """
    D, K = n_dk.shape
    topic = torch.arange(K, device=n_dk.device)[None, :]
    fo = torch.where(topic == z_old[:, None], f[:, None], 0.0)
    n_m = n_dk - fo
    w = ((labs * (n_m + alpha)) * (cv + beta)) * recip
    c = _lane_cumsum(w)
    r = u * c[:, K - 1]
    z_new = (c < r[:, None]).sum(dim=1, dtype=torch.int32).clamp_(max=K - 1)
    z_new = torch.where(f > 0, z_new, z_old)
    fn = torch.where(topic == z_new[:, None], f[:, None], 0.0)
    n_dk.copy_(n_m + fn)
    dnk = torch.zeros((K,), dtype=torch.float32, device=n_dk.device)
    dnk.index_add_(0, z_old.long(), -f)
    dnk.index_add_(0, z_new.long(), f)
    return n_dk, z_new, dnk
