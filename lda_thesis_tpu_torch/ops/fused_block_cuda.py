"""Merge-block sampler kernel: CUDA wrapper and its plain PyTorch version.

:func:`fused_block` runs ``M`` collapsed-Gibbs sweeps of every document
against a topic-word table frozen at block start (the algorithm of
``lda_thesis_tpu/ops/gibbs_fused.py``, whose Pallas kernel
``_build_block_kernel`` the CUDA kernels of ``csrc/fused_block.cu``
replace).  On a CUDA tensor it launches one of them; on a CPU tensor it
runs :func:`fused_block_torch`, which repeats their floating-point
operations in the same order, so the two agree bit for bit.  Every route
walks only a document's positions with f > 0, and :func:`route` picks one
per launch from ``(U, A)``:

* ``"staged"`` (A <= 32 and U <= :func:`max_positions` ``(A)``): one warp
  per document, one lane per slot, the document's frozen operands and
  uniforms staged in shared memory;
* ``"warp"`` (32 < A <= 32 · :data:`WARP_ROWS_MAX`, and A <= 32 past the
  staged limit): one warp per document, each lane on ``ceil(A/32)`` slots in
  registers, the cv rows streamed through a small ring in shared memory;
* ``"wide"`` (32 · :data:`WARP_ROWS_MAX` < A <= :func:`wide_max_slots`): one
  warp per document as the warp route's, its first ``WARP_ROWS_MAX`` rows
  of 32 slots in registers and the rest in shared memory;
* ``"general"`` (wider still): one CTA per document, one thread per slot,
  its operands read from global memory.

The kernel is compiled with ``nvcc`` at first use and loaded with ``ctypes``
(:mod:`._nvcc`); importing this module needs neither ``nvcc`` nor a card.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from . import _nvcc

__all__ = ["fused_block", "fused_block_torch", "build", "max_positions", "wide_max_slots",
           "route", "choose_route"]

SOURCE = _nvcc.CSRC / "fused_block.cu"
STAGED_SLOTS = 32  # the staged route: one lane per slot
# S_MAX, the warp route's rows of 32 slots per lane (kWarpRowsMax in the .cu)
WARP_ROWS_MAX = 8
ROUTES = ("staged", "warp", "wide", "general")

# Number of kernel launches since import (or since a caller reset it), of
# every route, and of the warp, wide and general routes alone.
launches = 0
warp_launches = 0
wide_launches = 0
general_launches = 0


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; see :func:`._nvcc.build`."""
    return _nvcc.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.fused_block_launch.argtypes = [ptr] * 9 + [i32] * 4 + [f32, f32, ptr]
    lib.fused_block_launch.restype = ctypes.c_int
    lib.fused_block_max_positions.argtypes = [i32]
    lib.fused_block_max_positions.restype = ctypes.c_int
    lib.fused_block_general_launch.argtypes = [ptr] * 10 + [i32] * 4 + [f32, f32, ptr]
    lib.fused_block_general_launch.restype = ctypes.c_int
    lib.fused_block_general_state_bytes.argtypes = [i32]
    lib.fused_block_general_state_bytes.restype = ctypes.c_longlong
    lib.fused_block_smem_limit.argtypes = []
    lib.fused_block_smem_limit.restype = ctypes.c_int
    lib.fused_block_warp_launch.argtypes = [ptr] * 9 + [i32] * 4 + [f32, f32, ptr]
    lib.fused_block_warp_launch.restype = ctypes.c_int
    lib.fused_block_wide_launch.argtypes = [ptr] * 9 + [i32] * 4 + [f32, f32, ptr]
    lib.fused_block_wide_launch.restype = ctypes.c_int
    lib.fused_block_wide_max_slots.argtypes = []
    lib.fused_block_wide_max_slots.restype = ctypes.c_int
    lib.fused_block_warp_rows_max.argtypes = []
    lib.fused_block_warp_rows_max.restype = ctypes.c_int
    if lib.fused_block_warp_rows_max() != WARP_ROWS_MAX:
        raise RuntimeError("fused_block.cu's kWarpRowsMax differs from WARP_ROWS_MAX")
    return lib


@functools.lru_cache(maxsize=None)
def max_positions(A: int, index: int = 0) -> int:
    """The largest U the staged route takes at ``A`` (1..32) slots on CUDA
    device ``index``: one document's staging must fit one CTA's shared
    memory (563 positions at A = 32 on an H100).  Wider documents take the
    warp route."""
    if not 1 <= A <= STAGED_SLOTS:
        raise ValueError(f"the staged route takes 1..{STAGED_SLOTS} slots, got A={A}")
    with torch.cuda.device(index):
        U = _library().fused_block_max_positions(A)
    if U < 0:
        raise RuntimeError("fused_block_max_positions failed: no CUDA device")
    return U


@functools.lru_cache(maxsize=None)
def wide_max_slots(index: int = 0) -> int:
    """The widest A the wide route takes on CUDA device ``index``: one
    document's ring and per-slot state must fit one CTA's shared memory
    (9,852 slots on an H100).  Wider documents take the general route."""
    with torch.cuda.device(index):
        A = _library().fused_block_wide_max_slots()
    if A < 0:
        raise RuntimeError("fused_block_wide_max_slots failed: no CUDA device")
    return A


def choose_route(U: int, A: int, staged_limit: int, wide_limit: int) -> str:
    """The route of a launch at ``U`` positions and ``A`` slots, given the
    staged route's position limit at ``A`` (consulted only for A <= 32)
    and the wide route's widest A (consulted only past the warp route's):
    ``"staged"`` where one document's staging fits one CTA, else ``"warp"``
    up to ``32 *`` :data:`WARP_ROWS_MAX` slots, else ``"wide"`` up to
    ``wide_limit``, else ``"general"``."""
    if A <= STAGED_SLOTS and U <= staged_limit:
        return "staged"
    if A <= STAGED_SLOTS * WARP_ROWS_MAX:
        return "warp"
    return "wide" if A <= wide_limit else "general"


def route(U: int, A: int, index: int = 0) -> str:
    """The kernel a CUDA launch at ``U`` positions and ``A`` slots takes on
    CUDA device ``index`` (:func:`choose_route` with that card's limits)."""
    staged = max_positions(A, index) if A <= STAGED_SLOTS else 0
    wide = wide_max_slots(index) if A > STAGED_SLOTS * WARP_ROWS_MAX else 0
    return choose_route(U, A, staged, wide)


@functools.lru_cache(maxsize=None)
def _general_scratch_floats(A: int, index: int) -> int:
    """Floats of global scratch per document that the general route needs
    at ``A`` slots: 0 where its state fits in shared memory."""
    with torch.cuda.device(index):
        lib = _library()
        state, limit = lib.fused_block_general_state_bytes(A), lib.fused_block_smem_limit()
    if state < 0 or limit < 0:
        raise RuntimeError("fused_block_general_state_bytes failed: no CUDA device")
    return 0 if state <= limit else state // 4


def _check_inputs(cv, f, uniforms, z0, nkg, valid, ndk0) -> Tuple[int, int, int, int]:
    if cv.dim() != 3:
        raise ValueError(f"cv must be (D, U, A), got shape {tuple(cv.shape)}")
    D, U, A = cv.shape
    if A < 1:
        raise ValueError("fused_block needs at least one slot, got A=0")
    M = uniforms.shape[0]
    want = {
        "f": (f, (U, D), torch.float32),
        "uniforms": (uniforms, (M, U, D), torch.float32),
        "z0": (z0, (U, D), torch.int32),
        "nkg": (nkg, (A, D), torch.float32),
        "valid": (valid, (A, D), torch.float32),
        "ndk0": (ndk0, (A, D), torch.float32),
        "cv": (cv, (D, U, A), torch.float32),
    }
    for name, (t, shape, dtype) in want.items():
        if tuple(t.shape) != shape:
            raise ValueError(f"{name} must have shape {shape}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != cv.device:
            raise ValueError(f"{name} is on {t.device}, cv on {cv.device}")
    return M, U, A, D


def fused_block(cv, f, uniforms, z0, nkg, valid, ndk0, alpha: float,
                beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """``M`` frozen-table Gibbs sweeps; returns ``(z (U, D) int32, n_dk (A, D))``.

    ``cv (D, U, A)`` per-slot block-start topic-word counts (doc-major),
    ``f (U, D)`` type frequencies, ``uniforms (M, U, D)`` one uniform per
    draw, ``z0 (U, D)`` block-start slots, ``nkg (A, D)`` block-start topic
    totals pre-biased by V·β, ``valid (A, D)`` slot mask, ``ndk0 (A, D)``
    doc-topic counts.  CPU tensors take :func:`fused_block_torch`; CUDA
    tensors launch a kernel of the route :func:`route` picks, at any shape.
    """
    M, U, A, D = _check_inputs(cv, f, uniforms, z0, nkg, valid, ndk0)
    if cv.device.type == "cpu":
        return fused_block_torch(cv, f, uniforms, z0, nkg, valid, ndk0, alpha, beta)
    if cv.device.type != "cuda":
        raise ValueError(f"no kernel for device {cv.device}")
    return _launch(route(U, A, cv.device.index), cv, f, uniforms, z0, nkg, valid, ndk0,
                   alpha, beta)


def _launch(kernel: str, cv, f, uniforms, z0, nkg, valid, ndk0, alpha: float,
            beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch route ``kernel`` on CUDA tensors and count it.  :func:`fused_block`
    passes the route :func:`route` names; a measurement may name another
    route that takes the shape (``"warp"`` at any A <= 256, ``"wide"`` at
    256 < A <= :func:`wide_max_slots`, ``"general"`` at any A)."""
    global launches, warp_launches, wide_launches, general_launches
    if kernel not in ROUTES:
        raise ValueError(f"no route {kernel!r}; the routes are {ROUTES}")
    M, U, A, D = _check_inputs(cv, f, uniforms, z0, nkg, valid, ndk0)
    tensors = (cv, f, uniforms, z0, nkg, valid, ndk0)
    if cv.device.type != "cuda":
        raise ValueError(f"the {kernel} route runs on a CUDA device, not {cv.device}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("fused_block inputs must be contiguous")
    index = cv.device.index
    lib = _library()
    z_out = torch.empty((U, D), dtype=torch.int32, device=cv.device)
    ndk_out = torch.empty((A, D), dtype=torch.float32, device=cv.device)
    if D == 0:
        return z_out, ndk_out
    with torch.cuda.device(cv.device):
        stream = torch.cuda.current_stream(cv.device).cuda_stream
        ptrs = [t.data_ptr() for t in (*tensors, z_out, ndk_out)]
        if kernel == "staged":
            err = lib.fused_block_launch(*ptrs, M, U, A, D, float(alpha), float(beta), stream)
        elif kernel == "warp":
            err = lib.fused_block_warp_launch(*ptrs, M, U, A, D, float(alpha), float(beta),
                                              stream)
        elif kernel == "wide":
            err = lib.fused_block_wide_launch(*ptrs, M, U, A, D, float(alpha), float(beta),
                                              stream)
        else:
            per_doc = _general_scratch_floats(A, index)
            scratch = (torch.empty(D * per_doc, dtype=torch.float32, device=cv.device)
                       if per_doc else None)
            err = lib.fused_block_general_launch(
                *ptrs, None if scratch is None else scratch.data_ptr(), M, U, A, D,
                float(alpha), float(beta), stream)
    if err != 0:
        raise RuntimeError(f"fused_block {kernel} kernel launch failed: CUDA error {err}")
    launches += 1
    warp_launches += kernel == "warp"
    wide_launches += kernel == "wide"
    general_launches += kernel == "general"
    return z_out, ndk_out


GROUP = 8  # the kernel's scan groups of lanes


def _group_scan(w: torch.Tensor) -> torch.Tensor:
    """Inclusive scan over dim 0 in the kernel's order: a Hillis–Steele scan
    within each group of eight slots (zero-padded), then each slot adds the
    sum of the groups before it, ``P = [0, T0, T0+T1, (T0+T1)+T2]``."""
    A, D = w.shape
    n_groups = -(-A // GROUP)
    c = torch.cat([w, w.new_zeros((n_groups * GROUP - A, D))]).view(n_groups, GROUP, D)
    off = 1
    while off < GROUP:
        c = torch.cat([c[:, :off], c[:, off:] + c[:, :-off]], dim=1)
        off *= 2
    before = [w.new_zeros((D,))]
    for h in range(n_groups - 1):
        before.append(before[-1] + c[h, GROUP - 1])  # 0 + T0 == T0
    c = torch.stack(before)[:, None, :] + c
    return c.reshape(n_groups * GROUP, D)[:A]


def fused_block_torch(cv, f, uniforms, z0, nkg, valid, ndk0, alpha: float,
                      beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`fused_block`, all documents at once.

    Same operations in the same order as ``csrc/fused_block.cu`` (see its
    header): the product is ``((valid·(n_dk+α))·((cv−own)+β))·(1/(nkg−own))``
    with a correctly rounded reciprocal, and the cumsum is the kernel's
    grouped order (:func:`_group_scan`).  Positions with ``f == 0`` are
    computed and their draw discarded, which leaves the same bits as the
    kernel's skip.
    """
    M, U, D = uniforms.shape
    A = ndk0.shape[0]
    slot = torch.arange(A, device=cv.device)[:, None]  # (A, 1)
    cv_pos = cv.permute(1, 2, 0)  # (U, A, D) view
    z = z0.clone()
    ndk = ndk0.clone()
    for m in range(M):
        for p in range(U):
            fp = f[p]
            own = torch.where(slot == z0[p], fp, 0.0)
            ndk_m = ndk - torch.where(slot == z[p], fp, 0.0)
            w = valid * (ndk_m + alpha)
            w = w * ((cv_pos[p] - own) + beta)
            w = w * torch.reciprocal(nkg - own)
            c = _group_scan(w)
            r = uniforms[m, p] * c[A - 1]
            zn = (c < r).sum(dim=0, dtype=torch.int32)
            zn = torch.where(fp > 0, zn, z[p])
            ndk = ndk_m + torch.where(slot == zn, fp, 0.0)
            z[p] = zn
    return z, ndk
