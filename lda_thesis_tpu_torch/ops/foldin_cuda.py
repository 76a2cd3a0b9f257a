"""The fold-in sweep kernel: CUDA wrapper and torch's scan-width rule.

One fold-in sweep (``ops/gibbs.foldin_sweep``: every position of every
held-out document, in order, against a frozen φ) is one launch of
``csrc/foldin.cu``, one warp per document.  Its draws are the plain
version's bit for bit: the kernel repeats each floating-point operation of
``ops/gibbs._foldin_positions`` and the summation order of ``torch.cumsum``
over the innermost dim of a ``(D, K)`` tensor on a card, which
:func:`scan_log_width` gives from ``(D, K)`` alone.

On a CUDA tensor :func:`foldin_positions` launches the kernel or raises; on
a CPU tensor it runs the plain version, ``ops/gibbs._foldin_positions``.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import Tuple

import torch

from . import _nvcc
from .draw_update_cuda import _check

__all__ = ["foldin_positions", "scan_log_width", "build"]

SOURCE = _nvcc.CSRC / "foldin.cu"

# Kernel launches since import (or since a caller reset them): one per sweep.
launches = 0

_U32 = 0xFFFFFFFF


def scan_log_width(num_rows: int, row_size: int) -> int:
    """torch's ``get_log_num_threads_x_inner_scan(num_rows, row_size)``
    (``ATen/native/cuda/ScanUtils.cuh``) in its ``uint32_t`` arithmetic:
    ``lx`` in [4, 9], so that a cumsum over the innermost dim of a
    ``(num_rows, row_size)`` tensor scans chunks of ``2^(lx+1)`` elements.
    A difference of the two sizes' ceil-log2 below -9 wraps around to a
    large number and gives 9."""
    lx = 0
    while (1 << lx) < row_size:
        lx += 1
    ly = 0
    while (1 << ly) < num_rows:
        ly += 1
    diff = (lx - ly) & _U32
    return min(max(4, ((9 + diff) & _U32) // 2), 9)


def build() -> Tuple[Path, float, str]:
    """Compile the kernel if its library is missing; see :func:`._nvcc.build`."""
    return _nvcc.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    ptr, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.foldin_sweep_launch.argtypes = ([ptr] * 7 + [i64, i64, ctypes.c_float]
                                        + [i32] * 4 + [ptr])
    lib.foldin_sweep_launch.restype = ctypes.c_int
    return lib


def foldin_positions(z, n_dk, tv, ff, phi, alpha, u) -> None:
    """One fold-in sweep of ``ops/gibbs._foldin_positions``, in place.

    ``z (D, U)`` int32 topics and ``n_dk (D, K)`` float32 counts are
    updated; ``tv (D, U)`` int64 words (rows of ``phi``), ``ff (D, U)``
    float32 frequencies, ``phi (V, K)`` float32, ``u (U, D)`` float32
    uniforms; ``alpha`` a number or a float32 tensor that broadcasts
    against ``(D, K)``.  CPU tensors run the plain version; CUDA tensors
    (all contiguous) launch the kernel once, nothing for an empty state.
    """
    global launches
    D, U = tv.shape
    K = n_dk.shape[1]
    dev = n_dk.device
    f32 = torch.float32
    _check(dev, z=(z, (D, U), torch.int32), n_dk=(n_dk, (D, K), f32),
           tv=(tv, (D, U), torch.int64), ff=(ff, (D, U), f32),
           phi=(phi, (phi.shape[0], K), f32), u=(u, (U, D), f32))
    if dev.type == "cpu":
        from .gibbs import _foldin_positions

        return _foldin_positions(z, n_dk, tv, ff, phi, alpha, u)
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    if not all(t.is_contiguous() for t in (z, n_dk, tv, ff, phi, u)):
        raise ValueError("kernel inputs must be contiguous")
    alpha_t, strides, scalar = None, (0, 0), 0.0
    if torch.is_tensor(alpha):
        _check(dev, alpha=(alpha, alpha.shape, f32))
        alpha_t = torch.broadcast_to(alpha, (D, K))
        strides = alpha_t.stride()
    else:
        scalar = float(alpha)
    if D == 0 or U == 0 or K == 0:
        return
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = _library().foldin_sweep_launch(
            z.data_ptr(), n_dk.data_ptr(), tv.data_ptr(), ff.data_ptr(), phi.data_ptr(),
            u.data_ptr(), None if alpha_t is None else alpha_t.data_ptr(), *strides, scalar,
            D, U, K, scan_log_width(D, K), stream)
    if err != 0:
        raise RuntimeError(f"foldin kernel launch failed: CUDA error {err}")
    launches += 1
