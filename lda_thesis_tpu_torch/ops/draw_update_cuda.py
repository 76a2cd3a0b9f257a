"""Exact-sweep draw and count-commit kernels: CUDA wrappers and plain versions.

One type position of the exact dense collapsed-Gibbs sweep is two launches
of ``csrc/draw_update.cu``: :func:`commit_counts` applies the previous
position's increments and this position's decrements to the topic-word table
``n_vk`` and the topic totals ``n_k``, then :func:`draw_rows` draws every live
row's topic, reading its word's table row in place, and updates ``n_dk`` and
``z``.  :func:`draw_update` is the op-level counterpart of
``lda_thesis_tpu/ops/gibbs_pallas.fused_draw_update``, whose Pallas kernel
``_build`` the draw kernel replaces: given the gathered rows ``cv`` and
``recip`` it returns ``(n_dk, z_new, Δn_k)``.

:func:`draw_rows` and :func:`commit_counts` take an optional leading chain
axis on the state (``u``, ``z``, ``n_dk``, the table and ``n_k``): the
chains share the position's frequencies, label mask, live rows and their
words, and one launch covers every chain, each drawing against its own
table exactly as a single-chain launch would.

On a CUDA tensor each wrapper launches its kernel; on a CPU tensor it runs
its plain PyTorch version, which repeats the kernel's floating-point
operations in the same order, so the two agree bit for bit.  Counts are
float32 integers below 2^24, so count updates are exact in any order.
"""

from __future__ import annotations

import ctypes
import functools
from pathlib import Path
from typing import NamedTuple, Optional, Tuple

import torch

from . import _nvcc

__all__ = ["Slots", "draw_update", "draw_update_torch", "draw_rows", "draw_rows_torch",
           "commit_counts", "commit_counts_torch", "build"]

SOURCE = _nvcc.CSRC / "draw_update.cu"
LANES = 32  # one warp per document row; topic k is lane k % 32 of chunk k // 32

# Kernel launches since import (or since a caller reset them): draws
# (draw_update and draw_rows) and commits.
launches = 0
commit_launches = 0


class Slots(NamedTuple):
    """One type position's slots: ``rows (D,)`` int64 table row (word) of each
    document, ``z (D,)`` int32 topic (``(C, D)``, each chain's, with a chain
    axis), ``f (D,)`` float32 frequency, and ``live (n,)`` int32 the rows with
    f > 0."""

    rows: torch.Tensor
    z: torch.Tensor
    f: torch.Tensor
    live: torch.Tensor


def build() -> Tuple[Path, float, str]:
    """Compile the kernels if their library is missing; see :func:`._nvcc.build`."""
    return _nvcc.build(SOURCE)


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = _nvcc.load(SOURCE)
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    i64 = ctypes.c_longlong
    lib.draw_update_launch.argtypes = ([ptr] * 12 + [i32, i32, f32, f32, f32, i32]
                                       + [i64] * 5 + [ptr])
    lib.draw_update_launch.restype = ctypes.c_int
    lib.count_commit_launch.argtypes = ([ptr, ptr, i32] + ([ptr] * 4 + [i32]) * 2
                                        + [i32] + [i64] * 3 + [ptr])
    lib.count_commit_launch.restype = ctypes.c_int
    return lib


def _check(device, **tensors) -> None:
    """Each value is ``(tensor, shape, dtype)``; all on ``device``."""
    for name, (t, shape, dtype) in tensors.items():
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must have shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.dtype != dtype:
            raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, expected {device}")


def _kernel_device(device: torch.device, tensors, chained=()) -> None:
    """Raise unless the kernel can take these tensors: CUDA, and contiguous
    (``chained``: each chain's slice contiguous, any chain stride)."""
    if device.type != "cuda":
        raise ValueError(f"no kernel for device {device}")
    if not all(t.is_contiguous() for t in tensors) or not all(
            t[0].is_contiguous() for t in chained):
        raise ValueError("kernel inputs must be contiguous")


def _stride(t: torch.Tensor, chains: Optional[int]) -> int:
    """Chain stride (elements) of ``t`` for the kernels; 0 without a chain
    axis or with one chain."""
    return t.stride(0) if chains is not None and chains > 1 else 0


def _chains(x: torch.Tensor, dims: int) -> Optional[int]:
    """Length of the leading chain axis of ``x``, whose single-chain form has
    ``dims`` dimensions; None without one."""
    if x.dim() == dims:
        return None
    if x.dim() != dims + 1:
        raise ValueError(f"expected {dims} or {dims + 1} dimensions, got shape "
                         f"{tuple(x.shape)}")
    return x.shape[0]


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _launch_draw(u, f, z_old, z_new, labs, n_dk, table, rows, n_k, recip, dnk, live,
                 n: int, alpha: float, beta: float, vbeta: float,
                 chains: Optional[int] = None) -> None:
    """One launch; given ``chains``, the state tensors carry a leading chain
    axis of that length (``z_old`` is ``z_new``)."""
    global launches
    strides = [_stride(t, chains) for t in (u, z_old, n_dk, table, n_k)]
    with torch.cuda.device(n_dk.device):
        stream = torch.cuda.current_stream(n_dk.device).cuda_stream
        err = _library().draw_update_launch(
            *(_ptr(t) for t in (u, f, z_old, z_new, labs, n_dk, table, rows, n_k, recip,
                                dnk, live)),
            n, n_dk.shape[-1], float(alpha), float(beta), float(vbeta), chains or 1,
            *strides, stream)
    if err != 0:
        raise RuntimeError(f"draw_update kernel launch failed: CUDA error {err}")
    launches += 1


def draw_update(u, f, z_old, labs, n_dk, cv, recip, alpha: float,
                beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One exact-sweep position over all rows; returns ``(n_dk, z_new (D,)
    int32, dnk (K,))``.

    ``u (D,)`` uniforms, ``f (D,)`` type frequencies, ``z_old (D,)`` current
    topics, ``labs (D, K)`` label mask, ``n_dk (D, K)`` doc-topic counts
    (updated in place), ``cv (D, K)`` the rows ``n_vk[v]`` after the
    position's decrement, ``recip (K,)`` ``1/(n_k⁻ + V·β)``.  ``dnk`` is the
    change of the topic totals, increments minus decrements.  CPU tensors
    take :func:`draw_update_torch`; CUDA tensors launch the draw kernel with
    ``cv`` as its table and row d of it for document d.
    """
    if n_dk.dim() != 2:
        raise ValueError(f"n_dk must be (D, K), got shape {tuple(n_dk.shape)}")
    D, K = n_dk.shape
    if K < 1:
        raise ValueError("the topic axis is empty")
    f32 = torch.float32
    _check(n_dk.device, u=(u, (D,), f32), f=(f, (D,), f32), z_old=(z_old, (D,), torch.int32),
           labs=(labs, (D, K), f32), cv=(cv, (D, K), f32), recip=(recip, (K,), f32))
    if n_dk.device.type == "cpu":
        return draw_update_torch(u, f, z_old, labs, n_dk, cv, recip, alpha, beta)
    _kernel_device(n_dk.device, (u, f, z_old, labs, n_dk, cv, recip))
    z_new = torch.empty((D,), dtype=torch.int32, device=n_dk.device)
    dnk = torch.zeros((K,), dtype=f32, device=n_dk.device)
    if D:
        _launch_draw(u, f, z_old, z_new, labs, n_dk, cv, None, None, recip, dnk, None, D,
                     alpha, beta, 0.0)
    return n_dk, z_new, dnk


def draw_rows(u, f, z, labs, n_dk, table, rows, n_k, live, alpha: float, beta: float,
              vbeta: float) -> None:
    """Draw the topics of the rows ``live`` at one position, in place.

    ``u, f (D,)`` float32, ``z (D,)`` int32 topics (overwritten with the
    draws), ``labs, n_dk (D, K)`` (``n_dk`` updated in place), ``table
    (V, K)`` the topic-word counts after the position's decrement, ``n_k
    (K,)`` the topic totals after the decrement, ``live (n,)`` int32 rows
    with f > 0 and ``rows (n,)`` int64 their words: row ``live[i]`` reads
    table row ``rows[i]`` in place.  The other rows are left as they are.
    With a leading chain axis of C on ``u (C, D)``, ``z (C, D)``, ``n_dk
    (C, D, K)``, ``table (C, V, K)`` and ``n_k (C, K)``, chain c draws its
    live rows against its own table and totals, exactly as a single-chain
    call on its slices would; ``f``, ``labs``, ``live`` and ``rows`` are
    shared.  ``u`` and ``z`` may be strided across chains (each chain's
    slice contiguous).  CPU tensors take :func:`draw_rows_torch`; CUDA
    tensors launch the draw kernel, once for all chains, and nothing when
    ``live`` is empty.
    """
    C = _chains(n_dk, 2)
    lead = () if C is None else (C,)
    D, K = n_dk.shape[-2:]
    V = table.shape[-2]
    f32 = torch.float32
    _check(n_dk.device, u=(u, lead + (D,), f32), f=(f, (D,), f32),
           z=(z, lead + (D,), torch.int32), labs=(labs, (D, K), f32),
           table=(table, lead + (V, K), f32), live=(live, live.shape[:1], torch.int32),
           rows=(rows, live.shape[:1], torch.int64), n_k=(n_k, lead + (K,), f32))
    if n_dk.device.type == "cpu":
        return draw_rows_torch(u, f, z, labs, n_dk, table, rows, n_k, live, alpha, beta,
                               vbeta)
    if C is None:
        _kernel_device(n_dk.device, (u, f, z, labs, n_dk, table, rows, n_k, live))
    else:
        _kernel_device(n_dk.device, (f, labs, n_dk, table, rows, n_k, live), (u, z))
    if live.numel():
        _launch_draw(u, f, z, z, labs, n_dk, table, rows, n_k, None, None, live,
                     live.numel(), alpha, beta, vbeta, C)


def commit_counts(table, n_k, dec: Optional[Slots], inc: Optional[Slots]) -> None:
    """``table[rows, z] += ±f`` and ``n_k[z] += ±f`` over the live slots of
    ``dec`` (−f) and ``inc`` (+f), in place.  With a leading chain axis of C
    on ``table (C, V, K)``, ``n_k (C, K)`` and each slot set's ``z (C, D)``
    (chain c's topics; its slice contiguous, any chain stride, the same
    stride in ``dec`` and ``inc``), chain c's slots land on its own table
    and totals; rows, f and live are shared.  CPU tensors take
    :func:`commit_counts_torch`; CUDA tensors launch the commit kernel, once
    for all chains, and nothing when there is no live slot."""
    global commit_launches
    C = _chains(table, 2)
    lead = () if C is None else (C,)
    V, K = table.shape[-2:]
    parts = [s for s in (dec, inc) if s is not None]
    for i, s in enumerate(parts):
        D = s.rows.shape[0]
        _check(table.device, **{f"rows{i}": (s.rows, (D,), torch.int64),
                                f"z{i}": (s.z, lead + (D,), torch.int32),
                                f"f{i}": (s.f, (D,), torch.float32),
                                f"live{i}": (s.live, s.live.shape[:1], torch.int32)})
    _check(table.device, n_k=(n_k, lead + (K,), torch.float32),
           table=(table, lead + (V, K), torch.float32))
    if table.device.type == "cpu":
        return commit_counts_torch(table, n_k, dec, inc)
    if C is None:
        _kernel_device(table.device, [table, n_k] + [t for s in parts for t in s])
    else:
        _kernel_device(table.device, [table, n_k] + [t for s in parts
                                                     for t in (s.rows, s.f, s.live)],
                       [s.z for s in parts])
    z_strides = {_stride(s.z, C) for s in parts}
    if len(z_strides) > 1:
        raise ValueError(f"dec.z and inc.z must share one chain stride, got {z_strides}")
    n_dec = 0 if dec is None else dec.live.numel()
    n_inc = 0 if inc is None else inc.live.numel()
    if n_dec + n_inc == 0:
        return

    def slot_args(s, n):
        return [None] * 4 + [0] if not n else [t.data_ptr() for t in s] + [n]

    strides = (z_strides.pop(), _stride(table, C), _stride(n_k, C))
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        err = _library().count_commit_launch(table.data_ptr(), n_k.data_ptr(), K,
                                             *slot_args(dec, n_dec),
                                             *slot_args(inc, n_inc), C or 1, *strides,
                                             stream)
    if err != 0:
        raise RuntimeError(f"count_commit kernel launch failed: CUDA error {err}")
    commit_launches += 1


# ---------------------------------------------------------------- plain versions


def _chunk_cumsum(w: torch.Tensor) -> torch.Tensor:
    """Inclusive cumsum over the last dim in the kernel's order: topic k is
    lane k % 32 of chunk k // 32; each chunk is scanned Hillis–Steele across
    its lanes (zero-padded past K), and chunk i adds the carry of the chunks
    before it, ``carry_{i+1} = carry_i + s_i[31]`` from ``carry_0 = 0``."""
    lead, K = w.shape[:-1], w.shape[-1]
    w = w.reshape(-1, K)
    D = w.shape[0]
    n_chunks = -(-K // LANES)
    s = torch.nn.functional.pad(w, (0, n_chunks * LANES - K)).view(D, n_chunks, LANES)
    off = 1
    while off < LANES:
        s = torch.cat([s[:, :, :off], s[:, :, off:] + s[:, :, :-off]], dim=2)
        off *= 2
    carry = [w.new_zeros((D,))]
    for i in range(n_chunks - 1):
        carry.append(carry[-1] + s[:, i, LANES - 1])
    c = torch.stack(carry, dim=1)[:, :, None] + s
    return c.reshape(D, n_chunks * LANES)[:, :K].reshape(*lead, K)


def _draw_torch(u, f, z_old, labs, n_dk, cv, recip, alpha: float,
                beta: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """The kernel's draw on every row: ``(n_dk after the update, z_new)``,
    new tensors.  Rows with ``f == 0`` are computed and their draw
    discarded, which leaves the same bits as the kernel's skip.  Rows are
    the last dim but one; the inputs broadcast, so a chain axis in front
    (``n_dk``, ``cv`` ``(C, n, K)``, ``u``, ``z_old`` ``(C, n)``, ``recip``
    ``(C, 1, K)``) with shared ``f (n,)`` and ``labs (n, K)`` gives each
    chain its own rows' bits."""
    K = n_dk.shape[-1]
    topic = torch.arange(K, device=n_dk.device)
    fo = torch.where(topic == z_old[..., None], f[..., None], 0.0)
    n_m = n_dk - fo
    w = ((labs * (n_m + alpha)) * (cv + beta)) * recip
    c = _chunk_cumsum(w)
    r = u * c[..., K - 1]
    z_new = (c < r[..., None]).sum(dim=-1, dtype=torch.int32).clamp_(max=K - 1)
    z_new = torch.where(f > 0, z_new, z_old)
    fn = torch.where(topic == z_new[..., None], f[..., None], 0.0)
    return n_m + fn, z_new


def draw_update_torch(u, f, z_old, labs, n_dk, cv, recip, alpha: float,
                      beta: float) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of :func:`draw_update`, all rows at once.

    Same operations in the same order as ``csrc/draw_update.cu`` (see its
    header): ``((labs·(n_dk−own+α))·(cv+β))·recip`` and the chunked cumsum
    of :func:`_chunk_cumsum`, no matmul.  ``n_dk`` is updated in place.
    """
    n_new, z_new = _draw_torch(u, f, z_old, labs, n_dk, cv, recip, alpha, beta)
    n_dk.copy_(n_new)
    dnk = torch.zeros((n_dk.shape[1],), dtype=torch.float32, device=n_dk.device)
    dnk.index_add_(0, z_old.long(), -f)
    dnk.index_add_(0, z_new.long(), f)
    return n_dk, z_new, dnk


def draw_rows_torch(u, f, z, labs, n_dk, table, rows, n_k, live, alpha: float,
                    beta: float, vbeta: float) -> None:
    """Plain PyTorch version of :func:`draw_rows`: the live rows' table rows
    are gathered, ``recip = 1/(n_k + V·β)``, and :func:`_draw_torch` draws,
    every chain at once where the state has a chain axis."""
    if not live.numel():
        return
    idx = live.long()
    ax = n_dk.dim() - 2  # the rows' axis: 1 behind a chain axis
    recip = (1.0 / (n_k + vbeta)).unsqueeze(-2)
    cv = table.index_select(ax, rows)
    n_new, z_new = _draw_torch(u.index_select(ax, idx), f[idx], z.index_select(ax, idx),
                               labs[idx], n_dk.index_select(ax, idx), cv, recip, alpha, beta)
    n_dk.index_copy_(ax, idx, n_new)
    z.index_copy_(ax, idx, z_new)


def commit_counts_torch(table, n_k, dec: Optional[Slots], inc: Optional[Slots]) -> None:
    """Plain PyTorch version of :func:`commit_counts`: ``index_add_`` on the
    flat table and on the flat ``n_k``, chain c's elements offset by c·V·K
    and c·K where there is a chain axis."""
    V, K = table.shape[-2:]
    chain = torch.arange(table.numel() // (V * K), device=table.device)[:, None]
    for s, sign in ((dec, -1.0), (inc, 1.0)):
        if s is None or not s.live.numel():
            continue
        idx = s.live.long()
        z = s.z.index_select(-1, idx).long()
        if z.dim() == 1:
            z = z[None]
        f = (sign * s.f.index_select(0, idx)).expand(z.shape).reshape(-1)
        words = s.rows.index_select(0, idx)
        table.view(-1).index_add_(0, (chain * (V * K) + words * K + z).reshape(-1), f)
        n_k.view(-1).index_add_(0, (chain * K + z).reshape(-1), f)
