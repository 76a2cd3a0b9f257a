"""Profiling / tracing / progress observability.

Counterpart of ``lda_thesis_tpu/utils/tracing.py``:

* :func:`trace` — context manager around ``torch.profiler.profile`` (CPU
  activity, and CUDA where a card is visible) writing a TensorBoard-loadable
  Chrome trace (``*.pt.trace.json``: host ops, kernel launches and device
  kernels) into a directory;
* :func:`annotate` — the program's spans: a named ``record_function``
  scope ``lda/<name>`` while a profiler runs, nothing otherwise;
* :func:`count` / :func:`counts` — the program's counters, always on;
* :class:`Progress` — rate/ETA progress reporting for long Gibbs runs
  (tokens/s, sweeps/s) without per-iteration host syncs.
"""

from __future__ import annotations

import contextlib
import time
from typing import ContextManager, Dict, Iterator

import torch
from torch._C._autograd import _profiler_enabled
from torch.profiler import ProfilerActivity, profile, record_function, tensorboard_trace_handler

__all__ = ["trace", "annotate", "count", "counts", "PREFIX", "Progress"]

PREFIX = "lda/"  # the profiler name of every span of the program
_NULL = contextlib.nullcontext()
_COUNTS: Dict[str, int] = {}


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Capture a profile of the enclosed block into ``log_dir``.

    View with ``tensorboard --logdir <log_dir>`` (profile plugin) or load the
    JSON file in a Chrome trace viewer.
    """
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities, on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield


def annotate(name: str) -> ContextManager[None]:
    """The span ``name``: a host-side scope named ``lda/<name>`` on the
    profiler's timeline while a profiler runs (:func:`trace`, or any
    ``torch.profiler.profile``), so that each device record and idle gap
    falls inside the program phase that issued it.  Spans nest by
    containment on one thread.  With no profiler running it is one shared
    null context: the cost is a flag test, where a bare ``record_function``
    costs some microseconds even then.

    The spans: ``<layer>`` around a call of each measured replay runner
    (``merge_block``, ``save_step``, ``hslda_cycle``, ``foldin_sweep``),
    ``<layer>.eager`` / ``.capture`` / ``.replay`` around the phase a
    runner's call takes (``ops/gibbs._Replayed``), a prediction
    request's steps ``predict.prepare``, ``foldin.init``,
    ``foldin.sweeps``, ``predict.scores`` and ``predict.rank``, and
    LocalLDA's landing of a training call's means on the host,
    ``local_lda.land``."""
    if not _profiler_enabled():
        return _NULL
    return record_function(PREFIX + name)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the process's counter ``name``: one per phase of each
    replay runner's call, ``<layer>.eager`` / ``.capture`` / ``.replay``
    (a capturing call counts a capture and a replay); and a merge block's
    topic-word table entries read, ``merge_block.table_entries``, and
    those of live positions on valid slots,
    ``merge_block.live_table_entries``."""
    _COUNTS[name] = _COUNTS.get(name, 0) + n


def counts() -> Dict[str, int]:
    """A copy of the process's counters; the counts of a stretch of work
    are the difference of two copies."""
    return dict(_COUNTS)


class Progress:
    """Throughput/ETA reporter for iterative training.

    ``done`` is the iteration count the run starts from (a resumed run's
    checkpointed iterations): the ``[done/total]`` display counts the whole
    run, while the rate and the ETA count only this session's iterations.

    >>> prog = Progress(total_iters=2000, tokens_per_iter=250_000)
    >>> for i in range(2000):
    ...     step()
    ...     prog.update()   # prints at most every `interval` seconds
    """

    def __init__(
        self,
        total_iters: int,
        tokens_per_iter: int = 0,
        interval: float = 5.0,
        printer=print,
        done: int = 0,
    ):
        self.total = int(total_iters)
        self.tokens_per_iter = int(tokens_per_iter)
        self.interval = float(interval)
        self.printer = printer
        self.done = self.done_at_start = int(done)
        self.t0 = time.perf_counter()
        self._last = self.t0

    def update(self, n: int = 1) -> None:
        self.done += n
        now = time.perf_counter()
        if now - self._last < self.interval and self.done < self.total:
            return
        self._last = now
        dt = now - self.t0
        rate = (self.done - self.done_at_start) / max(dt, 1e-9)
        eta = (self.total - self.done) / max(rate, 1e-9)
        msg = (
            f"[{self.done}/{self.total}] {rate:.2f} it/s, "
            f"eta {eta:.0f}s"
        )
        if self.tokens_per_iter:
            msg += f", {rate * self.tokens_per_iter / 1e6:.2f}M tokens/s"
        self.printer(msg)
