"""Elastic training supervisor: checkpoint-every-N + automatic resume.

Counterpart of ``lda_thesis_tpu/utils/elastic.py``, the same logic.  Training
runs in chunks, every chunk is checkpointed atomically (utils/checkpoint.py),
and any failure (a killed process on rerun, an out-of-memory error, or an
injected fault in tests) resumes from the last durable chunk instead of
losing the run.  Resumed training is bit-identical to the uninterrupted run
(tests/test_torch_checkpoint.py) because the generator's state and the
thinned-average state are part of the checkpoint.

The CLIs' ``--checkpoint PATH --save-every N --resume [--max-restarts R]``
route through :class:`ElasticGibbs` / :func:`elastic_train`; library users
call them directly.
"""

from __future__ import annotations

import inspect
import os
from typing import Callable, Optional

from .checkpoint import restore_model, save_model

__all__ = ["elastic_train", "ElasticGibbs"]


class ElasticGibbs:
    """Bookkeeping for chunked, resumable Gibbs training of one model.

    :meth:`run` forwards ``total_iters`` / ``continue_avg`` / extra keywords
    only when the model's ``run_training`` accepts them.
    """

    def __init__(self, model, checkpoint: Optional[str], resume: bool = True,
                 verbose: bool = False):
        self.model = model
        self.checkpoint = checkpoint
        self.verbose = verbose
        self.iters = 0
        if resume and checkpoint and os.path.exists(checkpoint + ".json"):
            meta = restore_model(checkpoint, model)
            self.iters = int(meta.get("iters_done", 0))
            if verbose:
                print(f"resumed from {checkpoint} at iteration {self.iters}")

    def run(self, total_iters: int, thinning: int, save_every: int = 0,
            progress=None, **train_kw) -> None:
        """Run ``total_iters - iters_done`` more iterations, checkpointing
        every ``save_every`` (0 = only at the end, if a path is set).

        ``progress`` — a :class:`..utils.tracing.Progress` (or ``True`` to
        build one from the model's ``n_tokens``): tokens/s + ETA reported
        at chunk boundaries, no per-iteration host syncs.  A resumed run's
        display starts at the checkpointed iteration, and its rate counts
        only this session's iterations.
        """
        if progress is True:
            from .tracing import Progress

            progress = Progress(
                total_iters=total_iters,
                tokens_per_iter=int(getattr(self.model, "n_tokens", 0)),
                done=self.iters,
            )
        params = inspect.signature(self.model.run_training).parameters
        kw = {k: v for k, v in train_kw.items() if k in params}
        if "total_iters" in params:
            # fused merge-block selection depends on the FULL planned
            # budget: chunked resume is only bit-identical when every
            # chunk computes the same M (models/labeled_lda.check_merge_block)
            kw["total_iters"] = int(total_iters)
        chunk = save_every if save_every > 0 else max(total_iters - self.iters, 1)
        while self.iters < total_iters:
            step = min(chunk, total_iters - self.iters)
            if "continue_avg" in params:
                kw["continue_avg"] = self.iters > 0
            self.model.run_training(step, thinning, **kw)
            self.iters += step
            if progress is not None:
                progress.update(step)
            if self.checkpoint:
                save_model(self.checkpoint, self.model,
                           extra_meta={"iters_done": self.iters})
                if self.verbose:
                    print(f"checkpointed at iteration "
                          f"{self.iters}/{total_iters}")


def elastic_train(
    make_model: Callable[[], object],
    total_iters: int,
    thinning: int,
    checkpoint: str,
    save_every: int,
    max_restarts: int = 3,
    on_failure: Optional[Callable[[BaseException, int], None]] = None,
    verbose: bool = False,
    resume_first: bool = True,
    **train_kw,
):
    """Train to ``total_iters`` with automatic restart-from-checkpoint.

    ``make_model`` builds a *fresh* model (same seed/config); each attempt
    restores whatever progress the last attempt durably checkpointed.  Up to
    ``max_restarts`` failures are absorbed; the final exception propagates.
    Returns the trained model.

    ``resume_first`` — whether the FIRST attempt may resume from an
    already-existing checkpoint at ``checkpoint``.  The CLIs pass their
    ``--resume`` flag here so a stale checkpoint from an earlier finished
    run is not silently adopted as "already trained"; restart attempts
    after a fault always resume (that is the point of the supervisor).
    """
    if not resume_first and checkpoint:
        # a fresh (no --resume) run OVERWRITES the checkpoint path; clear
        # any stale files now so a fault before the first save cannot make
        # a restart attempt silently adopt a previous run's chain
        for ext in (".npz", ".json"):
            try:
                os.unlink(checkpoint + ext)
            except FileNotFoundError:
                pass
    attempt = 0
    while True:
        eg = ElasticGibbs(make_model(), checkpoint, resume=True,
                          verbose=verbose)
        try:
            eg.run(total_iters, thinning, save_every, **train_kw)
            return eg.model
        except Exception as e:  # noqa: BLE001 — supervisor absorbs any fault
            attempt += 1
            if on_failure is not None:
                on_failure(e, attempt)
            if attempt > max_restarts:
                raise
            if verbose:
                print(f"training attempt {attempt} failed ({e!r}); "
                      f"restarting from last checkpoint")
