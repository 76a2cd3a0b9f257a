"""Run a function on several ranks, each in a fresh process.

``spawn(target, world_size, payload)`` starts ``world_size`` interpreters
(``python -m lda_thesis_tpu_torch.parallel.launch``), each of which brings
up the process group over ``tcp://localhost:<free port>`` with the given
backend, calls ``target(payload)`` (``target`` is ``"module:function"``)
and hands its return value back through a file.  Every worker sets
``torch.set_num_threads(1)``; the whole run has a timeout, past which every
worker is killed and ``spawn`` raises, so a hung rank fails instead of
hanging its caller.  Each result also lists the modules of ``jax`` or of
the JAX package that the worker had loaded, which must be none.

    python -m torch.distributed.run --nproc-per-node N ...

is the way to run a CLI on several ranks; ``spawn`` serves the library's
own multi-rank runs (``entry.dryrun_multichip``, the jobs of
:mod:`.jobs`).
"""

from __future__ import annotations

import argparse
import importlib
import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Any, List, Optional

__all__ = ["spawn", "free_port", "foreign_modules"]

ROOT = Path(__file__).resolve().parents[2]
FORBIDDEN = ("jax", "jaxlib", "lda_thesis_tpu")


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def foreign_modules() -> List[str]:
    """The loaded modules of ``jax`` or of the JAX package."""
    return sorted(m for m in sys.modules
                  if any(m == f or m.startswith(f + ".") for f in FORBIDDEN))


def spawn(target: str, world_size: int, payload: Any = None, *, backend: str = "gloo",
          device: Optional[str] = None, timeout: float = 300.0) -> List[Any]:
    """Run ``target(payload)`` on ``world_size`` ranks, each computing on
    ``device`` (CUDA unless the caller passes ``"cpu"``); returns each
    rank's result, rank 0 first.  Raises ``RuntimeError`` with the workers'
    output when one fails, outlasts ``timeout`` seconds or loaded a module
    of ``jax`` or of the JAX package."""
    device = "cuda" if device is None else device
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="lda_spawn_") as tmp:
        with open(os.path.join(tmp, "payload.pkl"), "wb") as f:
            pickle.dump(payload, f)
        procs, logs = [], []
        run_env = dict(os.environ)
        run_env["PYTHONPATH"] = os.pathsep.join(
            [str(ROOT)] + [p for p in run_env.get("PYTHONPATH", "").split(os.pathsep) if p])
        for rank in range(world_size):
            log = open(os.path.join(tmp, f"rank{rank}.log"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "lda_thesis_tpu_torch.parallel.launch", tmp,
                 target, str(rank), str(world_size), str(port), backend, device],
                stdout=log, stderr=subprocess.STDOUT, env=run_env, cwd=str(ROOT)))
        deadline = time.monotonic() + timeout
        timed_out = False
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        if timed_out or any(p.returncode != 0 for p in procs):
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
            text = []
            for rank, log in enumerate(logs):
                log.seek(0)
                text.append(f"--- rank {rank} (exit {procs[rank].returncode}) ---\n"
                            + log.read()[-4000:])
            for log in logs:
                log.close()
            why = f"timed out after {timeout:.0f} s" if timed_out else "failed"
            raise RuntimeError(f"spawn {target} x{world_size} {why}\n" + "\n".join(text))
        for log in logs:
            log.close()
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"result{rank}.pkl"), "rb") as f:
                out = pickle.load(f)
            if out["foreign_modules"]:
                raise RuntimeError(f"rank {rank} of {target} loaded "
                                   f"{out['foreign_modules']}")
            results.append(out["result"])
        return results


def _worker(argv=None) -> None:
    p = argparse.ArgumentParser()
    for name in ("dir", "target", "rank", "world_size", "port", "backend", "device"):
        p.add_argument(name)
    a = p.parse_args(argv)
    import torch

    torch.set_num_threads(1)
    from .bootstrap import initialize_distributed, shutdown

    initialize_distributed(init_method=f"tcp://localhost:{a.port}",
                           world_size=int(a.world_size), rank=int(a.rank),
                           backend=a.backend, device=a.device)
    try:
        with open(os.path.join(a.dir, "payload.pkl"), "rb") as f:
            payload = pickle.load(f)
        module, name = a.target.split(":")
        result = getattr(importlib.import_module(module), name)(payload)
        out = {"result": result, "foreign_modules": foreign_modules()}
        with open(os.path.join(a.dir, f"result{a.rank}.pkl"), "wb") as f:
            pickle.dump(out, f)
    finally:
        shutdown()


if __name__ == "__main__":
    _worker()
