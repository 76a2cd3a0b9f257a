"""A copy of the benchmark's files at a size a CPU test run can hold.

Every configuration's corpus and every traffic mix's call are cut down;
all else (the cells, the metrics, the limits, the harness) is the
benchmark's own.  Runs go through ``portbench.run.run_cell`` with
``device="cpu"``: the program runs its plain PyTorch paths.
"""

from __future__ import annotations

import json
import shutil
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent
PORTBENCH = HERE.parent
CHECKOUT = PORTBENCH.parent
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

CORPUS = {
    "llda_d3": dict(n_train=80, n_test=16, V=400, n_labels=30, max_labels=5, max_types=40,
                    mean_types=12),
    "hslda_jel": dict(n_train=150, n_test=16, V=500, n_l2=30, n_l3=60, max_types=30,
                      mean_types=10),
}
FIT = {"llda_d3": {"iters": 20, "thinning": 5, "total_iters": 40},
       "hslda_jel": {"iters": 4, "thinning": 2}}
CALLS = {
    "train_50x25": dict(iters=10, thinning=5, total_iters=80),
    "train_5x5": dict(iters=2, thinning=2),
    "predict_200x25": dict(it=10, thinning=5),
    "predict_250x25": dict(it=10, thinning=5),
}


def bench() -> dict:
    return json.loads((CHECKOUT / "BENCHMARK.json").read_text())


def _edit(path: Path, update) -> None:
    data = json.loads(path.read_text())
    update(data)
    path.write_text(json.dumps(data))


def copy(tmp: Path) -> Path:
    """A cut-down copy of ``portbench/`` under ``tmp``; returns its path."""
    base = Path(tmp) / "portbench"
    shutil.copytree(PORTBENCH, base, ignore=shutil.ignore_patterns("__pycache__", "tests"))
    for name, args in CORPUS.items():
        def update(cfg, args=args, name=name):
            cfg["corpus"]["args"].update(args)
            cfg["fit"] = FIT[name]
        _edit(base / "configs" / f"{name}.json", update)
    for name, args in CALLS.items():
        _edit(base / "traffic" / f"{name}.json", lambda t, args=args: t.update(args))
    return base


def run(base: Path, cell: str, seed: int = 2**31 + 11, trace: bool = False,
        seconds: float = 0.3, bench_spec: dict = None) -> dict:
    from portbench import run as harness

    return harness.run_cell(cell, seed, seconds, trace, device="cpu",
                            bench=bench() if bench_spec is None else bench_spec, base=base)
