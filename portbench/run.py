"""Run one cell of the port's benchmark and print its result as one JSON line.

    python3 -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The cell (``BENCHMARK.json``) names a
configuration and a traffic mix; the configuration names its model kind,
whose adapter (``portbench/models/<kind>.py``) builds the corpus and the
model from the seed, warms up every shape the mix uses, runs one call of
the mix and checks a run's outputs against the plain reference.

Set-up is everything before the window: imports, the corpus, the model,
the kernels' build or load, the warm-up calls.  The window is a closed loop
with one caller: calls back to back for ``--seconds`` seconds (the last
call ends past it), each ending in a device synchronize, on the host
clock.  With ``--trace 1`` the window is followed by a traced block of
whole calls under ``torch.profiler`` (``traffic.trace_seconds`` long),
from which the per-layer metrics are read.  Once the window has closed,
the device's peak memory is read, the program's state is freed and the
reference judges ``correct``.  The numbers compared and their limits are
printed as the last lines of standard error and as the result's last key.

The run needs as many CUDA devices as the cell asks for, and never falls
back to the CPU; it fails without them, and fails where the process has
loaded JAX or the JAX package.
"""

from __future__ import annotations

import time

START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
# build and kernel caches at fixed paths inside the checkout; the program's
# own kernels build into lda_thesis_tpu_torch/_build/
CACHE = CHECKOUT / ".portbench_cache"
for _var, _sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"), ("TRITON_CACHE_DIR", "triton"),
                   ("CUDA_CACHE_PATH", "nv")):
    os.environ[_var] = str(CACHE / _sub)

FORBIDDEN = ("jax", "jaxlib", "flax", "lda_thesis_tpu")


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def power_limit_w() -> float:
    out = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                          "--format=csv,noheader,nounits", "--id=0"],
                         capture_output=True, text=True, timeout=60, check=True)
    return float(out.stdout.strip().splitlines()[0])


def _p95(values) -> float:
    return statistics.quantiles(values, n=20)[-1] if len(values) > 1 else values[0]


E2E = {  # how the window's calls give each kind of end-to-end metric
    "rate": lambda walls, units, window: units / window,
    "p95_ms": lambda walls, units, window: 1e3 * _p95(walls),
}


def _wrap_spans(targets: dict):
    """Wrap each named program callable in a ``portbench/<name>`` profiler
    scope; returns a function that undoes it."""
    import importlib

    from torch.profiler import record_function

    undo = []
    for name, target in targets.items():
        mod_name, attr = target.split(":")
        owner = importlib.import_module(mod_name)
        *path, leaf = attr.split(".")
        for part in path:
            owner = getattr(owner, part)
        orig = owner.__dict__[leaf] if isinstance(owner, type) else getattr(owner, leaf)

        def wrapped(*a, _orig=orig, _label=f"portbench/{name}", **k):
            with record_function(_label):
                return _orig(*a, **k)

        setattr(owner, leaf, wrapped)
        undo.append((owner, leaf, orig))
    return lambda: [setattr(o, n, f) for o, n, f in undo]


def traced_block(job, traffic: dict, sync, spans: dict):
    """Whole calls under the profiler for ``traffic["trace_seconds"]``, with
    the program callables of ``spans`` wrapped in profiler scopes; returns
    the profiler's events."""
    from torch.profiler import ProfilerActivity, profile, record_function

    unwrap = _wrap_spans(spans)
    try:
        sync()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            while True:
                with record_function("portbench/call"):
                    job.call()
                if time.perf_counter() - t0 >= float(traffic["trace_seconds"]):
                    break
        return prof.profiler.kineto_results.events()
    finally:
        unwrap()


def run_cell(name: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
             bench: dict = None, base: Path = HERE) -> dict:
    """One run of cell ``name``; returns the result (the line's object).
    ``device="cpu"`` skips the look for a card (the tests' rehearsal)."""
    import torch

    from . import spec

    if device == "cuda":
        torch.cuda.init()
    bench = spec.benchmark() if bench is None else bench
    cell = spec.workload(bench, name)
    config = spec.config(cell["config"], base)
    traffic = spec.traffic(cell["traffic"], base)
    cuda = device == "cuda"
    sync = torch.cuda.synchronize if cuda else (lambda: None)

    started = time.perf_counter() - START  # imports and the device's context
    job = spec.model(config["model"]).build(config, traffic, int(seed), device)
    sync()
    setup_s = time.perf_counter() - START

    walls, units = [], 0.0
    t0 = time.perf_counter()
    while True:
        t = time.perf_counter()
        units += job.call()
        now = time.perf_counter()
        walls.append(now - t)
        if now - t0 >= seconds:
            break
    window = now - t0

    result_metrics, breakdown, dev = {}, None, {}
    if trace:
        from .trace import Trace

        readers = {m["name"]: (m, spec.metric_reader(m["name"], base))
                   for m in spec.cell_metrics(bench, cell, "per_layer")}
        events = traced_block(job, traffic, sync,
                              spec.spans(r for _, r in readers.values()))
        tr = Trace(events, job.work(), len(walls), window)
        for m, reader in readers.values():
            value = reader.read(tr)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        breakdown = tr.breakdown()
        dev.update(busy_s=tr.busy_s, window_s=tr.window_s)
    else:
        for m in spec.cell_metrics(bench, cell, "end_to_end"):
            if m["name"] == "setup_s":
                value = setup_s
            else:
                value = E2E[traffic["metrics"][m["name"]]](walls, units, window)
            result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    peak = torch.cuda.max_memory_allocated() if cuda else 0
    job.after_window()
    job.free()
    if cuda:
        torch.cuda.empty_cache()
    limits = spec.limits(name, base)
    t_ref = time.perf_counter()
    checks = {k: (float(v), float(limits[k])) for k, v in job.check().items()}
    phases = ", ".join(f"{k} {v:.3f}" for k, v in {"start": started, **job.phases}.items())
    ms = sorted(1e3 * w for w in walls)
    print(f"portbench: set-up {setup_s:.3f} s ({phases}), window {window:.3f} s over "
          f"{len(walls)} calls (min {ms[0]:.3f}, median {statistics.median(ms):.3f}, max "
          f"{ms[-1]:.3f} ms), reference {time.perf_counter() - t_ref:.3f} s", file=sys.stderr)
    correct = all(v <= lim for v, lim in checks.values())

    out = {"correct": correct, "attempted": len(walls), "failed": 0,
           "metrics": result_metrics,
           "device": {"platform": "gpu" if cuda else "cpu",
                      "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
                      "count": 1, "memory_peak_bytes": int(peak), **dev}}
    if cuda:
        out["device"]["power_limit_w"] = power_limit_w()
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = {k: {"value": v, "limit": lim} for k, (v, lim) in checks.items()}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from . import spec

    bench = spec.benchmark()
    chips = int(spec.workload(bench, args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), bench=bench)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}", file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
