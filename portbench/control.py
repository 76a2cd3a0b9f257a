"""Readings of a cell's check on many seeds, for setting its limits.

    python3 -m portbench.control --workload <cell> --seeds <n> [<n> ...]
        [--control-seeds <n> ...]

For each seed, in one process: the cell's set-up, the calls its check
needs (the checked training call, or ``checked_requests`` predictions) and
the check; prints the numbers that sound runs of the program give.  For
each control seed, also the same check with the reference run in bfloat16
in the program's place (the control, which has to come out as not
correct).  Each limit in ``limits/<cell>.json`` lies between the largest
sound reading and the smallest control reading.  The benchmark's own runs
never run this.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(name: str, seed: int, control: bool, device: str = "cuda", bench=None,
             base=None) -> dict:
    """The sound readings of one seed, and the control's where asked."""
    import torch

    from . import spec

    base = spec.HERE if base is None else base
    bench = spec.benchmark() if bench is None else bench
    cell = spec.workload(bench, name)
    config = spec.config(cell["config"], base)
    traffic = spec.traffic(cell["traffic"], base)
    job = spec.model(config["model"]).build(config, traffic, int(seed), device)
    for _ in range(int(traffic.get("checked_requests", 0))):
        job.call()
    job.after_window()
    job.free()
    if device == "cuda":
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    out = {"seed": seed, "sound": job.check()}
    out["reference_s"] = time.perf_counter() - t0
    if control:
        out["control"] = job.check(control=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("portbench.control: no CUDA device", file=sys.stderr)
        return 2
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, seed in args.control_seeds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
