"""Probes of kernel 1's warp and wide routes on one CUDA card.

    python3 tools/probe_wide_route.py [--seed N] [--quick] [TREE]
    python3 tools/probe_wide_route.py --general-only [TREE]

1. The build: ptxas's registers and spills of every warp-route instance
   and of the wide route's kernel, and the wide route's widest A on this
   card (``fused_block_cuda.wide_max_slots``).
2. Bits: every ``chip_smoke.edge_cases()`` shape of the wide and general
   routes, launched through ``fused_block``, against the plain version.
3. Times: ``chip_smoke.route_timing`` at each of ``chip_smoke.TIMED_SHAPES``
   (the warp route's three, LocalLDA's K = 300 and K = 1,000 on the wide
   route; each beside the general route on the same inputs, in the order
   route, general, general, route).

``--quick`` skips 2.  ``--general-only`` times the general (CTA) route
alone at K = 300 and K = 1,000, bitwise against the plain version first.
Every probe runs the port found in ``TREE`` (default: this checkout) with
this checkout's ``chip_smoke`` helpers, so that two commits are compared on
one card by running the probe on each in turns.  Prints one JSON line per
probe; about a minute on an H100.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402

import chip_smoke  # noqa: E402

A_B = (0.1, 0.01)  # alpha, beta
SHAPES = {"k300": chip_smoke.K300_SHAPE, "k1000": chip_smoke.K1000_SHAPE}


def build_probe() -> dict:
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    lib, secs, log = fbc.build()
    return dict(seconds=secs, ptxas=chip_smoke.route_ptxas(log) if log else None,
                wide_max_slots=fbc.wide_max_slots())


def bits_probe(seed: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    out = {}
    for i, (name, shape) in enumerate(chip_smoke.edge_cases().items()):
        D, U, A = shape[:3]
        route = fbc.route(U, A)
        if route not in ("wide", "general"):
            continue
        args = chip_smoke.block_case("cuda", seed + i, *shape)
        before = chip_smoke._route_counts(fbc)
        got = fbc.fused_block(*args, *A_B)
        ran = chip_smoke._launched_on(fbc, before)
        want = fbc.fused_block_torch(*args, *A_B)
        torch.cuda.synchronize()
        chip_smoke._check(ran == route and chip_smoke._bitwise(got, want),
                          f"{name}: the {ran} route == plain version")
        out[name] = route
        print(json.dumps({"bitwise": name, "route": route}), flush=True)
    return out


def general_probe(seed: int) -> dict:
    """The general route at both shapes: ms a launch (CUDA events around 10
    launches, two runs), ``bound`` and the plain version's ms."""
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    out = {}
    for key, (D, U, A, M) in SHAPES.items():
        args = chip_smoke.block_case("cuda", seed + A, D, U, A, M, gaps=0.0)
        t0 = time.perf_counter()
        want = fbc.fused_block_torch(*args, *A_B)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        got = fbc._launch("general", *args, *A_B)
        torch.cuda.synchronize()
        chip_smoke._check(chip_smoke._bitwise(got, want), f"{key}: general == plain version")
        runs = [chip_smoke._batch_ms(lambda: fbc._launch("general", *args, *A_B), 10)
                for _ in range(2)]
        by_bytes, by_ops = chip_smoke.bound(args)
        out[key] = dict(shape=[D, U, A, M], general_runs_ms=runs,
                        general_ms=float(np.mean(runs)), bound_ms=1e3 * max(by_bytes, by_ops),
                        plain_ms=plain_ms)
        print(json.dumps({key: out[key]}), flush=True)
        del args, got, want
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--quick", action="store_true")
    p.add_argument("--general-only", action="store_true")
    p.add_argument("tree", nargs="?", default=None)
    args = p.parse_args(argv)
    if args.tree:  # the port of another checkout; chip_smoke's helpers from this one
        sys.path.insert(0, str(Path(args.tree).resolve()))
    import torch

    if not torch.cuda.is_available():
        print("probe_wide_route: no CUDA device", file=sys.stderr)
        return 1
    print(chip_smoke._card_line(), flush=True)
    import lda_thesis_tpu_torch

    print(json.dumps({"package": lda_thesis_tpu_torch.__file__}), flush=True)
    if args.general_only:
        print(json.dumps({"general": general_probe(args.seed)}), flush=True)
        return 0
    print(json.dumps({"build": build_probe()}), flush=True)
    if not args.quick:
        t0 = time.perf_counter()
        bits_probe(args.seed)
        print(json.dumps({"bits_seconds": time.perf_counter() - t0}), flush=True)
    print(json.dumps({"timing": chip_smoke.route_timing(args.seed, *A_B)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
