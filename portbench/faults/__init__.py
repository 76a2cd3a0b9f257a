"""Faults planted underneath a cell's timed path, for the fault tests and
for readings of a cell's check at its own size on the card.

    python3 -m portbench.faults --workload <cell> --fault <kind> --seeds <n> [<n> ...]

Each fault patches the program in this process: ``unchanged`` (a step that
returns its state unchanged), ``half`` (half of the documents left out)
and ``altered`` (one draw or one answer altered where it is made).  The
faults of a model kind's calls are ``FAULTS[<call>]`` of
``faults/<kind>.py``, found by the cell's configuration and traffic, so a
new cell of a known kind and call has its faults with no edit here.  For
each seed, the cell's set-up, the calls its check needs and the check,
with the fault in place; prints the numbers.  The benchmark's own runs
never plant one.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

KINDS = ("unchanged", "half", "altered")


def makers(cell: str, bench: dict = None, base=None) -> tuple:
    """The fault makers of ``cell``'s model kind (its configuration's
    ``"model"``), by call; and the cell's call (its traffic's ``"call"``)."""
    import importlib

    from portbench import spec

    base = spec.HERE if base is None else base
    w = spec.workload(spec.benchmark() if bench is None else bench, cell)
    kind = spec.config(w["config"], base)["model"]
    call = spec.traffic(w["traffic"], base)["call"]
    return importlib.import_module(f"portbench.faults.{kind}").FAULTS, call


def plant(cell: str, kind: str, bench: dict = None, base=None, call: str = None):
    """Patch the program with fault ``kind`` of ``cell``'s timed path (or of
    its model kind's ``call``); returns a function that undoes it."""
    import importlib

    faults, own = makers(cell, bench, base)
    target, fn = faults[call or own](kind)
    mod_name, attr = target.rsplit(".", 1)
    try:
        owner = importlib.import_module(mod_name)
    except ModuleNotFoundError:  # a class attribute: module.Class.attr
        mod_name, cls = mod_name.rsplit(".", 1)
        owner = getattr(importlib.import_module(mod_name), cls)
    orig = owner.__dict__[attr] if isinstance(owner, type) else getattr(owner, attr)
    setattr(owner, attr, fn)
    return lambda: setattr(owner, attr, orig)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--fault", choices=KINDS, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    from portbench import control

    if not torch.cuda.is_available():
        print("portbench.faults: no CUDA device", file=sys.stderr)
        return 2
    undo = plant(args.workload, args.fault)
    try:
        for seed in args.seeds:
            got = control.readings(args.workload, seed, False)
            print(json.dumps({"fault": args.fault, **got}), flush=True)
    finally:
        undo()
    return 0
