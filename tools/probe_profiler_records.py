"""Probe which device records torch.profiler keeps of one HSLDA z-sweep.

    python3 tools/probe_profiler_records.py [--fresh]

Runs all of ``chip_smoke.py`` first in this process (unless ``--fresh``),
since profiler sessions late in that process keep fewer records than early
ones.  Then makes the full-width opt-1 HSLDA model of phase 12 (three
cycles, seed 0), captures its sweep as a graph and counts the graph's nodes
with CUDA's ``cuGraphGetNodes``, and profiles the eager sweep and one
replay, three sessions each, with no spin kernels ahead of the sweep and with
``chip_smoke.PAD_LAUNCHES`` of them.  For each session it prints the spin
records and sweep records kept, and whether the sweep's lost records are
its first ones.  Prints the card's name and power limit first and one JSON
line last.
"""

from __future__ import annotations

import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from lda_thesis_tpu_torch.data.synthetic import jel_corpus  # noqa: E402
from lda_thesis_tpu_torch.models.hslda import HSLDA  # noqa: E402
from lda_thesis_tpu_torch.ops.hslda_gibbs import HSLDASweep  # noqa: E402

SESSIONS = 3


def session(fn, pad: int) -> tuple:
    """(spin records, sweep record names in start order) of one session."""
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.002)
        for _ in range(pad):
            torch.cuda._sleep(0)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.002)
    events = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    spins = sum("spin_kernel" in e.name for e in events)
    return spins, [e.name for e in events if "spin_kernel" not in e.name]


def main() -> int:
    print(chip_smoke._card_line(), flush=True)
    if "--fresh" not in sys.argv[1:]:
        chip_smoke.main([])
    jel = jel_corpus(0, n_l3=chip_smoke.HSLDA_N_L3)
    model = HSLDA(jel.train_docs, jel.train_labs, jel.labelset, k=chip_smoke.HSLDA_K, seed=0,
                  device="cuda")
    for _ in range(3):
        model.train_cycle(1)
    c = model.counts
    run = HSLDASweep(c.z.T.contiguous(), c.n_dk.clone(), c.n_vk.clone(), c.n_k.clone(),
                     model.tok_v, model.mask, model.labs, model.gamma, model.xi, 1, model.V)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(7)
    ab = model.alpha * model.beta
    run(model.eta, model.a, ab, generator=gen)
    twin = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        twin.capture_begin()
        run._sweep()
        twin.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    nodes = chip_smoke._graph_nodes(twin)
    del twin
    run(model.eta, model.a, ab, generator=gen)  # captures, then replays

    out = {"graph_nodes": nodes, "sessions": []}
    ref = None
    for pad in (chip_smoke.PAD_LAUNCHES, 0):
        for name, fn in (("eager", run._sweep), ("replay", run._graph.replay)):
            for _ in range(SESSIONS):
                spins, names = session(fn, pad)
                if ref is None and spins and len(names) == nodes:
                    ref = names
                leading = ref is not None and names == ref[len(ref) - len(names):]
                rec = dict(call=name, pad=pad, spins_kept=spins, kept=len(names),
                           lost=nodes - len(names), lost_are_first=leading)
                out["sessions"].append(rec)
                print(f"{name} pad {pad}: spin records {spins}, sweep records {len(names)} of "
                      f"{nodes} nodes; lost records are the first: {leading}", flush=True)
    print(json.dumps({"profiler_records": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
