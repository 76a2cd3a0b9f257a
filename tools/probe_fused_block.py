"""Probes of the merge-block kernel's cv staging and of torch.profiler's
kernel records, on one CUDA card.

    python3 tools/probe_fused_block.py [--seed N] [--sessions N] [--out FILE]

1. cv staging: the bulk copy (a 16-byte aligned slab) against the
   cooperative copy (the same cv one float off that alignment), on the main
   path's bucket shapes, a two-wave shape and the blocks of
   ``CascadeLDA(sweep="fused")`` at the thesis config; times from CUDA
   events around 10 back-to-back calls, in the order bulk coop coop bulk,
   and the two copies' outputs bitwise equal.
2. Profiler records: after phases 3 and 4 of chip_smoke.py, ``--sessions``
   torch.profiler sessions of 20 draw-update launches each, in turns with
   CUDA activity alone, with CPU and CUDA activity, and with CUDA activity
   and 2 ms of host wait at each end of the window; per variant, the launch
   records each session kept.

Prints one JSON line per probe.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke  # noqa: E402


def staging_probe(cases: dict) -> list:
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    a, b = 0.1, 0.01
    out = []
    for name, args in cases.items():
        cv = args[0]
        flat = torch.empty(cv.numel() + 1, dtype=cv.dtype, device=cv.device)
        off = flat[1:].view(cv.shape)  # contiguous, 4 bytes past a 16-byte boundary
        off.copy_(cv)
        coop = (off,) + tuple(args[1:])
        chip_smoke._check(off.data_ptr() % 16 == 4, "the copy is off 16-byte alignment")
        chip_smoke._check(chip_smoke._bitwise(fbc.fused_block(*coop, a, b),
                                              fbc.fused_block(*args, a, b)),
                          f"{name}: coop == bulk")
        times = dict(bulk=[], coop=[])
        for kind in ("bulk", "coop", "coop", "bulk"):
            x = args if kind == "bulk" else coop
            times[kind].append(chip_smoke._batch_ms(lambda: fbc.fused_block(*x, a, b), 10))
        D, U, A = cv.shape
        row = dict(case=name, D=D, U=U, A=A, M=int(args[2].shape[0]), ms=times)
        print(json.dumps(row))
        out.append(row)
    return out


def cascade_blocks(jel, jel_dicti, seed: int, device="cuda") -> dict:
    """The first merge block of each shape that ``CascadeLDA(sweep="fused")``
    runs in ``go_down_tree(4, 2)``, captured at its call."""
    from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA
    from lda_thesis_tpu_torch.ops import gibbs_fused

    seen = {}
    real = gibbs_fused.fused_block

    def spy(*args):
        D, U, A = args[0].shape
        key = f"cascade D={D} U={U} A={A} M={args[2].shape[0]}"
        seen.setdefault(key, tuple(t.clone() for t in args[:7]))
        return real(*args)

    gibbs_fused.fused_block = spy
    try:
        model = CascadeLDA(jel.train_docs, jel.train_labs, jel.labelset, jel_dicti,
                           alpha=0.001, beta=0.001, seed=seed, sweep="fused",
                           device=device)
        model.go_down_tree(it=chip_smoke.CASCADE_IT, s=chip_smoke.CASCADE_S)
    finally:
        gibbs_fused.fused_block = real
    return seen


def _records(fn, reps: int, kernel: str, variant: str) -> int:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CUDA]
    if variant == "cpu+cuda":
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    fn()
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        if variant == "cuda+wait":
            time.sleep(0.002)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        if variant == "cuda+wait":
            time.sleep(0.002)
    return sum(e.count for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and kernel in e.key)


def profiler_probe(corpus, dicti, seed: int, sessions: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    # chip_smoke's phases 3 and 4, as they run before its phase 5
    probe = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, dicti,
                       alpha=0.1, beta=0.01, seed=seed, device="cuda")
    chip_smoke.kernel_phase(probe, seed)
    del probe
    run = chip_smoke.main_path(corpus, dicti, seed)
    for p in (True, False):
        chip_smoke.steady_training(run["model"], p)
    del run

    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, dicti,
                       alpha=0.1, beta=0.01, seed=seed, sweep="dense", device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed + 2)
    st = model.counts
    g = 1
    args = chip_smoke.draw_inputs(model._toks_v_t[g], model._toks_f_t[g],
                                  st.z[g].T.contiguous(), st.n_dk[g], st.n_vk, st.n_k,
                                  model.labs_t[g], 0, float(model.V * model.beta), gen)
    a, b = model.alpha, model.beta
    counts = {v: [] for v in ("cuda", "cpu+cuda", "cuda+wait")}
    for _ in range(sessions):
        for v in counts:
            counts[v].append(_records(lambda: duc.draw_update(*args, a, b), 20,
                                      chip_smoke.KERNEL2, v))
    row = dict(reps=20, sessions=sessions, counts=counts,
               short={v: sum(c < 20 for c in cs) for v, cs in counts.items()})
    print(json.dumps(row))
    return row


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--sessions", type=int, default=30)
    parser.add_argument("--out", help="also write the probes' results to this JSON file")
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("probe_fused_block: no CUDA device", file=sys.stderr)
        return 1
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus, planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    print(chip_smoke._card_line())
    for mod in (fbc, duc):
        mod.build()
    shapes = {
        "bucket0": (1653, 32, 24, 25), "bucket3": (415, 128, 24, 25),
        "two waves U=32 A=24": (2 * 32 * 132, 32, 24, 25),
    }
    cases = {k: chip_smoke.block_case("cuda", i, *s, gaps=0.0)
             for i, (k, s) in enumerate(shapes.items())}
    jel = jel_corpus(args.seed)
    jel_dicti = prune_dict(jel.train_docs, lower=0, upper=1)
    cases.update(cascade_blocks(jel, jel_dicti, args.seed))
    s = staging_probe(cases)
    corpus = planted_corpus(args.seed)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    p = profiler_probe(corpus, dicti, args.seed, args.sessions)
    if args.out:
        Path(args.out).write_text(json.dumps(dict(
            card=chip_smoke._card_line(), staging=s, profiler=p), indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
