"""Where the host time of a distributed-trainer call goes, on one CUDA card.

    python3 tools/probe_chains_host.py [--seed N] [--chains C] [--calls N]

Builds ``DistributedLabeledLDA`` on ``planted_corpus(seed)`` with C chains
(default 8) in the unbucketed layout and with 4 buckets, warms each with
one (50; 25) call, times N more (default 5) on the host clock, each ending
in a synchronize, then profiles one more call under torch.profiler with
CPU and CUDA activity.  Per layout: the timed calls' walls and median, the
profiled call's wall, the device's busy time, and the ten host operations
with the most self CPU time (count and ms).  Prints one JSON line per
layout.  Exits 1 without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def profile_call(model, calls: int) -> dict:
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def train():
        model.run_training(50, 25, total_iters=2000)
        torch.cuda.synchronize()

    train()
    walls = []
    for _ in range(calls):
        t0 = time.perf_counter()
        train()
        walls.append(1e3 * (time.perf_counter() - t0))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA) / 1e3
    host = sorted((e for e in events if e.device_type == DeviceType.CPU),
                  key=lambda e: -e.self_cpu_time_total)
    return dict(walls_ms=walls, median_wall_ms=sorted(walls)[len(walls) // 2],
                wall_ms=wall_ms, device_busy_ms=busy,
                host_top=[[e.key[:60], e.count, e.self_cpu_time_total / 1e3]
                          for e in host[:10]])


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--chains", type=int, default=8)
    p.add_argument("--calls", type=int, default=5)
    args = p.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("probe_chains_host: no CUDA device", file=sys.stderr)
        return 1
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.parallel import DistributedLabeledLDA

    corpus = planted_corpus(args.seed)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    for n_buckets in (1, 4):
        model = DistributedLabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                                      dicti, alpha=0.1, beta=0.01, n_chains=args.chains,
                                      seed=args.seed, n_buckets=n_buckets)
        rec = profile_call(model, args.calls)
        print(json.dumps({"chains": args.chains, "n_buckets": n_buckets, **rec}))
        del model
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
