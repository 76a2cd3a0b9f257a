"""HSLDA training time of the port on the card, through its public entry points.

    python3 tools/probe_hslda_train.py [TREE]

Runs, with the port found in ``TREE`` (default: this checkout), at the JAX
record's width (``jel_corpus(seed=0, n_l3=371)``: D = 4,171, N = 192,
L = 512, K = 15), so any commit of the port can be measured:

* ``HSLDA.run_training(25, 5)`` (the CLI's training at ``-i 25 -s 5``): a
  fresh model's first call, then two calls with ``continue_avg`` (host
  clock, each ending in a synchronize), then one under torch.profiler
  (device busy ms and idle share); then ``train_cycle(1)``: the host ms
  to issue a cycle (``chip_smoke._host_ms``: 5 cycles back to back, no
  synchronize) and its device ms (``chip_smoke._batch_ms``: CUDA events
  around 5 cycles);
* a one-rank ``DistributedHSLDA`` at C = 1 and 64 chains: a warm-up
  ``run_training(4, 2)``, then ``run_training(5, 5)`` timed
  (chain-cycles/s) and the peak device memory from the model's
  construction on.

To compare two commits on one card, unpack each into a directory and run
them in turns in one call:

    for t in parent change change parent; do
        python3 tools/probe_hslda_train.py $t; done

Prints one JSON line: the tree, the numbers and the card's name and power
limit.  About 40 s a tree on an H100.
"""

import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, TREE)
os.chdir(TREE)

CHAINS = (1, 64)


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    import torch

    import chip_smoke as cs
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.models.hslda import HSLDA
    from lda_thesis_tpu_torch.parallel import DistributedHSLDA, make_mesh

    if not torch.cuda.is_available():
        print("probe_hslda_train: no CUDA device", file=sys.stderr)
        return 1
    if not cs.__file__.startswith(TREE):
        raise RuntimeError(f"chip_smoke was imported from {cs.__file__}, not {TREE}")
    jel = jel_corpus(0, n_l3=371)
    args = (jel.train_docs, jel.train_labs, jel.labelset)
    out = {"tree": TREE}

    model = HSLDA(*args, k=15, seed=0, device="cuda")
    walls = [_timed(lambda n=n: model.run_training(25, 5, continue_avg=n > 0))
             for n in range(3)]
    prof = cs._profile(lambda: model.run_training(25, 5, continue_avg=True))
    out["hslda_25_5"] = dict(walls_s=walls, cycle_ms=[1e3 * w / 25 for w in walls],
                             busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"],
                             idle_share=prof["idle_share"])
    out["cycle_host_ms"] = cs._host_ms(lambda: model.train_cycle(1), 5)
    out["cycle_device_ms"] = cs._batch_ms(lambda: model.train_cycle(1), 5)
    del model
    torch.cuda.empty_cache()

    for C in CHAINS:
        torch.cuda.reset_peak_memory_stats()
        m = DistributedHSLDA(*args, mesh=make_mesh(device="cuda"), n_chains=C, k=15, seed=0)
        m.run_training(4, 2)
        wall = _timed(lambda: m.run_training(5, 5))
        out[f"chains_{C}"] = dict(wall_s=wall, chain_cycles_per_s=5 * C / wall,
                                  peak_gb=torch.cuda.max_memory_allocated() / 1e9)
        del m
        torch.cuda.empty_cache()
    out["card"] = cs._card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
