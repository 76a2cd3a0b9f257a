"""Training throughput of the port's fused, compact and LocalLDA paths on the card.

    python3 tools/probe_train_graphs.py [TREE]

Runs, with the port found in ``TREE`` (default: this checkout), on the
first cell's corpus (``planted_corpus(seed=0)``) and through the public
entry points only, so any commit of the port can be measured:

* ``LabeledLDA`` fused, ``run_training(50, 25, total_iters=2000)`` with
  perplexity off (``bench.py``'s setting) and on: two warm-up calls, then 5
  timed calls (host clock, each ending in a synchronize; the median rate)
  and one under torch.profiler (device busy ms and idle share);
* ``LabeledLDA`` compact, ``run_training(10, 5)``: a fresh model's first
  call and a second call, timed;
* ``LocalLDA`` at K = 20 on ``planted_corpus(seed=0, V=11_889)``'s texts,
  ``run_training(100, 10)``: a first and a second call, timed.

To compare two commits on one card, unpack each into a directory and run
them in turns in one call:

    for t in parent change change parent; do
        python3 tools/probe_train_graphs.py $t; done

Prints one JSON line: the tree, the numbers and the card's name and power
limit.  About 30 s a tree on an H100, the kernel build included.
"""

import json
import os
import sys
import time

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, TREE)
os.chdir(TREE)

CALLS = 5


def _timed(fn) -> float:
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def main() -> int:
    import numpy as np
    import torch

    import chip_smoke as cs
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    if not torch.cuda.is_available():
        print("probe_train_graphs: no CUDA device", file=sys.stderr)
        return 1
    if not fbc.__file__.startswith(TREE):
        raise RuntimeError(f"the port was imported from {fbc.__file__}, not {TREE}")
    fbc.build()
    c = planted_corpus(0)
    d = prune_dict(c.train_docs, lower=0, upper=1)
    out = {"tree": TREE}

    model = LabeledLDA(c.train_docs, c.train_labs, c.labelset, d, alpha=0.1, beta=0.01,
                       seed=0, device="cuda")
    for perplexity in (False, True):
        def train():
            model.run_training(50, 25, perplexity=perplexity, total_iters=2000)

        for _ in range(2):
            train()
        walls = [_timed(train) for _ in range(CALLS)]
        prof = cs._profile(train)
        out[f"fused_perplexity_{'on' if perplexity else 'off'}"] = dict(
            tokens_per_s=model.n_tokens * 50 / float(np.median(walls)), walls_s=walls,
            busy_ms=prof["busy_ms"], profiled_wall_ms=prof["wall_ms"],
            idle_share=prof["idle_share"])
    del model

    model = LabeledLDA(c.train_docs, c.train_labs, c.labelset, d, alpha=0.1, beta=0.01,
                       seed=0, sweep="compact", device="cuda")
    walls = [_timed(lambda: model.run_training(10, 5)) for _ in range(2)]
    out["compact"] = dict(walls_s=walls, tokens_per_s=[model.n_tokens * 10 / w for w in walls])
    del model

    local = planted_corpus(0, V=11_889)
    texts = [" ".join(cs.csv_word(int(w[1:])) for w in doc)
             for doc in local.train_docs + local.test_docs]
    model = LocalLDA(texts, alpha=0.1, beta=0.01, K=20, seed=0, device="cuda")
    out["local_k20_train_s"] = [_timed(lambda: model.run_training(100, 10)) for _ in range(2)]
    out["card"] = cs._card_line()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
