"""Device ms of one replayed single-chain dense sweep on the card.

    python3 tools/probe_single_chain_sweep.py [TREE]

Times the exact dense sweep as the single-device dense path replays it
(``chip_smoke.bucket_runners``: one ``ExactSweep`` graph per bucket of the
first cell, ``planted_corpus(seed=0)``, K = 512, 288 draw and 292 commit
launches), CUDA events around 20 replays, 5 times, with the port found in
``TREE`` (default: this checkout).  To compare two commits on one card,
unpack each into a directory and run them in turns in one call:

    for t in parent change change parent; do
        python3 tools/probe_single_chain_sweep.py $t; done

Prints one JSON line: the tree, the 5 times and the card's name and power
limit.  About 20 s a tree on an H100, the kernel build included.
"""

import json
import os
import sys

TREE = os.path.abspath(sys.argv[1] if len(sys.argv) > 1 else
                       os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
sys.path.insert(0, TREE)
os.chdir(TREE)


def main() -> int:
    import torch

    import chip_smoke as cs
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    if not torch.cuda.is_available():
        print("probe_single_chain_sweep: no CUDA device", file=sys.stderr)
        return 1
    assert duc.__file__.startswith(TREE), duc.__file__
    duc.build()
    c = planted_corpus(0)
    d = prune_dict(c.train_docs, lower=0, upper=1)
    model = LabeledLDA(c.train_docs, c.train_labs, c.labelset, d, alpha=0.1, beta=0.01,
                       seed=0, sweep="dense", device="cuda")
    runs, _ = cs.bucket_runners(model)
    gen = torch.Generator("cuda").manual_seed(1)
    for _ in range(2):  # eager, then the capture and a first replay
        for r in runs:
            r(gen)
    torch.cuda.synchronize()

    def replay():
        for r in runs:
            r._graph.replay()

    ms = [cs._batch_ms(replay, 20) for _ in range(5)]
    print(json.dumps({"tree": TREE, "sweep_ms": ms, "card": cs._card_line()}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
