"""LocalLDA CLI training time on the card, with the port of any tree.

    python3 tools/probe_local_cli.py [TREE] [-k K]

Writes a CSV of ``planted_corpus(seed=0, V=11_889)`` (``chip_smoke.py``
phase 10's corpus) into a temporary directory, then runs the LocalLDA CLI
of the port found in ``TREE`` (default: this checkout) at ``-k K``
(default 300) and (20; 10), four times in one process: the first call
builds the kernels and warms up, the other three are timed by the CLI's
own step timers (host clock).  Prints one JSON line: the tree, the card's
name and power limit, each run's training seconds, kernel-1 launches and
perplexity.  To compare two commits on one card, unpack each into a
directory and run them in turns in one call:

    for t in parent change change parent; do
        python3 tools/probe_local_cli.py $t; done

About 25 s a tree on an H100, the kernel build included.
"""

import argparse
import json
import os
import sys

RUNS = 4


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("tree", nargs="?",
                   default=os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
    p.add_argument("-k", type=int, default=300)
    args = p.parse_args(argv)
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    os.chdir(tree)

    import contextlib
    import io
    import tempfile

    import chip_smoke as cs
    from lda_thesis_tpu_torch.cli import evaluate_local_lda
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus

    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "local.csv")
        cs.write_corpus_csv(csv_path, planted_corpus(0, V=cs.LOCAL_V))
        for _ in range(RUNS):
            with contextlib.redirect_stdout(io.StringIO()):
                res = evaluate_local_lda.main(["-f", csv_path, "--seed", "0", "-i", "20",
                                               "-s", "10", "-k", str(args.k)])
            runs.append(dict(train_s=res["stats"]["train_s"], launches=res["launches"],
                             perplexity=res["perplexity"]))
    print(json.dumps({"tree": tree, "card": cs._card_line(), "k": args.k, "runs": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
