"""LocalLDA train-and-inspect CLI, on PyTorch.

Counterpart of ``lda_thesis_tpu/cli/evaluate_local_lda.py``, with its flags
plus ``--device {cuda,cpu}`` (default ``cuda``): sentence segmentation,
K-topic Gibbs training, top words and perplexity, then a line of wall times
by step.

    python -m lda_thesis_tpu_torch.cli.evaluate_local_lda \
        -f abstracts_data.csv -k 20 -i 100 -s 10 -a 0.1 -b 0.01

The JAX CLI's persistent XLA compile cache has no counterpart: the port's
CUDA kernels are built once into ``lda_thesis_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import csv
import sys
import time

from .evaluate_labeled_lda import check_supported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", dest="file", required=True, help="dataset location")
    p.add_argument("-k", dest="K", type=int, default=20, help="# topics")
    p.add_argument("-i", dest="it", type=int, required=True, help="# of iterations")
    p.add_argument("-s", dest="thinning", type=int, default=0, help="save frequency")
    p.add_argument("-a", dest="alpha", type=float, default=0.1, help="alpha prior")
    p.add_argument("-b", dest="beta", type=float, default=0.01, help="beta prior")
    p.add_argument("--no-sentences", action="store_true",
                   help="treat whole documents as documents (localLDA=False)")
    p.add_argument("--stem", action="store_true", help="Porter-stem tokens")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--topwords", type=int, default=10)
    p.add_argument("--sweep", choices=["auto", "fused", "dense"], default="auto",
                   help="training kernel: the fused merge-block kernel "
                        "(default) or the exact dense sweep")
    p.add_argument("--merge-every", type=int, default=1,
                   help="fused path: sweeps per topic-word table commit "
                        "(M=1 matches the exact sampler's quality; larger "
                        "M trades perplexity for wall)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train on")
    return p


def _read_texts(filename: str):
    csv.field_size_limit(min(sys.maxsize, 2**31 - 1))
    with open(filename, "r", newline="") as f:
        return [row[1] for row in csv.reader(f)]


def main(argv=None) -> dict:
    """Run the CLI; returns the model, its perplexity, the wall seconds by
    step (``stats``) and the kernel launches of training (``launches``:
    kernel 1, and kernel 2's draw and commit kernels)."""
    from ..models.local_lda import LocalLDA
    from ..ops import draw_update_cuda as duc
    from ..ops import fused_block_cuda as fbc

    opt = build_parser().parse_args(argv)
    check_supported(opt)
    if opt.thinning == 0:
        opt.thinning = opt.it

    t_start = time.time()
    t0 = time.perf_counter()
    docs = _read_texts(opt.file)
    stats = {"load_s": time.perf_counter() - t0}
    t0 = time.perf_counter()
    model = LocalLDA(
        docs, alpha=opt.alpha, beta=opt.beta, K=opt.K,
        local_lda=not opt.no_sentences, stem=opt.stem, seed=opt.seed,
        sweep=opt.sweep, merge_every=opt.merge_every, device=opt.device,
    )
    stats["model_s"] = time.perf_counter() - t0
    print(f"LocalLDA: D={model.D} sentence-docs, V={model.V}, K={model.K}")
    before = (fbc.launches, duc.launches, duc.commit_launches)
    t0 = time.perf_counter()
    model.run_training(opt.it, opt.thinning)
    stats["train_s"] = time.perf_counter() - t0
    launches = dict(zip(("fused_block", "draw", "commit"), (
        n - b for n, b in zip((fbc.launches, duc.launches, duc.commit_launches), before))))
    t0 = time.perf_counter()
    model.print_topwords(opt.topwords)
    perplexity = model.perplexity()
    stats["eval_s"] = time.perf_counter() - t0
    print("perplexity:", round(perplexity, 2))
    tokens_per_s = model.n_tokens * opt.it / max(stats["train_s"], 1e-9)
    print(f"wall time by step: load {stats['load_s']:.3f} s, model (preprocess, "
          f"init) {stats['model_s']:.3f} s, train {stats['train_s']:.3f} s ({opt.it} "
          f"sweeps, {tokens_per_s:.1f} tokens/s), top words + perplexity "
          f"{stats['eval_s']:.3f} s")
    print(f"total wall time: {time.time()-t_start:.1f}s")
    return dict(model=model, perplexity=perplexity, stats=stats,
                tokens_per_s=tokens_per_s, launches=launches)


if __name__ == "__main__":
    main()
