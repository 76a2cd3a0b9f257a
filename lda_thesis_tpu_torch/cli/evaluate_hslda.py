"""HSLDA train/eval CLI, on PyTorch.

Counterpart of ``lda_thesis_tpu/cli/evaluate_hslda.py``, with its flags:

    python -m lda_thesis_tpu_torch.cli.evaluate_hslda \
        -f abstracts_data.csv -d 3 -k 15 -i 25 -s 5 --test-it 250 --test-s 25

plus ``--device {cuda,cpu}`` (default ``cuda``).  The reference ships HSLDA
library-only; this CLI follows its module-level pipeline
(HSLDA.py:397-417): prefix-expanded labels, the non-shuffled 90/10 split,
chunked training through utils/elastic (``--checkpoint PATH --save-every N
--resume [--max-restarts R]``), the batch fold-in test and the ranking
metrics with the root column dropped; a line of wall times by step follows.
``--n-chains C`` or ``--n-data S`` above 1 train the sharded
``parallel.DistributedHSLDA`` (chain-averaged predictions): in one process
C chains batched on the device, or under ``python -m torch.distributed.run
--nproc-per-node N`` a mesh of N ranks, S data shards by N/S chain rows;
rank 0 alone prints the metrics and writes ``-p``'s pickles.
"""

from __future__ import annotations

import argparse
import pickle
import time

import torch

from .evaluate_labeled_lda import _resumed_at, check_device, distributed_mesh


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", dest="file", required=True, help="dataset location")
    p.add_argument("-d", dest="lvl", type=int, default=3, help="depth of label level")
    p.add_argument("-k", dest="K", type=int, default=15, help="# latent topics")
    p.add_argument("-i", dest="it", type=int, required=True, help="training iterations")
    p.add_argument("-s", dest="thinning", type=int, default=0, help="save frequency")
    p.add_argument("--test-it", type=int, default=250, help="test iterations")
    p.add_argument("--test-s", type=int, default=25, help="test thinning")
    p.add_argument("--opt", type=int, default=1, choices=(1, 2, 3),
                   help="z-coupling variant (HSLDA.py sample_z opt)")
    p.add_argument("--alpha-prime", type=float, default=1.0)
    p.add_argument("--alpha", type=float, default=1.0)
    p.add_argument("--gamma", type=float, default=1.0)
    p.add_argument("--mu", type=float, default=0.0)
    p.add_argument("--sigma", type=float, default=1.0)
    p.add_argument("--xi", type=float, default=0.0)
    p.add_argument("-p", dest="pickle", action="store_true")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint path prefix (writes PATH.npz + PATH.json)")
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="checkpoint every N training cycles "
                        "(must be a multiple of -s; default: only at the end)")
    p.add_argument("--resume", action="store_true",
                   help="resume training from --checkpoint if it exists")
    p.add_argument("--max-restarts", type=int, default=0, metavar="R",
                   help="with --checkpoint: absorb up to R in-process "
                        "training faults by restarting from the last "
                        "durable checkpoint (utils/elastic.elastic_train)")
    p.add_argument("--n-chains", type=int, default=1,
                   help="parallel Gibbs chains (>1: sharded DistributedHSLDA, "
                        "chain-averaged predictions)")
    p.add_argument("--n-data", type=int, default=1,
                   help="document shards per chain row (AD-LDA all-reduce merges)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train and test on")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the model, the metrics and ``stats``, the wall
    seconds by step (load, model, train, test, metrics) and the cycles this
    call trained.  On a distributed run's ranks other than 0 it prints
    nothing after training and returns the model alone."""
    import torch.distributed as dist

    opt = build_parser().parse_args(argv)
    if opt.thinning == 0:
        opt.thinning = opt.it
    check_device(opt)
    had_group = dist.is_available() and dist.is_initialized()
    try:
        return _main(opt)
    finally:
        if not had_group:
            from ..parallel.bootstrap import shutdown

            shutdown()


def _main(opt) -> dict:

    from ..data.corpus import load_corpus, split_data
    from ..eval.metrics import binary_yreal, evaluate_ranking
    from ..models.hslda import HSLDA
    from ..utils.elastic import ElasticGibbs, elastic_train

    t_start = time.time()
    t0 = time.perf_counter()
    corpus = load_corpus(opt.file, d=opt.lvl, mode="prefix")
    # HSLDA's split is NOT shuffled (reference HSLDA.py:397-403)
    train, test = split_data(corpus, shuffle=False)
    stats = {"load_s": time.perf_counter() - t0, "model_s": 0.0}

    print("Starting training...")
    hyper = dict(k=opt.K, alpha_prime=opt.alpha_prime, alpha=opt.alpha,
                 gamma=opt.gamma, mu=opt.mu, sigma=opt.sigma, xi=opt.xi,
                 seed=opt.seed, device=opt.device)

    rank, chains = 0, ""
    if opt.n_chains > 1 or opt.n_data > 1:
        from ..parallel import DistributedHSLDA

        mesh, rank = distributed_mesh(opt)
        chains = f", {opt.n_chains} chains, mesh {mesh.shape}"

        def build():
            return DistributedHSLDA(train.docs, train.labs, list(train.labelset), mesh=mesh,
                                    n_chains=opt.n_chains, **hyper)
    else:
        def build():
            return HSLDA(train.docs, train.labs, list(train.labelset), **hyper)

    def make_model():
        t = time.perf_counter()
        model = build()
        stats["model_s"] += time.perf_counter() - t
        return model

    save_every = opt.save_every or opt.it
    if opt.checkpoint and opt.save_every and save_every % opt.thinning:
        # alignment only matters when checkpoint chunking is requested;
        # otherwise trailing cycles simply run unsaved (reference rule)
        raise SystemExit("--save-every must be a multiple of -s (thinning)")
    stats["train_cycles"] = opt.it - _resumed_at(opt)
    t0 = time.perf_counter()
    if opt.max_restarts > 0:
        if not opt.checkpoint:
            raise SystemExit("--max-restarts requires --checkpoint")
        model = elastic_train(
            make_model, opt.it, opt.thinning, opt.checkpoint, save_every,
            max_restarts=opt.max_restarts, verbose=rank == 0, opt=opt.opt,
            resume_first=opt.resume,
        )
    else:
        eg = ElasticGibbs(make_model(), opt.checkpoint, resume=opt.resume, verbose=rank == 0)
        eg.run(opt.it, opt.thinning, save_every, opt=opt.opt)
        model = eg.model
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)
    stats["train_s"] = time.perf_counter() - t0 - stats["model_s"]

    if rank == 0:
        print("Testing test data...")
    t0 = time.perf_counter()
    scores = model.run_tests(test.docs, it=opt.test_it, s=opt.test_s)
    stats["test_s"] = time.perf_counter() - t0
    if rank != 0:
        return dict(model=model)

    if opt.pickle:
        # scores first: they are the cheap artifact and must survive even if
        # model pickling hits an unpicklable field
        with open("HSLDA_scores.pkl", "wb") as f:
            pickle.dump(scores, f)
        with open("HSLDA_model.pkl", "wb") as f:
            pickle.dump(model, f)

    t0 = time.perf_counter()
    print(f"Model:               HSLDA (PyTorch, {model.device.type}{chains})")
    print("Corpus:             ", opt.file)
    print("Label depth         ", opt.lvl)
    print("# of Gibbs samples: ", int(opt.it))
    print("-----------------------------------")

    y_bin = binary_yreal(test.labs, model.labelmap)
    y_bin, sc = y_bin[:, 1:], scores[:, 1:]  # drop the root column
    valid = (y_bin.sum(axis=1) != 0)
    m = evaluate_ranking(sc[valid], y_bin[valid])
    print("AUC ROC:                 ", m["auc_roc"])
    print("one error:               ", m["one_hit"])
    print("two error:               ", m["two_hit"])
    print("F1 score (macro average) ", m["f1_macro"])
    stats["metrics_s"] = time.perf_counter() - t0
    print(f"wall time by step: load+preprocess {stats['load_s']:.3f} s, model "
          f"{stats['model_s']:.3f} s, train {stats['train_s']:.3f} s "
          f"({stats['train_cycles']} cycles, opt {opt.opt}{chains}), test "
          f"{stats['test_s']:.3f} s "
          f"({opt.test_it} fold-in sweeps), metrics {stats['metrics_s']:.3f} s")
    print(f"total wall time: {time.time()-t_start:.1f}s")
    return dict(model=model, metrics=m, scores=scores, stats=stats)


if __name__ == "__main__":
    main()
