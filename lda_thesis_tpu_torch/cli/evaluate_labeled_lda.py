"""Labeled-LDA train/eval CLI (reference evaluate_LabeledLDA.py:110-183), on PyTorch.

Counterpart of ``lda_thesis_tpu/cli/evaluate_labeled_lda.py``, with its flags:

    python -m lda_thesis_tpu_torch.cli.evaluate_labeled_lda \
        -f abstracts_data.csv -d 3 -i 4 -s 4 -l 0 -u 1 -a 0.1 -b 0.01

plus ``--seed``, ``--no-perplexity``, ``--sweep``, ``--n-buckets``,
checkpoint/resume (``--checkpoint PATH --save-every N --resume
[--max-restarts R]``), ``--progress``, ``--trace DIR`` and ``--device
{cuda,cpu}`` (default ``cuda``, the port's counterpart of ``JAX_PLATFORMS``).
The flow is the JAX CLI's: split, prune, chunked training through
utils/elastic (or, with ``--engine vi``, batch CAVI for ``-i`` iterations
and a CAVI fold-in of as many), fold-in test, the reference's filtering and
the metric block; a line of wall times by step follows it.

``--n-chains C`` trains C chains with the distributed trainer
(``parallel/trainer.DistributedLabeledLDA``), batched on this process's
device; ``--n-data S`` shards the documents over S ranks and
``--table-shard vocab`` the topic-word table's vocabulary, under

    python -m torch.distributed.run --nproc-per-node N -m \
        lda_thesis_tpu_torch.cli.evaluate_labeled_lda ... --n-data S

The mesh's chains axis is ``N // S``, lowered until it divides C, and must
then fill the N ranks; the other chains run batched on each rank.
``--dist-backend`` picks the process group's backend (``nccl`` on a card,
``gloo`` on the CPU by default; several ranks on one card need ``gloo``).
Only rank 0 prints the metrics and returns ``stats``.
The JAX CLI's persistent XLA compile cache has no counterpart: the port's
CUDA kernels are built once into ``lda_thesis_tpu_torch/_build/`` and
reused by later runs.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import pickle
import time

import numpy as np
import torch

from ..data.native import pipeline
from ..eval.metrics import binary_yreal, evaluate_ranking
from ..pipeline import split_corpus
from ..utils.config import GibbsConfig, RunConfig


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", dest="file", required=True, help="dataset location")
    p.add_argument("-d", dest="lvl", type=int, default=3, help="depth of label level")
    p.add_argument("-i", dest="it", type=int, required=True, help="# of iterations")
    p.add_argument("-s", dest="thinning", type=int, default=0, help="save frequency")
    p.add_argument("-l", dest="lower", type=float, default=0,
                   help="lower df threshold for dictionary pruning")
    p.add_argument("-u", dest="upper", type=float, default=1,
                   help="upper df threshold for dictionary pruning")
    p.add_argument("-a", dest="alpha", type=float, default=0.1, help="alpha prior")
    p.add_argument("-b", dest="beta", type=float, default=0.01, help="beta prior")
    p.add_argument("-p", dest="pickle", action="store_true",
                   help="save the model as pickle")
    p.add_argument("--seed", type=int, default=None, help="RNG seed")
    p.add_argument("--no-perplexity", action="store_true",
                   help="skip perplexity tracking during training")
    p.add_argument("--engine", choices=("gibbs", "vi"), default="gibbs",
                   help="inference engine: collapsed Gibbs or variational (CAVI)")
    p.add_argument("--sweep", choices=("auto", "fused", "dense", "compact"),
                   default="auto",
                   help="Gibbs sweep kernel (auto=fused); needed e.g. to "
                        "--resume a checkpoint written with another kernel")
    p.add_argument("--n-buckets", type=int, default=None,
                   help="document length buckets (default: the model's 4; "
                        "the bucket layout is part of the draw stream, so "
                        "pass the recorded value when using --resume)")
    p.add_argument("--checkpoint", default=None, metavar="PATH",
                   help="checkpoint path prefix (writes PATH.npz + PATH.json)")
    p.add_argument("--save-every", type=int, default=0, metavar="N",
                   help="checkpoint every N training iterations "
                        "(must be a multiple of -s; default: only at the end)")
    p.add_argument("--resume", action="store_true",
                   help="resume training from --checkpoint if it exists")
    p.add_argument("--max-restarts", type=int, default=0, metavar="R",
                   help="with --checkpoint: absorb up to R in-process "
                        "training faults by restarting from the last "
                        "durable checkpoint (utils/elastic.elastic_train)")
    p.add_argument("--progress", action="store_true",
                   help="report tokens/s + ETA at chunk boundaries "
                        "(utils/tracing.Progress; no per-iteration syncs)")
    p.add_argument("--trace", default=None, metavar="DIR",
                   help="write a torch.profiler trace of training and the "
                        "fold-in test into DIR (utils/tracing.trace; the "
                        "program's spans are named lda/...) and return the "
                        "run's replay counters in stats['counts']")
    p.add_argument("--n-chains", type=int, default=1,
                   help="independent Gibbs chains (distributed trainer)")
    p.add_argument("--n-data", type=int, default=1,
                   help="document shards over the ranks' data mesh axis")
    p.add_argument("--table-shard", choices=("replicated", "vocab"),
                   default="replicated",
                   help="vocab: shard the topic-word table's V axis over the data "
                        "mesh (per-rank state ~V*K/S). Requires --n-data > 1")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="process-group backend (default: nccl on cuda, gloo on cpu)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train and test on")
    return p


def make_config(opt) -> RunConfig:
    return RunConfig(
        file=opt.file,
        depth=opt.lvl,
        label_mode="truncate",
        lower=opt.lower,
        upper=opt.upper,
        gibbs=GibbsConfig(
            iters=opt.it, thinning=opt.thinning, alpha=opt.alpha,
            beta=opt.beta, seed=opt.seed if opt.seed is not None else 0,
        ),
        pickle=opt.pickle,
        n_chains=opt.n_chains,
        n_data_shards=opt.n_data,
    )


def check_device(opt) -> None:
    """Refuse, with ``SystemExit``, ``--device cuda`` where no card is visible."""
    if getattr(opt, "device", "cuda") == "cuda" and not torch.cuda.is_available():
        raise SystemExit("--device cuda: no CUDA device is visible; pass --device cpu "
                         "to run on the CPU")


def check_supported(opt) -> None:
    """Refuse, with ``SystemExit``, what the port cannot run: ``--device
    cuda`` where no card is visible.  Every option of the JAX CLIs is
    ported, the multi-device flags of the Labeled-LDA and HSLDA CLIs
    included."""
    check_device(opt)


def distributed_mesh(opt):
    """``(mesh, rank)`` for ``--n-chains``/``--n-data``: the process group
    from the environment (``python -m torch.distributed.run``; one rank
    without it), ``--n-data`` data shards and the largest chains axis that
    fills the ranks and divides ``--n-chains``."""
    from ..parallel import initialize_distributed, make_mesh
    from ..parallel.bootstrap import world

    initialize_distributed(backend=getattr(opt, "dist_backend", None), device=opt.device)
    rank, size = world()
    if size % opt.n_data:
        raise SystemExit(f"--n-data {opt.n_data} does not divide {size} ranks (run "
                         f"under python -m torch.distributed.run --nproc-per-node N)")
    mesh_chains = size // opt.n_data
    while opt.n_chains % mesh_chains:
        mesh_chains -= 1
    if mesh_chains * opt.n_data != size:
        raise SystemExit(f"--n-chains {opt.n_chains} x --n-data {opt.n_data} cannot fill "
                         f"{size} ranks: the chains axis of {size // opt.n_data} must "
                         "divide --n-chains")
    return make_mesh(n_data=opt.n_data, n_chains=mesh_chains, device=opt.device), rank


def _distributed_model(opt, train, dicti, g, rank_info):
    """A function that makes the distributed trainer on the mesh of
    ``--n-chains``, ``--n-data`` and ``--table-shard``; ``rank_info``
    receives the rank."""
    from ..parallel import DistributedLabeledLDA

    if opt.sweep == "compact":
        raise SystemExit("--sweep compact is single-device only")
    if opt.pickle:
        raise SystemExit("-p pickles a single-device model; the distributed trainer "
                         "saves through --checkpoint")
    mesh, rank_info["rank"] = distributed_mesh(opt)

    def make_model():
        return DistributedLabeledLDA(
            train.docs, train.labs, list(train.labelset), dicti, alpha=g.alpha,
            beta=g.beta, mesh=mesh, n_chains=opt.n_chains, seed=g.seed, sweep=opt.sweep,
            table_shard=getattr(opt, "table_shard", "replicated"),
            n_buckets=getattr(opt, "n_buckets", None) or 1)

    return make_model


def _resumed_at(opt) -> int:
    """The iteration a ``--resume`` run starts from (0 without a checkpoint)."""
    if not (opt.resume and opt.checkpoint and os.path.exists(opt.checkpoint + ".json")):
        return 0
    with open(opt.checkpoint + ".json") as f:
        return int(json.load(f).get("iters_done", 0))


def _train_gibbs(cfg: RunConfig, opt, train, stats: dict = None, rank_info: dict = None):
    """Construct + train the model through the one chunked-training loop,
    utils/elastic.ElasticGibbs (kill the process mid-run, rerun with
    --resume, and the final state is bit-identical to the uninterrupted run;
    --max-restarts additionally absorbs in-process faults via
    elastic_train).  ``stats`` receives the seconds of pruning, of building
    the model and of training, and the sweeps this call trained;
    ``rank_info`` the rank of a distributed run."""
    from ..data.vocab import prune_dict
    from ..models.labeled_lda import LabeledLDA
    from ..utils.elastic import ElasticGibbs, elastic_train

    check_device(opt)
    stats = {} if stats is None else stats
    rank_info = {} if rank_info is None else rank_info
    g = cfg.gibbs
    t0 = time.perf_counter()
    dicti = prune_dict(train.docs, lower=cfg.lower, upper=cfg.upper)
    stats["prune_s"] = time.perf_counter() - t0
    stats["model_s"] = 0.0

    n_chains, n_data = getattr(opt, "n_chains", 1), getattr(opt, "n_data", 1)
    if getattr(opt, "table_shard", "replicated") == "vocab" and n_data < 2:
        raise SystemExit("--table-shard vocab requires --n-data > 1")
    if n_chains > 1 or n_data > 1:
        build = _distributed_model(opt, train, dicti, g, rank_info)
        train_kw = {}
    else:
        bucket_kw = {}
        if getattr(opt, "n_buckets", None):
            bucket_kw["n_buckets"] = int(opt.n_buckets)

        def build():
            return LabeledLDA(
                train.docs, train.labs, list(train.labelset), dicti,
                alpha=g.alpha, beta=g.beta, seed=g.seed, sweep=opt.sweep,
                device=getattr(opt, "device", "cuda"), **bucket_kw,
            )

        train_kw = {"perplexity": not opt.no_perplexity}
    verbose = rank_info.get("rank", 0) == 0

    def make_model():
        t = time.perf_counter()
        model = build()
        stats["model_s"] += time.perf_counter() - t
        return model

    save_every = opt.save_every or g.iters
    if opt.checkpoint and opt.save_every and save_every % g.thinning:
        raise SystemExit("--save-every must be a multiple of -s (thinning)")
    max_restarts = getattr(opt, "max_restarts", 0)
    progress = True if getattr(opt, "progress", False) else None
    stats["train_iters"] = g.iters - _resumed_at(opt)
    t0 = time.perf_counter()
    if max_restarts > 0:
        if not opt.checkpoint:
            raise SystemExit("--max-restarts requires --checkpoint")
        model = elastic_train(
            make_model, g.iters, g.thinning, opt.checkpoint, save_every,
            max_restarts=max_restarts, verbose=verbose,
            resume_first=opt.resume, progress=progress, **train_kw,
        )
    else:
        eg = ElasticGibbs(make_model(), opt.checkpoint, resume=opt.resume,
                          verbose=verbose)
        eg.run(g.iters, g.thinning, save_every, progress=progress if verbose else None,
               **train_kw)
        model = eg.model
    stats["train_s"] = time.perf_counter() - t0 - stats["model_s"]
    return model


def _train_vi(cfg: RunConfig, opt, train, stats: dict):
    """Construct + fit the CAVI model (the JAX CLI's ``--engine vi``);
    ``stats`` receives the seconds of pruning, building and fitting, and
    the CAVI iterations run."""
    from ..data.vocab import prune_dict
    from ..models.labeled_lda_vi import LabeledLDAVI

    g = cfg.gibbs
    t0 = time.perf_counter()
    dicti = prune_dict(train.docs, lower=cfg.lower, upper=cfg.upper)
    stats["prune_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model = LabeledLDAVI(train.docs, train.labs, list(train.labelset), dicti,
                         alpha=g.alpha, beta=g.beta, seed=g.seed, device=opt.device)
    stats["model_s"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    model.fit(iters=g.iters)
    stats["train_s"] = time.perf_counter() - t0
    stats["train_iters"] = len(model.elbo_history)
    return model


def main(argv=None) -> dict:
    """Run the CLI; returns the model, the metrics, ``stats`` (the wall
    seconds by step and the sweeps trained), the training rate and the
    preprocessing pipeline that ran.  On a distributed run's ranks other
    than 0 it prints nothing after training and returns the model alone."""
    import torch.distributed as dist

    opt = build_parser().parse_args(argv)
    check_device(opt)
    had_group = dist.is_available() and dist.is_initialized()
    try:
        return _main(opt)
    finally:
        if not had_group:
            from ..parallel.bootstrap import shutdown

            shutdown()


def _main(opt) -> dict:
    from ..utils.tracing import annotate, counts, trace

    cfg = make_config(opt)  # applies the thinning == 0 -> iters rule
    g = cfg.gibbs

    t_start = time.time()
    t0 = time.perf_counter()
    train, test = split_corpus(cfg.file, d=cfg.depth, seed=opt.seed)
    stats = {"load_s": time.perf_counter() - t0}

    tracer = trace(opt.trace) if opt.trace else contextlib.nullcontext()
    counted = counts()
    rank_info = {}
    print("Starting training...")
    with tracer:
        vi = opt.engine == "vi"
        with annotate("train"):
            if vi:
                model = _train_vi(cfg, opt, train, stats)
            else:
                model = _train_gibbs(cfg, opt, train, stats, rank_info)
        if rank_info.get("rank", 0) == 0:
            print("Testing test data...")
        t0 = time.perf_counter()
        with annotate("test"):
            if vi:
                th = model.infer(test.docs, iters=g.iters)
            else:
                th = model.run_test(test.docs, cfg.test_iters, cfg.test_thinning)
        stats["test_s"] = time.perf_counter() - t0
    if opt.trace:  # the replay runners' phases in the traced run, by span name
        stats["counts"] = {k: n - counted.get(k, 0) for k, n in counts().items()
                           if n != counted.get(k, 0)}
    if rank_info.get("rank", 0) != 0:
        return dict(model=model)
    if opt.trace:
        print(f"device profile written to {opt.trace} "
              f"(view: tensorboard --logdir {opt.trace})")
    th = np.array(th)

    if cfg.pickle:
        for name, obj in (("model", model), ("testset", test), ("theta", th)):
            with open(f"LabeledLDA_{name}.pkl", "wb") as f:
                pickle.dump(obj, f)

    t0 = time.perf_counter()
    engine = "CAVI" if opt.engine == "vi" else "Gibbs"
    mesh = getattr(model, "mesh", None)
    where = model.device.type if mesh is None else (
        f"{model.device.type}, {model.n_chains} chains, mesh {mesh.shape}")
    print(f"Model:               Labeled LDA ({engine}, PyTorch, {where})")
    print("Corpus:             ", cfg.file)
    print("Label depth         ", cfg.depth)
    print("# of Gibbs samples: ", int(g.iters))
    print("-----------------------------------")

    y_bin = binary_yreal(test.labs, model.labelmap)

    # reference filtering (evaluate_LabeledLDA.py:159-167): drop the root
    # column, then docs with all-zero prediction rows
    y_bin = y_bin[:, 1:]
    th = th[:, 1:]
    nonzero = np.where(th.sum(axis=1) != 0)[0]
    y_bin, th = y_bin[nonzero], th[nonzero]

    m = evaluate_ranking(th, y_bin)
    print("AUC ROC:                 ", m["auc_roc"])
    print("one error:               ", m["one_hit"])
    print("two error:               ", m["two_hit"])
    print("F1 score (macro average) ", m["f1_macro"])
    stats["metrics_s"] = time.perf_counter() - t0
    tokens_per_s = model.n_tokens * stats["train_iters"] / max(stats["train_s"], 1e-9)
    print(f"wall time by step: load+preprocess {stats['load_s']:.3f} s ({pipeline()}), "
          f"prune {stats['prune_s']:.3f} s, model {stats['model_s']:.3f} s, train "
          f"{stats['train_s']:.3f} s ({stats['train_iters']} "
          f"{'CAVI iterations' if opt.engine == 'vi' else 'sweeps'}, "
          f"{tokens_per_s:.1f} tokens/s), test {stats['test_s']:.3f} s, metrics "
          f"{stats['metrics_s']:.3f} s")
    print(f"total wall time: {time.time()-t_start:.1f}s")
    return dict(model=model, metrics=m, stats=stats, tokens_per_s=tokens_per_s,
                pipeline=pipeline())


if __name__ == "__main__":
    main()
