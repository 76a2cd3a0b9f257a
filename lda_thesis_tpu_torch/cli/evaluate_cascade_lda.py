"""CascadeLDA train/eval CLI (reference evaluate_CascadeLDA.py:144-228), on PyTorch.

Counterpart of ``lda_thesis_tpu/cli/evaluate_cascade_lda.py``, with its flags:

    python -m lda_thesis_tpu_torch.cli.evaluate_cascade_lda \
        -f abstracts_data.csv -d 3 -i 4 -s 2 -a 0.001 -b 0.001

plus ``--device {cuda,cpu}`` (default ``cuda``).  It trains with
``CascadeLDA.go_down_tree``, predicts down the tree with
``test_down_tree_batch``, scores with ``eval/cascade.setup_theta`` and
prints one metric block per depth.  The JAX CLI's persistent XLA compile
cache has no counterpart: the port's CUDA kernels are built once into
``lda_thesis_tpu_torch/_build/``.
"""

from __future__ import annotations

import argparse
import pickle
import time

import numpy as np

from .evaluate_labeled_lda import check_supported


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("-f", dest="file", required=True, help="dataset location")
    p.add_argument("-d", dest="lvl", type=int, default=3, help="depth of label level")
    p.add_argument("-i", dest="it", type=int, required=True,
                   help="# of iterations - train and test")
    p.add_argument("-s", dest="thinning", type=int, default=0, help="save frequency")
    p.add_argument("-a", dest="alpha", type=float, default=0.1, help="alpha prior")
    p.add_argument("-b", dest="beta", type=float, default=0.01, help="beta prior")
    p.add_argument("-l", dest="lower", type=float, default=0,
                   help="lower df threshold for dictionary pruning")
    p.add_argument("-u", dest="upper", type=float, default=1,
                   help="upper df threshold for dictionary pruning")
    p.add_argument("-p", dest="pickle", action="store_true",
                   help="save the model as pickle")
    p.add_argument("--seed", type=int, default=None, help="RNG seed")
    p.add_argument("--threshold", type=float, default=0.95,
                   help="cascade expansion threshold")
    p.add_argument("--root-it", type=int, default=None,
                   help="root-level Gibbs iterations (default: 4*iters; pass "
                        "the -i value for the reference's uniform schedule)")
    p.add_argument("--root-s", type=int, default=None,
                   help="root-level thinning (default: 2*thinning; pass the "
                        "-s value for the reference's uniform schedule)")
    p.add_argument("--test-it", type=int, default=None,
                   help="fold-in test iterations (default: same as -i)")
    p.add_argument("--test-s", type=int, default=None,
                   help="fold-in test thinning (default: same as -s)")
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                   help="device to train and test on")
    return p


def main(argv=None) -> dict:
    """Run the CLI; returns the model and the metrics of each depth."""
    opt = build_parser().parse_args(argv)
    if opt.thinning == 0:
        opt.thinning = opt.it

    check_supported(opt)

    from ..data.corpus import load_corpus, split_data
    from ..data.vocab import prune_dict
    from ..eval.cascade import setup_theta
    from ..eval.metrics import binary_yreal, evaluate_ranking
    from ..models.cascade_lda import CascadeLDA

    t0 = time.time()
    # the reference driver always loads prefix-expanded depth-3 labels
    # (evaluate_CascadeLDA.py:167, CascadeLDA.py:437-447)
    corpus = load_corpus(opt.file, d=3, mode="prefix")
    train, test = split_data(corpus, seed=opt.seed)

    print("Starting training...")
    dicti = prune_dict(train.docs, lower=opt.lower, upper=opt.upper)
    model = CascadeLDA(train.docs, train.labs, list(train.labelset), dicti,
                       alpha=opt.alpha, beta=opt.beta,
                       seed=opt.seed if opt.seed is not None else 0,
                       device=opt.device)
    model.go_down_tree(it=opt.it, s=opt.thinning,
                       root_it=opt.root_it, root_s=opt.root_s)

    print("Testing test data...")
    test_it = opt.test_it if opt.test_it is not None else opt.it
    test_s = opt.test_s if opt.test_s is not None else opt.thinning
    l1, l2, l3 = model.test_down_tree_batch(
        test.docs, it=test_it, thinning=test_s, threshold=opt.threshold
    )

    if opt.pickle:
        for name, obj in (("model", model), ("testset", test), ("d1_pred", l1),
                          ("d2_pred", l2), ("d3_pred", l3)):
            with open(f"Cascade_{name}.pkl", "wb") as f:
                pickle.dump(obj, f)
        print("Saved the model and predictions as pickles!")

    th_all = setup_theta(l1, l2, l3, model.labelmap)
    y_all = binary_yreal(test.labs, model.labelmap)

    by_depth = []
    for depth in range(1, int(opt.lvl) + 1):
        print(f"Model:               CascadeLDA (PyTorch, {model.device.type})")
        print("Corpus:             ", opt.file)
        print("Label depth         ", depth)
        print("# of Gibbs samples: ", int(opt.it))
        print("-----------------------------------")

        inds = np.array([len(x) == depth for x in model.labelmap.keys()])
        y_bin = y_all[:, inds]
        th = th_all[:, inds]

        # drop no-prediction and no-label documents (ref :206-212)
        valid = (th.sum(axis=1) != 0) & (y_bin.sum(axis=1) != 0)
        m = evaluate_ranking(th[valid], y_bin[valid])
        print("AUC ROC:                 ", m["auc_roc"])
        print("one error:               ", m["one_hit"])
        print("two error:               ", m["two_hit"])
        print("F1 score (macro average) ", m["f1_macro"])
        by_depth.append(m)
    print(f"total wall time: {time.time()-t0:.1f}s")
    return dict(model=model, metrics=by_depth)


if __name__ == "__main__":
    main()
