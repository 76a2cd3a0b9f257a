"""Test sizes of the configurations and traffic mixes that
``portbench_tiny.py`` does not list itself: its ``copy`` cuts down every
configuration named in ``CORPUS`` and every mix named in ``CALLS``, and
these entries add the ones that came after it."""

import portbench_tiny as tiny

tiny.CORPUS.setdefault("locallda_k300", dict(n_train=40, n_test=0, V=200, max_types=30,
                                             mean_types=10))
tiny.FIT.setdefault("locallda_k300", None)  # a training configuration fits nothing
tiny.CALLS.setdefault("train_20x10", dict(iters=4, thinning=2, total_iters=20))
