"""Single-device entry point: one fused merge block on a toy problem.

Counterpart of ``__graft_entry__.entry()``.  :func:`entry` returns
``(fn, args)`` where ``fn(*args)`` runs one Labeled-LDA merge block of
M = 2 sweeps (``ops/gibbs_fused.fused_train_block``, the main path's
training step) on a copy of ``_toy_problem`` (D = 32, U = 8, V = 128,
K = 16, numpy seed 0): on a card it launches the merge-block CUDA kernel
once.  The multi-device dry run waits for the port of ``parallel/``
(ROADMAP.md Queue 1 item 9).

    python -m lda_thesis_tpu_torch.entry [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .data.encode import compact_labels
from .ops.gibbs_fused import fused_train_block, init_fused

__all__ = ["entry"]


def _toy_problem(D=32, U=8, V=128, K=16, seed=0):
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    tok_f = rng.integers(1, 5, size=(D, U)).astype(np.int32)
    tok_f[:, U - 2 :] = 0  # padding slots
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0  # root always admissible
    return tok_v, tok_f, labs


def entry(device=None):
    """(fn, example_args): one fused merge block of M = 2 sweeps on
    ``device`` (CUDA unless the caller passes ``"cpu"``); the last argument
    is the block's ``torch.Generator``."""
    dev = torch.device("cuda" if device is None else device)
    tok_v_np, tok_f_np, labs_np = _toy_problem()
    lab_ids, lab_valid = compact_labels(labs_np)
    V, K = 128, 16
    tok_v = torch.as_tensor(tok_v_np, dtype=torch.int64, device=dev)
    tok_f = torch.as_tensor(tok_f_np, dtype=torch.int64, device=dev)
    li = torch.as_tensor(lab_ids, dtype=torch.int64, device=dev)
    lv = torch.as_tensor(lab_valid, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_fused(tok_v, tok_f, li, lv, V, K, generator=gen)
    tvt = tok_v.T.contiguous()
    tft = tok_f.T.to(torch.float32).contiguous()
    lvt = lv.T.contiguous()

    def fn(state, tvt, tft, li, lvt, gen):
        return fused_train_block(state, tvt, tft, li, lvt, 0.1, 0.01, M=2,
                                 generator=gen)

    return fn, (state, tvt, tft, li, lvt, gen)


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    opt = p.parse_args(argv)
    fn, args = entry(opt.device)
    out = fn(*args)
    if float(out.n_vk.sum()) != float(args[2].sum()):
        raise SystemExit("entry: the table's total differs from the tokens'")
    print("entry ok")


if __name__ == "__main__":
    main()
