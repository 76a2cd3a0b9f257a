"""Single-device entry point: one fused merge block on a toy problem.

Counterpart of ``__graft_entry__.entry()``.  :func:`entry` returns
``(fn, args)`` where ``fn(*args)`` runs one Labeled-LDA merge block of
M = 2 sweeps (``ops/gibbs_fused.fused_train_block``, the main path's
training step) on a copy of ``_toy_problem`` (D = 32, U = 8, V = 128,
K = 16, numpy seed 0): on a card it launches the merge-block CUDA kernel
once.  :func:`dryrun_multichip` (the counterpart of
``__graft_entry__.dryrun_multichip``) spawns ``n`` ranks and runs one full
sharded training step on the same problem: a dense AD-LDA sweep of every
chain, the merge over the data row and the thinned update; then the
sharded HSLDA loop (``parallel/hslda_sharded``) for 3 cycles at thinning
2 on ``__graft_entry__``'s HSLDA problem.

    python -m lda_thesis_tpu_torch.entry [--device cpu] [--dryrun N [--backend gloo]]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .data.encode import compact_labels
from .ops.gibbs_fused import fused_train_block, init_fused

__all__ = ["entry", "dryrun_multichip"]


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


def dryrun_multichip(n_devices: int, device=None, backend=None, timeout: float = 300.0) -> dict:
    """One full sharded training step on ``n_devices`` spawned ranks over a
    ``(chains, data)`` mesh (2 chain rows where ``n_devices`` is even, two
    chains per row), on ``_toy_problem(D = 4·n)``; checks the merged table's
    total and the pooled φ̂'s shape and returns rank 0's summary.  ``device``
    is CUDA unless the caller passes ``"cpu"``; ``backend`` defaults to
    ``nccl`` on CUDA and ``gloo`` on the CPU (several ranks on one card need
    ``gloo``)."""
    from .parallel.launch import spawn

    dev = "cuda" if device is None else str(device)
    if backend is None:
        backend = "nccl" if dev.startswith("cuda") else "gloo"
    return spawn("lda_thesis_tpu_torch.entry:_dryrun_rank", int(n_devices),
                 {"n": int(n_devices), "device": dev}, backend=backend, device=dev, timeout=timeout)[0]


def _dryrun_rank(payload) -> dict:
    from .parallel import make_mesh, make_sharded_train_step, shard_corpus
    from .parallel.sharded import init_sharded_state, make_generators, pooled_phi

    n = payload["n"]
    mesh_chains = 2 if n % 2 == 0 and n >= 2 else 1
    mesh = make_mesh(n_data=n // mesh_chains, n_chains=mesh_chains,
                     device=payload["device"])
    n_chains = 2 * mesh_chains
    V, K = 128, 16
    tok_v, tok_f, labs = _toy_problem(D=4 * n, V=V, K=K)
    corpus = shard_corpus(mesh, tok_v, tok_f, labs)
    gens = make_generators(mesh, n_chains, seed=0)
    state = init_sharded_state(mesh, corpus, V, n_chains, gens)
    step = make_sharded_train_step(mesh, n_chains, alpha=0.1, beta=0.01)
    state = step(state, corpus, True, generators=gens)
    total = float(state.n_vk[0].sum())
    if total != float(tok_f.sum()):
        raise AssertionError(f"merged table holds {total} tokens, corpus {tok_f.sum()}")
    ph = pooled_phi(state, mesh, n_chains)
    if tuple(ph.shape) != (V, K):
        raise AssertionError(f"pooled phi has shape {tuple(ph.shape)}")
    out = {"mesh": mesh.shape, "coords": mesh.coords, "backend": mesh.backend,
           "device": str(mesh.device), "tokens": total, "s": state.s}
    out["hslda"] = _dryrun_hslda(mesh, n_chains, 4 * n)
    return out


def _dryrun_hslda(mesh, n_chains: int, D: int) -> dict:
    """The sharded HSLDA loop of ``__graft_entry__.dryrun_multichip``: D
    documents of 3–7 tokens over 64 words, K = 6, five labels (numpy seed
    1); 3 cycles at thinning 2, so one save; checks the save count and
    every chain's token totals."""
    from .data.encode import encode_instances
    from .ops.sampling import stirling_table
    from .parallel.hslda_sharded import (init_hslda_sharded, make_hslda_generators,
                                         make_hslda_train_loop, shard_hslda_corpus)
    from .parallel.jobs import hslda_invariants

    rng = np.random.default_rng(1)
    V, K, L = 64, 6, 5
    docs = [rng.integers(0, V, size=rng.integers(3, 8)).tolist() for _ in range(D)]
    tok_v, mask = encode_instances(docs)
    labs = np.zeros((D, L), np.float32)
    labs[:, 0] = 1
    for d in range(D):
        labs[d, rng.integers(1, L)] = 1
    corpus = shard_hslda_corpus(mesh, tok_v, mask, labs)
    gens = make_hslda_generators(mesh, n_chains, seed=1)
    state = init_hslda_sharded(mesh, corpus, V, K, n_chains, gens)
    table = stirling_table(16)
    logs = torch.as_tensor(np.log(np.where(table > 0, table, 1e-300)), dtype=torch.float32,
                           device=mesh.device)
    loop = make_hslda_train_loop(mesh, corpus, n_chains, logs, D_total=D)
    ph = torch.zeros((state.n_k.shape[0], K, V), dtype=torch.float32, device=mesh.device)
    state, ph, saves = loop(state, ph, 0, 3, 2, gens)
    if saves != 1:
        raise AssertionError(f"the HSLDA loop folded in {saves} saves, not 1")
    inv = hslda_invariants(mesh, state, int(mask.sum()), "replicated")
    if not inv["ok"]:
        raise AssertionError(f"HSLDA count invariants fail: {inv}")
    return {"chains": state.n_k.shape[0], "saves": saves, "tokens": inv["n_vk"]}


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--device", choices=("cuda", "cpu"), default="cuda")
    p.add_argument("--dryrun", type=int, default=0, metavar="N",
                   help="spawn N ranks and run one sharded training step")
    p.add_argument("--backend", choices=("nccl", "gloo"), default=None)
    opt = p.parse_args(argv)
    if opt.dryrun:
        print("dryrun_multichip ok", dryrun_multichip(opt.dryrun, opt.device, opt.backend))
        return
    fn, args = entry(opt.device)
    out = fn(*args)
    if float(out.n_vk.sum()) != float(args[2].sum()):
        raise SystemExit("entry: the table's total differs from the tokens'")
    print("entry ok")


if __name__ == "__main__":
    main()
