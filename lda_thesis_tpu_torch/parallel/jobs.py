"""Multi-rank runs of the distributed trainer, for :func:`.launch.spawn`.

Each job takes one payload dict, runs on every rank of the process group
that the launcher brought up, and returns plain host data.  The test suite
and ``chip_smoke.py`` drive the parallel layer through these:

* :func:`train_job` builds a :class:`.trainer.DistributedLabeledLDA` over
  the payload's corpus, optionally loads a global state
  (:func:`..convert.sharded_state_from_numpy`), trains, checks after every
  merge that the data row's replicas are identical, and returns this
  rank's state, the global count invariants, kernel launches and, if
  asked, a kill-and-resume run through the sharded checkpoint and the
  pooled estimators;
* :func:`block_job` runs one merge block (or one dense AD-LDA step) from a
  given global state with given uniforms, for comparison with the JAX
  package;
* :func:`arrays_job` drives the layer functions (dense step, vocab-sharded
  block and loop) on raw corpus arrays;
* :func:`mesh_job` builds meshes and checks the collectives;
* :func:`cli_job` runs the Labeled-LDA CLI's ``main``;
* :func:`hslda_job` builds a :class:`.hslda_trainer.DistributedHSLDA`,
  trains it, checks after every call that the data row's replicas of each
  chain (tables, η, β) are bitwise equal, and returns this rank's state,
  the count invariants and, if asked, the chain-averaged scores and a
  kill-and-resume run through the sharded checkpoint;
* :func:`hslda_arrays_job` drives ``parallel/hslda_sharded`` on raw corpus
  arrays: one cycle from a given global state with given noise, or the
  training loop;
* :func:`multi_job` runs several of these in one spawn.
"""

from __future__ import annotations

import time
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["train_job", "block_job", "arrays_job", "mesh_job", "cli_job", "multi_job",
           "replica_check", "count_invariants", "build_model", "hslda_job", "hslda_arrays_job",
           "hslda_invariants", "hslda_replicas_equal", "build_hslda"]


def build_model(p: Dict[str, Any]):
    """The payload's trainer: ``docs``, ``labs``, ``labelset``, ``mesh``
    ``(mesh_chains, n_data)``, ``device`` and trainer keywords ``kw``."""
    from ..data.vocab import Dictionary
    from .sharded import make_mesh
    from .trainer import DistributedLabeledLDA

    mc, nd = p.get("mesh", (1, 1))
    mesh = make_mesh(n_data=nd, n_chains=mc, device=p.get("device"))
    return DistributedLabeledLDA(p["docs"], p["labs"], p["labelset"], Dictionary(p["docs"]),
                                 mesh=mesh, **p.get("kw", {}))


def replica_check(model, counter: list):
    """An ``on_merge`` hook: after every merge, the replicated tables
    (``n_vk`` and ``n_k``; ``n_k`` alone when vocab-sharded) must be bitwise
    identical across the data row (elementwise max and min over the row
    equal the local table)."""
    def check(state):
        tables = [state.n_k] if model.table_shard == "vocab" else [state.n_vk, state.n_k]
        for t in tables:
            for op in ("max", "min"):
                other = model.mesh.data_extreme_(t.clone(), op)
                if not torch.equal(other, t):
                    raise AssertionError(f"table replicas differ after merge {counter[0] + 1}")
        counter[0] += 1
    return check


def count_invariants(model) -> Dict[str, Any]:
    """Global count invariants of every chain: Σn_dk = Σn_vk = Σf, no
    negative count, n_k = Σ_v n_vk (summed over the data row)."""
    st, mesh = model.state, model.mesh
    ndks = st.n_dk if isinstance(st.n_dk, tuple) else (st.n_dk,)
    L = st.n_k.shape[0]
    ndk_sum = sum(n.reshape(L, -1).sum(dim=1, dtype=torch.float64) for n in ndks)
    vk_sum = st.n_vk.reshape(L, -1).sum(dim=1, dtype=torch.float64)
    col = st.n_vk.sum(dim=1)
    if model.table_shard == "vocab":
        vk_sum = mesh.data_sum_(vk_sum)
        col = mesh.data_sum_(col)
    ndk_sum = mesh.data_sum_(ndk_sum.clone())
    neg = torch.tensor([float(min(float(n.min()) for n in ndks) < 0
                              or float(st.n_vk.min()) < 0)], device=st.n_k.device)
    mesh.data_extreme_(neg, "max")
    total = float(model.n_tokens)
    return {"total": total, "n_dk": ndk_sum.tolist(), "n_vk": vk_sum.tolist(),
            "n_k_equal": bool(torch.equal(col, st.n_k)), "negative": bool(neg.item()),
            "ok": bool(all(x == total for x in ndk_sum.tolist() + vk_sum.tolist())
                       and torch.equal(col, st.n_k) and not neg.item())}


def _host_state(state) -> Dict[str, Any]:
    out = {}
    for name, value in state._asdict().items():
        if isinstance(value, tuple):
            out[name] = [v.cpu().numpy() for v in value]
        elif isinstance(value, torch.Tensor):
            out[name] = value.cpu().numpy()
        else:
            out[name] = value
    return out


def _sync(model) -> None:
    if model.device.type == "cuda":
        torch.cuda.synchronize(model.device)


def train_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """Train the payload's model: ``steps`` is a list of ``(iters,
    thinning, total_iters)`` calls; ``init`` a global state to start from;
    ``resume`` ``{"path", "at"}`` also runs the same steps killed after
    ``at`` sweeps (a fresh model restored from the checkpoint; with
    ``wrong_kw``, first into a model built with those keywords, recording
    the refusal); ``test``
    ``(docs, it, thinning, chain)`` a fold-in after training."""
    from ..ops import draw_update_cuda as duc
    from ..ops import fused_block_cuda as fbc
    from .sharded_io import restore_sharded, save_sharded

    model = build_model(p)
    if p.get("init") is not None:
        from ..convert import sharded_state_from_numpy

        sharded_state_from_numpy(p["init"], model)
    merges = [0]
    model.on_merge.append(replica_check(model, merges))
    fbc.launches = duc.launches = duc.commit_launches = 0
    _sync(model)
    t0 = time.perf_counter()
    for iters, thinning, total in p["steps"]:
        model.run_training(iters, thinning, total_iters=total)
    _sync(model)
    out: Dict[str, Any] = {
        "rank": model.mesh.rank, "coords": model.mesh.coords, "seconds": time.perf_counter() - t0,
        "launches": fbc.launches, "draw_launches": duc.launches,
        "commit_launches": duc.commit_launches, "merges_checked": merges[0],
        "invariants": count_invariants(model), "state": _host_state(model.state),
        "backend": model.mesh.backend, "device": str(model.device),
    }
    if p.get("estimators", True):
        out["pooled_phi"] = model.pooled_phi()
        out["mc_error"] = model.mc_error()
        out["chain_phis_shape"] = model.chain_phis().shape
    if p.get("test") is not None:
        docs, it, thinning, chain = p["test"]
        out["theta"] = model.run_test(docs, it, thinning, chain=chain)
    if p.get("resume") is not None:
        path, at = p["resume"]["path"], int(p["resume"]["at"])
        iters, thinning, total = p["steps"][0]
        first = build_model(p)
        first.run_training(at, thinning, total_iters=total or iters)
        save_sharded(path, first, iters_done=at)
        del first
        if p["resume"].get("wrong_kw") is not None:
            wrong = build_model(dict(p, kw=dict(p["kw"], **p["resume"]["wrong_kw"])))
            try:
                restore_sharded(path, wrong)
                out["wrong_restore"] = None
            except ValueError as e:
                out["wrong_restore"] = str(e)
        second = build_model(p)
        meta = restore_sharded(path, second)
        second.run_training(iters - at, thinning, total_iters=total or iters)
        out["resumed_state"] = _host_state(second.state)
        out["resumed_meta_iters"] = int(meta["iters_done"])
    return out


def block_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """One merge block (``M`` sweeps; dense: one AD-LDA step) from the
    global state ``init`` with the uniforms ``uniforms[(g, di, bucket)]``
    of global chain ``g`` on data shard ``di``; returns this rank's state."""
    from ..convert import sharded_state_from_numpy
    from ..ops.gibbs_fused import FusedBucketState, fused_train_block_buckets
    from .fused_sharded import merge_replicated
    from .sharded import local_chains, make_sharded_train_step
    from .vocab_sharded import vocab_block

    model = build_model(p)
    sharded_state_from_numpy(p["init"], model)
    L, g0 = local_chains(model.mesh, model.n_chains)
    di = model.mesh.coords[1]

    def mine(b):
        return torch.stack([torch.as_tensor(p["uniforms"][(g0 + j, di, b)], device=model.device)
                            for j in range(L)])

    st, M = model.state, int(p.get("M", 1))
    if model.sweep == "dense":
        step = make_sharded_train_step(model.mesh, model.n_chains, model.alpha, model.beta,
                                       model.topic_mask)
        st = step(st, model.corpus, False, uniforms=list(mine(0)))
    elif model.table_shard == "vocab":
        st = vocab_block(model.mesh, st, model.corpus, model.alpha, model.beta, M, model.V,
                         uniforms=mine(0))
    else:
        bucketed = isinstance(st.z, tuple)
        corpora = model.corpus if bucketed else (model.corpus,)
        out = fused_train_block_buckets(
            FusedBucketState(st.z if bucketed else (st.z,),
                             st.n_dk if bucketed else (st.n_dk,), st.n_vk, st.n_k),
            [c.tok_v_t for c in corpora], [c.tok_f_t for c in corpora],
            [c.lab_ids for c in corpora], [c.lab_valid_t for c in corpora], model.alpha,
            model.beta, M, uniforms=[mine(b) for b in range(len(corpora))],
            vbeta=float(model.V * model.beta))
        n_vk, n_k = merge_replicated(model.mesh, st.n_vk, st.n_k, out.n_vk, out.n_k)
        st = st._replace(z=out.z if bucketed else out.z[0],
                         n_dk=out.n_dk if bucketed else out.n_dk[0], n_vk=n_vk, n_k=n_k)
    return {"rank": model.mesh.rank, "coords": model.mesh.coords, "state": _host_state(st)}


def cli_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """The Labeled-LDA CLI's ``main(p["argv"])`` on this rank."""
    from ..cli.evaluate_labeled_lda import main

    res = main(p["argv"])
    return {"metrics": res.get("metrics"), "stats": res.get("stats"),
            "rank": int(torch.distributed.get_rank()) if torch.distributed.is_initialized()
            else 0}


def arrays_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """The layer functions on raw arrays ``(tok_v, tok_f, labs)`` (dense) or
    ``(tok_v, tok_f, lab_ids, lab_valid)`` (``layout="vocab"``): init from
    the per-chain generators of ``seed`` (dense: or the global state
    ``init``), then ``saves`` dense steps (one save flag each, with
    ``uniforms[(g, di, i)]`` for step ``i`` where given), or ``blocks`` vocab blocks of ``M`` sweeps (with
    ``uniforms[(g, di, i)]`` for block ``i`` where given), or, with
    ``loop=(iters, thinning)``, the vocab training loop and beside it the
    same blocks driven one by one from a fresh set of generators (``trace``
    keeps the state after each block)."""
    from .fused_sharded import shard_fused_corpus
    from .sharded import (init_sharded_state, local_chains, make_generators, make_mesh,
                          make_sharded_train_step, pooled_phi, shard_corpus)
    from .vocab_sharded import (init_vocab_chains, make_vocab_chains_train_loop,
                                make_vocab_sharded_block, vocab_rows)

    mc, nd = p["mesh"]
    mesh = make_mesh(n_data=nd, n_chains=mc, device=p.get("device"))
    C, V, K = p["n_chains"], p["V"], p["K"]
    alpha, beta = p.get("alpha", 0.1), p.get("beta", 0.01)
    gens = make_generators(mesh, C, p.get("seed", 0))
    L, g0 = local_chains(mesh, C)
    di = mesh.coords[1]
    out: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords}
    if p.get("layout", "dense") == "dense":
        corpus = shard_corpus(mesh, *p["arrays"])
        state = init_sharded_state(mesh, corpus, V, C, gens)
        if p.get("init") is not None:
            from ..convert import DENSE_AXES, local_state_from_global

            state = local_state_from_global(p["init"], state, mesh, C, DENSE_AXES)
        out["init"] = _host_state(state)
        step = make_sharded_train_step(mesh, C, alpha, beta)
        for i, save in enumerate(p["saves"]):
            u = None
            if p.get("uniforms") is not None:
                u = [torch.as_tensor(p["uniforms"][(g0 + j, di, i)], device=mesh.device)
                     for j in range(L)]
            state = step(state, corpus, save, generators=gens, uniforms=u)
        out["pooled_phi"] = pooled_phi(state, mesh, C).cpu().numpy()
    else:
        corpus = shard_fused_corpus(mesh, *p["arrays"])
        state = init_vocab_chains(mesh, corpus, V, K, C, gens)
        out["init"] = _host_state(state)
        out["rows"] = (vocab_rows(mesh, V).start, vocab_rows(mesh, V).stop)
        M = p.get("M", 1)
        block = make_vocab_sharded_block(mesh, alpha, beta, M, V)
        if p.get("loop") is not None:
            iters, thinning = p["loop"]
            loop = make_vocab_chains_train_loop(mesh, alpha, beta, V, K, None, corpus)
            looped = loop(state, iters, thinning, M, gens)
            out["looped"] = _host_state(looped)
            gens = make_generators(mesh, C, p.get("seed", 0))
            init_vocab_chains(mesh, corpus, V, K, C, gens)  # the same init draws
        for i in range(p.get("blocks", 0)):
            u = None
            if p.get("uniforms") is not None:
                u = torch.stack([torch.as_tensor(p["uniforms"][(g0 + j, di, i)],
                                                 device=mesh.device) for j in range(L)])
            state = block(state, corpus, generators=gens, uniforms=u)
            if p.get("trace"):
                out.setdefault("states", []).append(_host_state(state))
    out["state"] = _host_state(state)
    return out


def mesh_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """Meshes of the shapes ``p["shapes"]`` (``(n_chains, n_data)``, either
    may be ``None``), each with a check of its data-row sum, extremes and
    world sum on this rank's index; a shape the ranks cannot fill records
    its error."""
    from .bootstrap import make_global_mesh, world

    rank, size = world()
    out = []
    for mc, nd in p["shapes"]:
        try:
            mesh = make_global_mesh(n_chains=mc, n_data=nd, device=p.get("device"))
        except ValueError as e:
            out.append({"error": str(e)})
            continue
        x = torch.full((3,), float(rank), device=mesh.device)
        row = mesh.data_sum_(x.clone())
        hi = mesh.data_extreme_(x.clone(), "max")
        total = mesh.world_sum_(x.clone())
        out.append({"shape": dict(mesh.shape), "coords": mesh.coords,
                    "device": str(mesh.device),
                    "row_sum": float(row[0]), "row_max": float(hi[0]),
                    "world_sum": float(total[0])})
    return {"rank": rank, "size": size, "meshes": out}


def build_hslda(p: Dict[str, Any]):
    """The payload's ``DistributedHSLDA``: ``docs``, ``labs``, ``labelset``,
    ``mesh`` ``(mesh_chains, n_data)``, ``device`` and keywords ``kw``."""
    from .hslda_trainer import DistributedHSLDA
    from .sharded import make_mesh

    mc, nd = p.get("mesh", (1, 1))
    mesh = make_mesh(n_data=nd, n_chains=mc, device=p.get("device"))
    return DistributedHSLDA(p["docs"], p["labs"], p["labelset"], mesh=mesh,
                            **p.get("kw", {}))


def hslda_invariants(mesh, state, total: int, table_shard: str) -> Dict[str, Any]:
    """Global count invariants of every local chain of a ``HSLDAShardedState``:
    Σn_dk = Σn_vk = Σmask, no negative count, n_k = Σ_v n_vk (each summed
    over the data row where it is sharded)."""
    L = state.n_k.shape[0]
    ndk = mesh.data_sum_(state.n_dk.reshape(L, -1).sum(dim=1, dtype=torch.int64))
    vk = state.n_vk.reshape(L, -1).sum(dim=1, dtype=torch.int64)
    col = state.n_vk.sum(dim=1, dtype=torch.int32)
    if table_shard == "vocab":
        vk, col = mesh.data_sum_(vk), mesh.data_sum_(col)
    neg = torch.tensor([int(min(int(state.n_dk.min()), int(state.n_vk.min()),
                                int(state.n_k.min())) < 0)], device=state.n_k.device)
    mesh.data_extreme_(neg, "max")
    ok = (bool((ndk == total).all()) and bool((vk == total).all())
          and torch.equal(col, state.n_k) and not bool(neg.item()))
    return {"total": int(total), "n_dk": ndk.tolist(), "n_vk": vk.tolist(),
            "n_k_equal": bool(torch.equal(col, state.n_k)), "negative": bool(neg.item()),
            "ok": ok}


def hslda_replicas_equal(mesh, state, table_shard: str) -> bool:
    """Each chain's replicated arrays (n_k, η, β and, unless vocab-sharded,
    the table) are bitwise equal across the data row: the row's elementwise
    max and min equal the local copy."""
    arrays = [state.n_k, state.eta, state.beta]
    if table_shard != "vocab":
        arrays.append(state.n_vk)
    return all(torch.equal(mesh.data_extreme_(t.clone(), op), t)
               for t in arrays for op in ("max", "min"))


def hslda_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """Train the payload's ``DistributedHSLDA``: ``steps`` is a list of
    ``(it, thinning, opt, continue_avg)`` calls; after each, every chain's
    replicas must be equal across the data row.  ``test`` ``(docs, it, s)``
    scores documents after training; ``diagnostics`` reads the chain-0
    estimators; ``resume`` ``{"path", "at"}`` also runs
    the first step killed after ``at`` cycles (saved, then a fresh model
    restored from the checkpoint and trained on with ``continue_avg``; with
    ``wrong_kw``, first into a model built with those keywords, recording
    the refusal)."""
    from .sharded_io import restore_hslda_sharded, save_hslda_sharded

    model = build_hslda(p)
    mesh = model.mesh
    _sync(model)
    t0 = time.perf_counter()
    replicas, saves = [], []
    for it, thinning, opt, cont in p["steps"]:
        model.run_training(it, thinning, opt=opt, continue_avg=cont)
        replicas.append(hslda_replicas_equal(mesh, model.state, model.table_shard))
        saves.append(model._n_saves)
    _sync(model)
    out: Dict[str, Any] = {
        "rank": mesh.rank, "coords": mesh.coords, "seconds": time.perf_counter() - t0,
        "replicas_equal": replicas, "backend": mesh.backend, "device": str(model.device),
        "invariants": hslda_invariants(mesh, model.state, model.n_tokens, model.table_shard),
        "state": _host_state(model.state), "n_saves": model._n_saves,
        "cycles_done": model._cycles_done, "n_saves_by_step": saves,
        "ph_hat": None if model._ph_hat is None else model._ph_hat.cpu().numpy(),
    }
    if p.get("diagnostics"):
        out.update(get_ph=model.get_ph(), chain_ph=model._chain_ph(),
                   get_zbar=model.get_zbar(), topics=model.display_topics(n=3))
    if p.get("test") is not None:
        docs, it, s = p["test"]
        out["scores"] = model.run_tests(docs, it=it, s=s)
    if p.get("resume") is not None:
        path, at = p["resume"]["path"], int(p["resume"]["at"])
        it, thinning, opt, _ = p["steps"][0]
        first = build_hslda(p)
        first.run_training(at, thinning, opt=opt)
        save_hslda_sharded(path, first, iters_done=at)
        del first
        if p["resume"].get("wrong_kw") is not None:
            wrong = build_hslda(dict(p, kw=dict(p.get("kw", {}), **p["resume"]["wrong_kw"])))
            try:
                restore_hslda_sharded(path, wrong)
                out["wrong_restore"] = None
            except ValueError as e:
                out["wrong_restore"] = str(e)
        second = build_hslda(p)
        meta = restore_hslda_sharded(path, second)
        second.run_training(it - at, thinning, opt=opt, continue_avg=True)
        out["resumed_state"] = _host_state(second.state)
        out["resumed_ph_hat"] = (None if second._ph_hat is None
                                 else second._ph_hat.cpu().numpy())
        out["resumed_meta"] = {k: meta[k] for k in ("iters_done", "n_saves", "cycles_done")}
        out["resumed_gens"] = [g.get_state().numpy() for g in
                               second._gens.local + second._gens.chain]
        out["uninterrupted_gens"] = [g.get_state().numpy() for g in
                                     model._gens.local + model._gens.chain]
    return out


def hslda_arrays_job(p: Dict[str, Any]) -> Dict[str, Any]:
    """``parallel/hslda_sharded`` on raw arrays ``(tok_v, mask, labs)``: the
    init from the generators of ``seed`` (or the global state ``init``, JAX
    field names with ``beta``), then either one cycle with the noise
    ``noise[(g, di)]`` of global chain ``g`` on data shard ``di`` (a dict of
    ``z``, ``eta``, ``a``, ``m`` and the Gamma variates ``beta``; the cycle's
    ``mdot`` is returned too), or ``cycles`` steps, or the training ``loop``
    ``(iters, thinning)``.  ``table_shard``, ``D_total``, ``logs`` (the log
    Stirling table) and the hyperparameters ride along."""
    from ..convert import HSLDA_AXES, HSLDA_VOCAB_AXES, local_state_from_global
    from ..models.hslda import CycleNoise
    from .hslda_sharded import (init_hslda_sharded, make_hslda_generators,
                                make_hslda_train_loop, pooled_ph, shard_hslda_corpus)
    from .sharded import local_chains, make_mesh

    mc, nd = p["mesh"]
    mesh = make_mesh(n_data=nd, n_chains=mc, device=p.get("device"))
    C, V, K = p["n_chains"], p["V"], p["K"]
    shard = p.get("table_shard", "replicated")
    hyper = {k: p[k] for k in ("alpha", "aprime", "gamma", "mu", "sigma", "xi") if k in p}
    corpus = shard_hslda_corpus(mesh, *p["arrays"])
    gens = make_hslda_generators(mesh, C, p.get("seed", 0))
    state = init_hslda_sharded(mesh, corpus, V, K, C, gens, table_shard=shard,
                               **{k: hyper[k] for k in ("alpha", "aprime", "mu") if k in hyper})
    if p.get("init") is not None:
        state = local_state_from_global(p["init"], state, mesh, C,
                                        HSLDA_VOCAB_AXES if shard == "vocab" else HSLDA_AXES)
    out: Dict[str, Any] = {"rank": mesh.rank, "coords": mesh.coords, "init": _host_state(state)}
    logs = torch.as_tensor(p["logs"], dtype=torch.float32, device=mesh.device)
    loop = make_hslda_train_loop(mesh, corpus, C, logs, p["D_total"], opt=p.get("opt", 1),
                                 table_shard=shard, V=V, **hyper)
    L, g0 = local_chains(mesh, C)
    di = mesh.coords[1]
    if p.get("noise") is not None:
        def mine(name, axis=0):
            return torch.stack([torch.as_tensor(p["noise"][(g0 + j, di)][name],
                                                device=mesh.device) for j in range(L)], axis)

        noise = CycleNoise(z=mine("z", 1), eta=mine("eta"), a=mine("a"), m=mine("m"),
                           beta=mine("beta"))
        loop.load(state)
        loop.cycle(noise=noise)
        state = loop.state()
        out["mdot"] = loop.mdot.cpu().numpy()
    elif p.get("loop") is not None:
        iters, thinning = p["loop"]
        ph = torch.zeros((L, K, state.n_vk.shape[1]), dtype=torch.float32, device=mesh.device)
        state, ph, n_saves = loop(state, ph, 0, iters, thinning, gens)
        out.update(ph_hat=ph.cpu().numpy(), n_saves=n_saves)
    else:  # ``cycles`` cycles, none saved
        n = int(p.get("cycles", 0))
        state, _, _ = loop(state, None, 0, n, n + 1, gens)
    out["state"] = _host_state(state)
    out["invariants"] = hslda_invariants(mesh, state, int(np.asarray(p["arrays"][1]).sum()),
                                         shard)
    out["pooled_ph"] = pooled_ph(state, p.get("gamma", 1.0), V, mesh, C, shard).cpu().numpy()
    return out


def multi_job(p: Dict[str, Any]) -> list:
    """Several jobs in one spawn: ``p["jobs"]`` is a list of (name, payload)."""
    return [globals()[name](payload) for name, payload in p["jobs"]]
