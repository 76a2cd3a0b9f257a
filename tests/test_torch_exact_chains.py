"""The exact dense sweep over a leading chain axis, on the CPU.

The draw and commit steps (``draw_rows``, ``commit_counts`` and their plain
versions), ``exact_sweep`` and ``ExactSweep`` take state with a leading
chain axis: the chains share the corpus and the live lists, each reads and
writes its own table, and each must end exactly as a single-chain call on
its slices would.  ``ShardedTrainStep`` sweeps a rank's chains through one
such ``ExactSweep``; with three local chains on one rank it must equal JAX's
vmapped dense AD-LDA step.  The CUDA kernels are held to the same cases on
the card (``tests/test_torch_cuda.py``, ``chip_smoke.py`` phase 13).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel import make_sharded_train_step as j_make_step
from lda_thesis_tpu.parallel import shard_corpus as j_shard_corpus
from lda_thesis_tpu.parallel.sharded import init_sharded_state as j_init_sharded
from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.parallel import make_mesh, make_sharded_train_step, shard_corpus
from lda_thesis_tpu_torch.parallel.sharded import ShardedLDAState

ALPHA, BETA = 0.1, 0.01
V = 30


@pytest.mark.parametrize("route,C,K", [(r, C, K) for r in ("wrapper", "plain")
                                       for C in (1, 3) for K in (24, 40)])
def test_chain_axis_equals_single_chain_calls(route, C, K):
    """One sweep position (a commit, then a draw against the committed
    table) over a chain axis equals C single-chain positions, bitwise:
    through the wrappers (which take the plain versions on the CPU) or the
    plain versions.  The live list is ragged and holds a row with f = 0,
    which keeps its topic and counts; z and u are strided across chains."""
    t = chip_smoke.chain_step_inputs("cpu", 10 * C + K, C, 37, K, V)
    fns = ((duc.draw_rows, duc.commit_counts) if route == "wrapper"
           else (duc.draw_rows_torch, duc.commit_counts_torch))
    before = (duc.launches, duc.commit_launches)
    got = chip_smoke.chain_step(t, *fns, ALPHA, BETA, V * BETA)
    assert (duc.launches, duc.commit_launches) == before
    for c in range(C):
        want = chip_smoke.chain_step(t, duc.draw_rows_torch, duc.commit_counts_torch, ALPHA,
                                     BETA, V * BETA, c)
        assert all(torch.equal(g[c], w) for g, w in zip(got, want)), c
    z, n_dk, table, n_k = got
    assert torch.equal(z[:, 1], t["z_all"][:, 1, 1])  # row 1: f = 0
    assert torch.equal(n_dk[:, 1], t["n_dk"][:, 1])
    assert not torch.equal(z, t["z_all"][:, 1])
    assert torch.equal(n_k - t["n_k"], (table - t["table"]).sum(dim=1))
    assert (table >= 0).all() and (n_dk >= 0).all()


def _corpus(seed=0, D=26, U=7, K=12):
    rng = np.random.default_rng(seed)
    tok_v = torch.from_numpy(rng.integers(0, V, size=(D, U)))
    tok_f = torch.from_numpy(rng.integers(0, 4, size=(D, U)))
    tok_f[:, -1] = 0  # a position with no live row
    labs = torch.from_numpy((rng.random((D, K)) < 0.3).astype(np.float32))
    labs[:, 0] = 1.0
    return tok_v, tok_f, labs


def _states(tok_v, tok_f, labs, L):
    """L chains' position-major work state, each from its own init."""
    out = []
    for c in range(L):
        s = tgibbs.init_counts(tok_v, tok_f, labs, V,
                               generator=torch.Generator().manual_seed(40 + c))
        out.append((s.z.T.contiguous(), s.n_dk, s.n_vk, s.n_k))
    return out


@pytest.mark.parametrize("source", ["generators", "uniforms"])
def test_batched_exact_sweep_equals_single_chain_sweeps(source):
    """Three chains in one ExactSweep against three single-chain ExactSweeps,
    three sweeps: z and every count bitwise, from one generator per chain
    (drawn in chain order, as each single sweep draws) or given uniforms."""
    tok_v, tok_f, labs = _corpus()
    L = 3
    tv_t, tf_t = tok_v.T.contiguous(), tok_f.T.to(torch.float32).contiguous()
    states = _states(tok_v, tok_f, labs, L)
    singles = [[x.clone() for x in st] for st in states]
    batched = [torch.stack([st[i] for st in states]) for i in range(4)]
    args = (tv_t, tf_t, labs, ALPHA, BETA, V * BETA)
    run = tgibbs.ExactSweep(*batched, *args)
    runs = [tgibbs.ExactSweep(*st, *args) for st in singles]
    g_run = [torch.Generator().manual_seed(7 + c) for c in range(L)]
    g_ref = [torch.Generator().manual_seed(7 + c) for c in range(L)]
    u_gen = torch.Generator().manual_seed(5)
    before = (duc.launches, duc.commit_launches)
    for _ in range(3):
        if source == "generators":
            assert run(g_run) is run.z_t
            for r, g in zip(runs, g_ref):
                r(g)
        else:
            u = torch.rand((L,) + tuple(tv_t.shape), generator=u_gen)
            run(uniforms=u)
            for r, uc in zip(runs, u):
                r(uniforms=uc)
    assert (duc.launches, duc.commit_launches) == before
    assert run._graph is None and run.sweeps == 3
    for c in range(L):
        for got, want in zip(batched, singles[c]):
            assert torch.equal(got[c], want), c
    assert torch.equal(batched[3], batched[2].sum(dim=1))
    assert not torch.equal(batched[0][0], batched[0][1])
    with pytest.raises(ValueError, match="generators"):
        run(g_run[:2])


def _jax_dense_step(L=3):
    """JAX's init and two dense steps (the second saving) on a 1x1 mesh of
    ``L`` chains, and each step's uniforms rebuilt from its key as the
    vmapped ``train_sweep`` draws them."""
    tok_v, tok_f, labs = (x.numpy() for x in _corpus(seed=3, D=21, U=8, K=8))
    labs = labs.astype(np.float32)
    mesh = j_make_mesh(n_data=1, n_chains=1, devices=jax.devices()[:1])
    tv, tf, lb = j_shard_corpus(mesh, tok_v.astype(np.int32), tok_f.astype(np.int32), labs)
    init = j_init_sharded(jax.random.PRNGKey(2), mesh, tv, tf, lb, V, n_chains=L)
    step = j_make_step(mesh, L, alpha=0.3, beta=0.05)
    state, uniforms = init, []
    for i, save in enumerate((False, True)):
        k = jax.random.PRNGKey(20 + i)
        state = step(k, state, tv, tf, lb, save=jnp.bool_(save))
        uniforms.append(np.stack([np.asarray(jax.random.uniform(
            jax.random.fold_in(jax.random.fold_in(k, j), 0), tok_v.T.shape,
            dtype=jnp.float32)) for j in range(L)]))
    as_np = {f: np.asarray(getattr(init, f)) for f in ("z", "n_dk", "n_vk", "n_k",
                                                       "ph_hat", "th_hat")}
    want = {f: np.asarray(getattr(state, f)) for f in ("z", "n_dk", "n_vk", "n_k",
                                                       "ph_hat", "th_hat")}
    return (tok_v, tok_f, labs), as_np, uniforms, want


def test_sharded_step_with_three_local_chains_matches_jax():
    """``ShardedTrainStep`` with L = 3 chains on one CPU rank, one
    ExactSweep for all three, from JAX's init with JAX's uniforms: z and
    the counts exactly JAX's vmapped step's after two steps; φ̂ and θ̂ of
    the save within float32 rounding (rtol 1e-6, as the port's other
    estimator comparisons with JAX)."""
    arrays, init, uniforms, want = _jax_dense_step()
    mesh = make_mesh(n_data=1, n_chains=1, device="cpu")
    corpus = shard_corpus(mesh, *arrays)
    state = ShardedLDAState(**{f: torch.tensor(x) for f, x in init.items()}, s=0)
    step = make_sharded_train_step(mesh, 3, alpha=0.3, beta=0.05)
    state = step(state, corpus, False, uniforms=list(torch.as_tensor(uniforms[0])))
    sweep = step._sweep
    state = step(state, corpus, True, uniforms=torch.as_tensor(uniforms[1]))
    assert step._sweep is sweep and sweep.sweeps == 2 and sweep.z_t.shape[0] == 3
    for f in ("z", "n_dk", "n_vk", "n_k"):
        np.testing.assert_array_equal(getattr(state, f).numpy(), want[f], err_msg=f)
    for f in ("ph_hat", "th_hat"):
        np.testing.assert_allclose(getattr(state, f).numpy(), want[f], rtol=1e-6, err_msg=f)
    assert state.s == 1
