"""HSLDA's training loop as replayed graphs: the cycle runner and the saves.

``models/hslda.CycleStep`` runs a blocked-Gibbs cycle (the z-sweep, z̄, η,
a, m and mdot) as one body, on a card one replayed CUDA graph per coupling,
with the draws filled outside it in the eager order and β's Gammas drawn
after it; ``HSLDA`` and a rank's ``HSLDAShardedLoop`` (data axis 1,
replicated table) keep it and an ``ops/gibbs.SaveStep`` for φ̂/z̄ across
their training calls.  Here, on the CPU, the runner is held bit for bit to
``_train_cycle`` for every coupling form, a batched runner to single-chain
ones, the hoisted fills to the blocks' own draws, and the runner with JAX's
recorded noise to JAX's ``_train_cycle`` within ``tests/test_torch_hslda.py``'s
tolerances; each model's training calls to ``chip_smoke``'s eager loop and
to one uninterrupted call; a checkpoint restore, a resumed chunked run and a
pickle between two calls to the uninterrupted run; a state of another shape
is refused; the saves to chained ``running_average`` and JAX's traced save
index; and the sharded loop's runner to its eager cycle.  The replay rule
runs through ``tests/test_torch_save_graphs.py``'s stand-in graphs, so a
model's second call shows no capture and no eager body.
"""

import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from lda_thesis_tpu_torch.models import hslda as thslda
from lda_thesis_tpu_torch.models.hslda import HSLDA, CycleNoise, CycleStep
from lda_thesis_tpu_torch.models.state import running_average
from lda_thesis_tpu_torch.ops.hslda_gibbs import HSLDACounts, fill_gumbels
from lda_thesis_tpu_torch.parallel import DistributedHSLDA, make_mesh
from lda_thesis_tpu_torch.parallel.hslda_sharded import (
    init_hslda_sharded,
    make_hslda_generators,
    make_hslda_train_loop,
    shard_hslda_corpus,
)
from lda_thesis_tpu_torch.parallel.sharded_io import restore_hslda_sharded, save_hslda_sharded
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, restore_model, save_model
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs
from test_torch_hslda import T, _port_from, _reflected_cdf, jax_cycle, jel, jm  # noqa: F401
from test_torch_save_graphs import graphed  # noqa: F401  (a fixture)

K = 8
# the coupling forms: (opt, compact positive labels)
FORMS = {"opt1": (1, False), "opt2-sparse": (2, True), "opt2-blockwise": (2, False),
         "opt3": (3, False)}
PROBLEM = chip_smoke.hslda_small_problem(4)  # D = 64, L = 12, N = 32


def _same(a, b):
    return chip_smoke._bitwise(list(a), list(b))


def _model(seed=0, **kw):
    return HSLDA(*PROBLEM, k=K, seed=seed, device="cpu", **kw)


def _chains(n_chains=3, seed=0):
    return DistributedHSLDA(*PROBLEM, mesh=make_mesh(device="cpu"), n_chains=n_chains, k=K,
                            seed=seed)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _runner(m, sparse, state=None):
    """A ``CycleStep`` over copies of ``m``'s state (or ``state``: counts,
    η, a, β, with or without a chain axis)."""
    c, eta, a, beta = state or (m.counts, m.eta, m.a, m.beta)
    z = c.z if c.z.dim() == 3 else c.z[None]  # (C, D, N)
    z_t = z.permute(2, 0, 1).reshape(z.shape[2], -1)
    pos = dict(lab_pos_ids=m._lab_pos_ids, lab_pos_valid=m._lab_pos_valid) if sparse else {}
    return CycleStep(z_t.contiguous(), c.n_dk.clone(), c.n_vk.clone(), c.n_k.clone(), m.tok_v,
                     m.mask, m.labs, eta, a, beta, m._stirling_logs, m.mu, m.sigma, m.aprime,
                     m.alpha, m.gamma, m.xi, m.V, **pos)


def _runner_state(run):
    z_t, n_dk, n_vk, n_k = run.state
    C, D, _ = n_dk.shape
    z = z_t.view(-1, C, D).permute(1, 2, 0)
    out = [z, n_dk, n_vk, n_k, run.eta, run.a, run.beta]
    return [t[0] for t in out] if run.single else out


# ------------------------------------------------------------ the runner


@pytest.mark.parametrize("form", list(FORMS))
def test_cycle_runner_equals_train_cycle(form):
    """Four cycles of a ``CycleStep`` from one generator equal four
    ``_train_cycle`` calls from a copy of it, bit for bit: z, the counts,
    η, a, β and the generator's state."""
    opt, sparse = FORMS[form]
    m = _model(seed=1)
    run = _runner(m, sparse)
    pos = dict(lab_pos_ids=m._lab_pos_ids, lab_pos_valid=m._lab_pos_valid) if sparse else {}
    g_run, g_eager = _gen(5), _gen(5)
    counts, eta, a, beta = m.counts, m.eta, m.a, m.beta
    for _ in range(4):
        run(opt, g_run)
        counts, eta, a, beta, _, _ = thslda._train_cycle(
            counts, m.tok_v, m.mask, m.labs, eta, a, beta, m._stirling_logs, m.mu, m.sigma,
            m.aprime, m.alpha, m.gamma, m.xi, opt, generator=g_eager, **pos)
    assert _same(_runner_state(run), [*counts, eta, a, beta])
    assert torch.equal(g_run.get_state(), g_eager.get_state())
    assert run.calls == 4 and run._key_calls == {opt: 4}


@pytest.mark.parametrize("form", list(FORMS))
def test_batched_runner_equals_single_chain_runners(form):
    """A runner over three chains (the blocks over the chain axis), each
    chain drawing from its own generator, equals three single-chain
    runners (the blocks without the axis) bit for bit, every cycle."""
    opt, sparse = FORMS[form]
    ms = [_model(seed=s) for s in range(3)]
    stacked = HSLDACounts(*(torch.stack([getattr(m.counts, f) for m in ms])
                            for f in HSLDACounts._fields))
    batched = _runner(ms[0], sparse, (stacked, *(torch.stack([getattr(m, f) for m in ms])
                                                 for f in ("eta", "a", "beta"))))
    singles = [_runner(m, sparse) for m in ms]
    gens, single_gens = [_gen(10 + c) for c in range(3)], [_gen(10 + c) for c in range(3)]
    for _ in range(3):
        batched(opt, gens)
        for run, g in zip(singles, single_gens):
            run(opt, g)
        for c, run in enumerate(singles):
            assert _same([t[c] for t in _runner_state(batched)], _runner_state(run)), c
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in zip(gens, single_gens))


@pytest.mark.parametrize("layout", ["single", "chains", "chains-one-generator"])
def test_hoisted_fills_equal_in_function_draws(layout):
    """``CycleStep.fill``'s buffers (``fill_gumbels``, ``torch.randn(out=)``,
    ``open_uniforms(out=)``, ``gumbel(out=)``) hold the numbers that the
    blocks draw themselves from a generator (``eta_draw``, ``a_block``,
    ``antoniak_draw``), in the same order: each block gives the same bits
    from either, and the generators end in one state."""
    m = _model(seed=2)
    C = 1 if layout == "single" else 3
    if C == 1:
        run = _runner(m, False)
    else:
        st = HSLDACounts(*(torch.stack([t] * C) for t in m.counts))
        run = _runner(m, False, (st, *(torch.stack([t] * C) for t in (m.eta, m.a, m.beta))))

    def gens(seed):
        return _gen(seed) if layout != "chains" else [_gen(seed + c) for c in range(C)]

    filled, drawn = gens(7), gens(7)
    run.fill(filled)
    v = run._v
    fill_gumbels(torch.empty_like(run.g_z), drawn)
    n_dk = v(run.state[1])
    zbar = n_dk.to(torch.float32) / run._n_d[:, None]
    eta_a, eta_b = (thslda.eta_block(zbar, v(run.a), m.mu, m.sigma, normals=v(run.g_eta)),
                    thslda.eta_block(zbar, v(run.a), m.mu, m.sigma, generator=drawn))
    a_a, a_b = (thslda.a_block(zbar, eta_a, m.labs, v(run.u_a))[0],
                thslda.a_block(zbar, eta_a, m.labs, generator=drawn)[0])
    m_a, m_b = (thslda.antoniak_draw(n_dk, m.alpha, v(run.beta), m._stirling_logs, v(run.g_m)),
                thslda.antoniak_draw(n_dk, m.alpha, v(run.beta), m._stirling_logs,
                                     generator=drawn))
    assert _same([eta_a, a_a, m_a], [eta_b, a_b, m_b])
    pairs = [(filled, drawn)] if isinstance(filled, torch.Generator) else zip(filled, drawn)
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in pairs)


@pytest.mark.parametrize("chains", [0, 2])
def test_runner_with_jax_noise_matches_jax_cycle(jm, jel, jax_cycle, chains):  # noqa: F811
    """The runner fed the noise that JAX's ``_train_cycle`` drew equals JAX's
    cycle within ``tests/test_torch_hslda.py``'s tolerances (z and counts
    exact, η 1e-5, β 1e-6, a 1e-6 in reflected CDF); with a chain axis,
    every chain of two copies of the state does."""
    (z, n_dk, n_vk, n_k, eta, a, beta, _, mean_a), noise, beta_draws, _ = jax_cycle
    m = _port_from(jm, jel)
    rep = (lambda x: torch.stack([x] * chains)) if chains else (lambda x: x)
    state = (HSLDACounts(*(rep(t) for t in m.counts)), rep(m.eta), rep(m.a), rep(m.beta))
    run = _runner(m, False, state)
    run(1, noise=CycleNoise(z=rep(T(noise["z"])).transpose(0, 1) if chains else T(noise["z"]),
                            eta=rep(T(noise["eta"])), a=rep(T(noise["a"])), m=rep(T(noise["m"])),
                            beta=lambda conc: rep(beta_draws(conc[0] if chains else conc))))
    got = _runner_state(run)
    flip = np.asarray(jm.labs) > 0
    for c in range(max(chains, 1)):
        pick = (lambda t: t[c]) if chains else (lambda t: t)
        for g, w in zip(got[:4], (z, n_dk, n_vk, n_k)):
            np.testing.assert_array_equal(pick(g).numpy(), w)
        np.testing.assert_allclose(pick(got[4]).numpy(), eta, rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(pick(got[6]).numpy(), beta, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(_reflected_cdf(pick(got[5]).numpy(), mean_a, flip),
                                   _reflected_cdf(a, mean_a, flip), rtol=0, atol=1e-6)


# ------------------------------------------------------- the models' calls


KINDS = ["opt1", "opt2", "opt3", "chains-opt1", "chains-opt3"]


def _kind(kind, seed=0):
    opt = int(kind[-1])
    return (_chains(seed=seed) if kind.startswith("chains") else _model(seed=seed)), opt


@pytest.mark.parametrize("kind", KINDS)
def test_two_calls_equal_eager_loop_and_one_call(graphed, kind):  # noqa: F811
    """Two ``run_training(7, 3)`` calls (the second with ``continue_avg``)
    each equal ``chip_smoke.eager_hslda_training`` from the state before
    it, bit for bit (z, counts, η, a, β, the means, the save count and the
    generators); together they equal one uninterrupted 14-cycle call in
    state and generators (the saves draw nothing).  The first call captures
    the cycle and save graphs, the second captures none and runs no body
    eagerly."""
    m, opt = _kind(kind)
    added = []
    for first in (True, False):
        want = chip_smoke.eager_hslda_training(m, 7, 3, opt, continue_avg=not first)
        before = chip_smoke.replay_counts(m)
        m.run_training(7, 3, opt=opt, continue_avg=not first)
        added.append([a - b for a, b in zip(chip_smoke.replay_counts(m), before)])
        assert chip_smoke.hslda_training_equal(m, want)
    assert added == [[2, 2], [0, 0]]
    one, _ = _kind(kind)
    one.run_training(14, 3, opt=opt)
    if kind.startswith("chains"):
        assert _same(m.state, one.state) and m._n_saves == 4
        gens = zip(m._gens.local + m._gens.chain, one._gens.local + one._gens.chain)
    else:
        assert _same([*m.counts, m.eta, m.a, m.beta], [*one.counts, one.eta, one.a, one.beta])
        assert m._avg_s == 4 and m.eta is m._cycle.params[0]
        gens = [(m._gen, one._gen)]
    assert all(torch.equal(a.get_state(), b.get_state()) for a, b in gens)


def test_cycle_steps_keep_one_runner_per_model(graphed):  # noqa: F811
    """``train_cycle`` and ``run_training`` share the model's one runner (one
    graph per coupling); ``z_sweep`` still gives a sweep runner of its own."""
    m = _model()
    m.train_cycle(1)
    m.train_cycle(1)
    run = m._cycle
    m.run_training(4, 2, opt=1, continue_avg=True)
    m.run_training(2, 2, opt=3)
    assert m._cycle is run and sorted(run._graphs) == [1, 3]
    assert run._key_calls == {1: 6, 3: 2} and m._cycles_done == 8
    sweep = m.z_sweep(1)
    sweep(m.eta, m.a, m.alpha * m.beta, generator=m._gen)
    assert sweep.sweeps == 1 and sweep.state[0] is m._z_t


def _train(m, first, it=6):
    m.run_training(it, 3, opt=1, continue_avg=not first)


@pytest.mark.parametrize("case", ["checkpoint", "resumed-chunks", "pickle", "converted"])
def test_replaced_state_keeps_the_bits(tmp_path, graphed, case):  # noqa: F811
    """Between two calls, a state from elsewhere is copied into the model's
    kept runners and the run equals the uninterrupted one bit for bit: a
    checkpoint restored into a model whose runners hold another chain, a
    resumed chunked run of ``utils/elastic.py``, a pickled model (its
    runners dropped) and the arrays loaded by ``convert``."""
    ref = _model()
    for first in (True, False, False):
        _train(ref, first)
    m1 = _model()
    _train(m1, True)
    ckpt = str(tmp_path / "ck")
    save_model(ckpt, m1, extra_meta={"iters_done": 6})
    if case == "pickle":
        m2 = pickle.loads(pickle.dumps(m1))
        assert m2._cycle is None and m2._save is None
    else:
        m2 = _model(seed=99)
        _train(m2, True)  # its runners hold another chain
        run, save = m2._cycle, m2._save
        if case == "checkpoint":
            restore_model(ckpt, m2)
        elif case == "converted":
            from lda_thesis_tpu_torch.convert import hslda_state_from_numpy

            hslda_state_from_numpy(load_checkpoint(ckpt)[0], m2)
            m2._avg_s = m1._avg_s
            m2._gen.set_state(m1._gen.get_state())
        else:
            eg = ElasticGibbs(m2, ckpt, resume=True)
            assert eg.iters == 6
        assert m2.eta is not run.params[0] and m2.ph is not m2._means[0]
    if case == "resumed-chunks":
        eg.run(18, 3, save_every=6)
        assert load_checkpoint(ckpt)[1]["iters_done"] == 18
    else:
        _train(m2, False)
        _train(m2, False)
    if case != "pickle":
        assert m2._cycle is run and m2._save is save
    assert m2.eta is m2._cycle.params[0] and m2.beta is m2._cycle.params[2]
    assert _same([*m2.counts, m2.eta, m2.a, m2.beta], [*ref.counts, ref.eta, ref.a, ref.beta])
    assert np.array_equal(m2.ph, ref.ph) and np.array_equal(m2.th, ref.th)
    assert m2._avg_s == ref._avg_s and torch.equal(m2._gen.get_state(), ref._gen.get_state())


@pytest.mark.parametrize("case", ["counts", "eta", "beta", "means", "loop-eta"])
def test_state_of_another_shape_is_refused(case):
    """A kept runner never replays stale addresses: counts, η, β or means of
    another shape are refused, in the model and in a rank's loop."""
    m = _model()
    m.run_training(3, 3)
    with pytest.raises(ValueError, match="must keep the shape"):
        if case == "counts":
            m.counts = m.counts._replace(n_vk=m.counts.n_vk[:-1])
        elif case == "means":
            m.ph = m.ph[:, :-1]
            m.run_training(3, 3, continue_avg=True)
        elif case == "loop-eta":
            c = _chains()
            c.run_training(3, 3)
            c.state = c.state._replace(eta=c.state.eta[:, :-1])
            c.run_training(3, 3)
        else:
            setattr(m, case, getattr(m, case)[..., :-1])
            m.run_training(3, 3)


def test_pickled_chains_model_drops_graphs_and_keeps_bits(graphed):  # noqa: F811
    """A one-rank ``DistributedHSLDA`` pickles without its loops (so without
    graphs) and trains on with the bits of the model it came from."""
    m = _chains()
    m.run_training(6, 3)
    clone = pickle.loads(pickle.dumps(m))
    assert clone._loops == {} and m._loops[1]._run._graphs
    for x in (m, clone):
        x.run_training(6, 3, continue_avg=True)
    assert _same(m.state, clone.state) and _same([m._ph_hat], [clone._ph_hat])
    assert clone._loops[1]._run._graphs and chip_smoke.replay_counts(clone) == (2, 2)


def test_sharded_checkpoint_between_calls_keeps_bits(tmp_path, graphed):  # noqa: F811
    """A ``DistributedHSLDA`` restored from its sharded checkpoint into a
    model whose loop holds another chain trains on with the uninterrupted
    run's bits (state, φ̂ mean, generators)."""
    ref = _chains()
    ref.run_training(6, 3)
    save_hslda_sharded(str(tmp_path / "s"), ref, iters_done=6)
    ref.run_training(6, 3, continue_avg=True)
    m = _chains(seed=5)
    m.run_training(6, 3)
    loop = m._loops[1]
    restore_hslda_sharded(str(tmp_path / "s"), m)
    m.run_training(6, 3, continue_avg=True)
    assert m._loops[1] is loop and m._ph_hat is loop._saves.ph_hat
    assert _same(m.state, ref.state) and _same([m._ph_hat], [ref._ph_hat])
    assert all(torch.equal(a.get_state(), b.get_state())
               for a, b in zip(m._gens.local + m._gens.chain, ref._gens.local + ref._gens.chain))


# -------------------------------------------------------------- the saves


def test_saves_equal_chained_running_average(graphed):  # noqa: F811
    """An ``HSLDA``'s saves s = 1 … 5 (a cycle between them) equal its
    estimates chained through ``running_average``, bit for bit, after each
    call; the save runner is one graph."""
    m = _model()
    ph, th = torch.zeros((m.K, m.V)), torch.zeros((m.D, m.K))
    for s in range(1, 6):
        m.run_training(1, 1, continue_avg=s > 1)
        cur_ph, (cur_th,) = m._estimates()
        ph, th = running_average(ph, cur_ph, s), running_average(th, cur_th, s)
        assert np.array_equal(m.ph, ph.numpy()) and np.array_equal(m.th, th.numpy())
        assert m._avg_s == s
    assert list(m._save._graphs) == [False] and m._save._key_calls == {False: 5}


@pytest.mark.parametrize("chains", [0, 3])
def test_saves_match_jax_traced_save_index(graphed, chains):  # noqa: F811
    """The means of an ``HSLDA``'s (and a rank's per-chain φ̂) saves equal
    ``_train_loop_hslda``'s save form with a traced save index (``f =
    s.astype(float32)``, ``where(f <= 1, cur, (f−1)/f·avg + cur/f)``,
    jitted) on the same estimates within float32 rounding (rtol 1e-6)."""
    @jax.jit
    def save(avg, cur, s):
        f = s.astype(jnp.float32)
        return jnp.where(f <= 1.0, cur, (f - 1.0) / f * avg + cur / f)

    m = _chains(chains) if chains else _model()
    avg = None
    for s in range(1, 7):
        m.run_training(2, 2, continue_avg=s > 1)
        if chains:
            loop = m._loops[1]
            curs, got = [loop._estimates()[0]], [m._ph_hat]
        else:
            cur_ph, (cur_th,) = m._estimates()
            curs, got = [cur_ph, cur_th], [torch.from_numpy(m.ph), torch.from_numpy(m.th)]
        curs = [jnp.asarray(c.numpy()) for c in curs]
        avg = [save(a, c, jnp.int32(s)) for a, c in zip(avg or [jnp.zeros_like(c) for c in curs],
                                                          curs)]
        for g, w in zip(got, avg):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# ---------------------------------------------------- the sharded loop


def _loop_pair(opt):
    """One rank's corpus, generators and initial state at data axis 1, and
    two loops over it: the replicated table's (the cycle runner) and the
    vocab-sharded one's, which on one data shard runs the eager cycle with
    the same chains."""
    mesh = make_mesh(device="cpu")
    m = _model()
    corpus = shard_hslda_corpus(mesh, m.tok_v.numpy(), m.mask.numpy(), m.labs.numpy())

    def init():
        gens = make_hslda_generators(mesh, 3, 11)
        return gens, init_hslda_sharded(mesh, corpus, m.V, K, 3, gens)

    loops = [make_hslda_train_loop(mesh, corpus, 3, m._stirling_logs, m.D, opt=opt,
                                   table_shard=shard, V=m.V)
             for shard in ("replicated", "vocab")]
    return loops, init


@pytest.mark.parametrize("opt", [1, 2, 3])
def test_sharded_loop_runner_equals_its_eager_cycle(opt):
    """At data axis 1 the loop's cycle runner and saves equal the eager
    cycle around ``HSLDASweep`` bit for bit (state, per-chain φ̂ mean, save
    count, generators), over two calls; ``mdot`` too."""
    (run, eager), init = _loop_pair(opt)
    assert run._run is None and eager._run is None  # made at the first load
    outs = []
    for loop in (run, eager):
        gens, st = init()
        ph, n = None, 0
        for _ in range(2):
            st, ph, n = loop(st, torch.zeros((3, K, st.n_vk.shape[1])) if ph is None else ph,
                             n, 5, 2, gens)
        outs.append((st, ph, n, [g.get_state() for g in gens.local + gens.chain], loop.mdot))
    (a, b) = outs
    assert run._run is not None and eager._run is None and eager._sweep is not None
    assert _same(a[0], b[0]) and _same([a[1]], [b[1]]) and a[2] == b[2] == 4
    assert all(torch.equal(x, y) for x, y in zip(a[3], b[3])) and _same([a[4]], [b[4]])
    assert a[1] is run._saves.ph_hat and a[0].eta is not run._run.eta


def test_chip_smoke_chain_runners_case():
    """``chip_smoke.hslda_chain_runners_case`` (phase 14a) on the CPU: a
    3-chain call equals the eager loop, and the batched chains equal three
    single-chain runners bit for bit."""
    r = chip_smoke.hslda_chain_runners_case("cpu", *PROBLEM, seed=0, C=3, iters=4, thinning=2,
                                            k=K)
    assert r["equal"] and r["singles_bitwise"] and r["equal_draws"] == 1.0
