"""The training loops' save step and the exact runners kept across calls.

``ops/gibbs.SaveStep`` runs a save (φ̂/θ̂ estimates, the thinned means with
the save index in device scalars, the perplexity) as one body, on a card one
replayed CUDA graph; ``ops/gibbs.ExactBuckets`` keeps a model's exact sweeps
(dense and compact) and their static state across its training calls.  Here,
on the CPU, the save runner is held bit for bit to the chained eager
estimators and ``running_average`` (its weights against JAX's traced save
index within float32 rounding); each model's training calls to
``chip_smoke``'s eager loops and to one uninterrupted call; a checkpoint
restore, a resumed chunked run and a pickle between two calls to the
uninterrupted run, the runners kept; a mismatched state is refused; and
every chain's save over the chain axis to per-chain saves.  The replay rule
runs through a stand-in graph that replays the captured body, so a model's
second call shows no capture and no eager body.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from lda_thesis_tpu.models import state as jstate
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.models import state as tstate
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
from lda_thesis_tpu_torch.models.local_lda import LocalLDA
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.ops.gibbs_fused import theta_from_fused
from lda_thesis_tpu_torch.parallel import make_mesh
from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, restore_model, save_model
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs

ALPHA, BETA = 0.1, 0.01
SMALL = dict(n_train=40, n_test=8, V=200, max_types=20, mean_types=8)
KINDS = ["labeled-fused", "labeled-compact", "labeled-dense", "local-fused", "local-dense"]


class _StandIn:
    """A captured body: a CUDA capture runs nothing, and each replay runs
    the body again on the runner's static buffers."""

    def __init__(self, fn):
        self._fn = fn

    def replay(self):
        self._fn()


@pytest.fixture
def graphed(monkeypatch):
    """Runners made inside follow the card's replay rule, with stand-in
    graphs: each key's first call eager, the second captured, later ones
    replayed."""
    real = tgibbs._Replayed.__init__

    def init(self, device):
        real(self, device)
        self._graphed = True

    monkeypatch.setattr(tgibbs._Replayed, "__init__", init)
    monkeypatch.setattr(tgibbs, "capture_graph", lambda fn, device: _StandIn(fn))


def _same(a, b):
    return chip_smoke._bitwise(a, b)


def _labeled(sweep="fused", seed=0):
    c = planted_corpus(2, **SMALL)
    return LabeledLDA(c.train_docs, c.train_labs, c.labelset, Dictionary(c.train_docs),
                      ALPHA, BETA, seed=seed, sweep=sweep, device="cpu")


def _local(sweep="fused", seed=0, K=5):
    c = planted_corpus(2, **SMALL)
    texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) + "." for d in c.train_docs]
    return LocalLDA(texts, alpha=ALPHA, beta=BETA, K=K, seed=seed, sweep=sweep, device="cpu")


def _model(kind, seed=0):
    family, sweep = kind.split("-")
    return (_labeled if family == "labeled" else _local)(sweep, seed=seed)


# ------------------------------------------------------- the running average


@pytest.mark.parametrize("shape", [(7, 9), (3, 5, 4)])
def test_running_average_matches_jax_traced_save_index(shape):
    """``running_average`` with its weights in device scalars against JAX's
    with a traced ``s`` (the jitted function), s = 1 … 6: within float32
    rounding (rtol 1e-6), as the port's other estimators against JAX; the
    in-place form gives its bits."""
    rng = np.random.default_rng(5)
    avg_j = jnp.zeros(shape, jnp.float32)
    avg_t = torch.zeros(shape)
    jitted = jax.jit(jstate.running_average)
    for s in range(1, 7):
        cur = rng.random(shape).astype(np.float32)
        avg_j = jitted(avg_j, jnp.asarray(cur), jnp.int32(s))
        w = tstate.AverageWeights("cpu", s)
        in_place = avg_t.clone()
        assert tstate.running_average_(in_place, torch.from_numpy(cur), w) is in_place
        avg_t = tstate.running_average(avg_t, torch.from_numpy(cur), s)
        assert _same([in_place], [avg_t])
        np.testing.assert_allclose(avg_t.numpy(), np.asarray(avg_j), rtol=1e-6)


@pytest.mark.parametrize("s", [1, 2, 3, 7, 50])
def test_average_weights_are_float32_host_weights(s):
    """The device scalars hold ``(s−1)/s`` and ``1/s`` rounded to float32 on
    the host, and ``first`` is ``s <= 1``; ``set`` refills them in place."""
    w = tstate.AverageWeights("cpu", 99)
    first, keep, rinv = w.first, w.keep, w.rinv
    w.set(s)
    s32 = np.float32(s)
    assert w.first is first and w.keep is keep and w.rinv is rinv
    assert bool(first) == (s <= 1) and keep.dtype == rinv.dtype == torch.float32
    assert keep.item() == float((s32 - np.float32(1)) / s32)
    assert rinv.item() == float(np.float32(1) / s32)


# ------------------------------------------------------------- the save step


@pytest.mark.parametrize("perplexity", [False, True])
@pytest.mark.parametrize("sweep", ["fused", "compact", "dense"])
def test_save_step_equals_chained_eager_saves(graphed, sweep, perplexity):
    """Saves s = 1 … 5 of a ``SaveStep`` over a model's estimates (its θ in
    the sampler's form: ``theta_from_fused``, ``theta_from_compact`` or
    ``theta_from_counts``), a training sweep between saves, against the
    chained eager estimators and ``running_average``: the means and the
    perplexity bit for bit after each.  The first save runs eagerly, the
    second captures, the rest replay: one graph."""
    m = _labeled(sweep)
    m.run_training(2, 1, perplexity=False)  # the model's runners, its state moved on
    run = tgibbs.SaveStep(torch.zeros_like(m.ph_hat), [torch.zeros_like(t)
                                                       for t in m._th_hat_t])
    ph, th = torch.zeros_like(m.ph_hat), [torch.zeros_like(t) for t in m._th_hat_t]
    loglik = m._perplexity_of if perplexity else None
    for s in range(1, 6):
        m.run_training(1, 2, perplexity=False, continue_avg=True)  # one sweep, no save
        cur_ph, cur_th = m._cur_estimates()
        ph = tstate.running_average(ph, cur_ph, s)
        th = [tstate.running_average(t, c, s) for t, c in zip(th, cur_th)]
        got = run(s, m._cur_estimates, loglik)
        assert _same([run.ph_hat, *run.th_hat], [ph, *th])
        if perplexity:
            want = tgibbs.training_perplexity(cur_ph, cur_th, m._ll_toks)
            assert got is run.perplexity and _same([got], [want])
            ll = sum(float(tgibbs.log_likelihood(t, cur_ph, tv, tf)[0])
                     for t, tv, tf in zip(cur_th, m.toks_v, m.toks_f))
            assert np.isclose(float(got), np.exp(-ll / m.n_tokens), rtol=1e-5)
        else:
            assert got is None
    assert list(run._graphs) == [perplexity] and run._key_calls == {perplexity: 5}


def test_save_step_refuses_other_means_and_pickles_without_graphs(graphed):
    """``holds``/``load`` take in means set from elsewhere by identity and
    copy; means of another shape are refused; a pickled runner drops its
    graph and saves with the same bits."""
    ph, th = torch.rand(6, 4), [torch.rand(3, 4), torch.rand(2, 4)]
    run = tgibbs.SaveStep(ph, th)
    assert not run.holds(ph, th) and run.holds(run.ph_hat, run.th_hat)
    cur = (torch.rand(6, 4), (torch.rand(3, 4), torch.rand(2, 4)))
    for s in (1, 2, 3):
        run(s, lambda: cur)
    clone = pickle.loads(pickle.dumps(run))
    assert clone._graphs == {} and run._graphs and _same([clone.ph_hat], [run.ph_hat])
    run(4, lambda: cur)
    clone(4, lambda: cur)
    assert _same([clone.ph_hat, *clone.th_hat], [run.ph_hat, *run.th_hat])
    run.load(ph, th)
    assert _same([run.ph_hat, *run.th_hat], [ph, *th])
    with pytest.raises(ValueError, match="must keep the shape"):
        run.load(torch.rand(5, 4), th)
    with pytest.raises(ValueError):
        run.load(ph, th[:1])


# -------------------------------------------------------- the models' calls


@pytest.mark.parametrize("kind", KINDS)
def test_two_calls_equal_eager_loop_and_one_call(graphed, kind):
    """Two training calls of each model (a ``LabeledLDA``'s second with
    ``continue_avg``) equal ``chip_smoke.eager_training`` from the state
    before each, bit for bit (z, counts, means, perplexities, generator),
    and together one uninterrupted call of their sweeps; the second call
    captures no graph and runs no body eagerly."""
    labeled = kind.startswith("labeled")
    iters, thinning, total = 8, 4, 16

    def train(m, n, first):
        if labeled:
            m.run_training(n, thinning, continue_avg=not first, total_iters=total)
        else:
            m.run_training(n, thinning, total_iters=total)

    m = _model(kind)
    for first in (True, False):
        before = len(getattr(m, "cur_perplx", ()))
        want = chip_smoke.eager_training(m, iters, thinning, total, labeled,
                                         continue_avg=not first)
        counts = chip_smoke.replay_counts(m)
        train(m, iters, first)
        assert chip_smoke.training_equal(m, want, before)
        if not first:
            assert chip_smoke.replay_counts(m) == counts
    one = _model(kind)
    train(one, 2 * iters, True)
    assert _same(chip_smoke._flat(m.counts), chip_smoke._flat(one.counts))
    assert torch.equal(m._gen.get_state(), one._gen.get_state())
    if labeled:
        assert _same([m.ph_hat, *m._th_hat_t], [one.ph_hat, *one._th_hat_t])
        assert m.cur_perplx == one.cur_perplx and m._avg_s == one._avg_s == 4
    runner = m._fused if kind.endswith("fused") else m._exact
    assert m.counts is runner.state and (m._exact is None) == kind.endswith("fused")


def _train(m, labeled, first, iters=8):
    if labeled:
        m.run_training(iters, 4, perplexity=True, continue_avg=not first, total_iters=16)
    else:
        m.run_training(iters, 4, total_iters=16)


@pytest.mark.parametrize("case", ["checkpoint", "resumed-chunks", "pickle"])
@pytest.mark.parametrize("kind", ["labeled-compact", "labeled-dense", "local-dense"])
def test_exact_runners_take_in_a_replaced_state(tmp_path, graphed, kind, case):
    """Between two calls of an exact sampler, a state from elsewhere is
    copied into the model's kept runners (sweeps and saves) and the result
    equals the uninterrupted run's bits: a checkpoint restored into a model
    whose runners hold another chain, a resumed chunked run of
    ``utils/elastic.py``, and a pickled model (its graphs dropped)."""
    labeled = kind.startswith("labeled")
    ref = _model(kind)
    for n, first in ((8, True), (4, False), (4, False)):
        _train(ref, labeled, first, n)

    m1 = _model(kind)
    _train(m1, labeled, True)
    ckpt = str(tmp_path / "ck")
    if case == "pickle":
        m2 = pickle.loads(pickle.dumps(m1))
        assert m2.counts is m2._exact.state and m2._exact.runs[0]._graphs == {}
    else:
        save_model(ckpt, m1, extra_meta={"iters_done": 8})
        m2 = _model(kind, seed=99)
        _train(m2, labeled, True)  # its runners hold another chain
        runner, saves = m2._exact, m2._save
        if case == "checkpoint":
            restore_model(ckpt, m2)
        else:
            eg = ElasticGibbs(m2, ckpt, resume=True)
            assert eg.iters == 8
        assert not runner.holds(m2.counts)
        if labeled:
            assert not saves.holds(m2.ph_hat, m2._th_hat_t)
    if case == "resumed-chunks":
        eg.run(16, 4, save_every=4, **(dict(perplexity=True) if labeled else {}))
        assert load_checkpoint(ckpt)[1]["iters_done"] == 16
    else:
        _train(m2, labeled, False, 4)
        _train(m2, labeled, False, 4)
    if case != "pickle":
        assert m2._exact is runner and m2._save is saves
    assert m2.counts is m2._exact.state
    assert _same(chip_smoke._flat(m2.counts), chip_smoke._flat(ref.counts))
    assert torch.equal(m2._gen.get_state(), ref._gen.get_state())
    if labeled:
        assert m2.ph_hat is m2._save.ph_hat
        assert _same([m2.ph_hat, *m2._th_hat_t], [ref.ph_hat, *ref._th_hat_t])
        assert m2.cur_perplx == ref.cur_perplx and len(ref.cur_perplx) == 4
    else:
        assert np.array_equal(m2.ph_hat, ref.ph_hat) and np.array_equal(m2.th_hat, ref.th_hat)


@pytest.mark.parametrize("case", ["n_buckets", "sweep", "shape"])
def test_mismatched_state_refuses_to_load(tmp_path, case):
    """A kept runner never replays stale addresses: a checkpoint of another
    bucket count or sampler is refused with ``utils/checkpoint``'s messages
    before it reaches the runners, and a state of another shape is refused
    by the runner itself."""
    m = _labeled("compact")
    m.run_training(4, 2)
    runner = m._exact
    if case == "shape":
        other = _labeled("compact")
        other.counts = other.counts._replace(n_vk=other.counts.n_vk[:-1])
        with pytest.raises(ValueError, match="must keep the shape"):
            runner.load(other.counts)
        return
    c = planted_corpus(2, **SMALL)
    kw = dict(n_buckets=2) if case == "n_buckets" else dict(sweep="dense")
    src = LabeledLDA(c.train_docs, c.train_labs, c.labelset, Dictionary(c.train_docs), ALPHA,
                     BETA, seed=1, device="cpu", **{"sweep": "compact", **kw})
    src.run_training(2, 2)
    save_model(str(tmp_path / "ck"), src)
    match = "bucket count mismatch" if case == "n_buckets" else "sweep kernel mismatch"
    with pytest.raises(ValueError, match=match):
        restore_model(str(tmp_path / "ck"), m)
    assert m.counts is runner.state and runner.holds(m.counts)


def test_second_call_replays_every_runner(graphed, monkeypatch):
    """With the card's replay rule, a model's first call captures each
    runner's graph (a bucket's sweep, the save) and its second captures none
    and runs no body eagerly; a pickled model captures again."""
    m = _labeled("compact")
    m.run_training(4, 2)
    G = m.buckets.n_buckets
    assert chip_smoke.replay_counts(m) == (G + 1, G + 1)
    m.run_training(4, 2)
    assert chip_smoke.replay_counts(m) == (G + 1, G + 1)
    assert all(r._key_calls == {None: 8} for r in m._exact.runs)
    assert m._save._key_calls == {True: 4}
    clone = pickle.loads(pickle.dumps(m))
    assert chip_smoke.replay_counts(clone) == (0, 0)


# ------------------------------------------------------------------- chains


def _chains(sweep, n_buckets=1, seed=0):
    c = planted_corpus(2, **SMALL)
    return DistributedLabeledLDA(c.train_docs, c.train_labs, c.labelset,
                                 Dictionary(c.train_docs), ALPHA, BETA,
                                 mesh=make_mesh(device="cpu"), n_chains=3, seed=seed,
                                 sweep=sweep, n_buckets=n_buckets)


@pytest.mark.parametrize("layout", ["fused", "bucketed", "dense"])
def test_chain_saves_equal_per_chain_saves(graphed, layout):
    """A rank's save over the chain axis (one ``SaveStep`` over
    ``phi_chains`` and ``theta_chains``, or, dense, ``theta_from_counts``
    of ``(L, D, K)`` counts) equals per-chain saves (one ``SaveStep`` per
    chain over ``phi_from_counts`` and the single-chain θ), bit for bit, at
    each of four saves, one a call; the later saves replay."""
    m = _chains("dense" if layout == "dense" else "fused",
                n_buckets=2 if layout == "bucketed" else 1)
    corpora = m.corpus if layout == "bucketed" else (m.corpus,)
    singles = None
    for _ in range(4):
        m.run_training(2, 2, total_iters=16)  # one save
        st = m.state
        ths = st.th_hat if isinstance(st.th_hat, tuple) else (st.th_hat,)
        ndks = st.n_dk if isinstance(st.n_dk, tuple) else (st.n_dk,)
        if singles is None:
            singles = [tgibbs.SaveStep(torch.zeros_like(st.ph_hat[c]),
                                       [torch.zeros_like(t[c]) for t in ths])
                       for c in range(m.n_chains)]
        for c, run in enumerate(singles):
            def estimates(c=c):
                ph = tstate.phi_from_counts(st.n_vk[c], st.n_k[c], BETA, m.topic_mask)
                if layout == "dense":
                    return ph, (tstate.theta_from_counts(ndks[0][c], corpora[0].labs, ALPHA),)
                return ph, tuple(theta_from_fused(nd[c], cp.lab_ids, cp.lab_valid, ALPHA, m.Kp)
                                 for nd, cp in zip(ndks, corpora))

            run(st.s, estimates)
            assert _same([run.ph_hat, *run.th_hat], [st.ph_hat[c], *(t[c] for t in ths)])
    loop = m._loop
    saves = loop._saves if layout == "dense" else loop.blocks.saves
    assert list(saves._graphs) == [False] and saves._key_calls == {False: 4} and st.s == 4


def test_dense_chain_theta_equals_per_chain_list():
    """``theta_from_counts`` of ``(L, D, K)`` counts in one pass equals the
    per-chain list of ``(D, K)`` calls, bit for bit."""
    rng = np.random.default_rng(3)
    labs = torch.from_numpy((rng.random((21, 16)) < 0.3).astype(np.float32))
    labs[:, 0] = 1.0
    n_dk = torch.from_numpy((rng.integers(0, 9, (4, 21, 16)) * labs.numpy()).astype(np.float32))
    got = tstate.theta_from_counts(n_dk, labs, ALPHA)
    want = torch.stack([tstate.theta_from_counts(nd, labs, ALPHA) for nd in n_dk])
    assert _same([got], [want])
