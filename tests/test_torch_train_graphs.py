"""The training loops' runners against the eager functions they replay.

``ops/gibbs_fused.FusedBlocks`` (the merge blocks of ``LabeledLDA``,
``LocalLDA`` and a rank's chains) and ``ops/gibbs.CompactSweep`` (the
compact sweep) replay one CUDA graph per block or sweep on a card; on the
CPU they run their body eagerly.  Here, on the CPU, each runner is held bit
for bit to the chained functional calls (``fused_train_block_buckets``,
``compact_sweep``) and to the JAX package's on the same uniforms; each
model's training call to ``chip_smoke``'s eager loops (``eager_training``,
``eager_chains_training``), which phase 16 holds the replays to on the
card; and a checkpoint restore, a resumed chunked run and a pickle between
two calls keep the uninterrupted run's bits.  The replay rule itself (one
graph per block length, launches counted per replay) runs here through a
stand-in graph that replays the captured body.
"""

import pickle

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import chip_smoke
from lda_thesis_tpu.data.encode import compact_labels
from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu.ops import gibbs_fused as jfused
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
from lda_thesis_tpu_torch.models.local_lda import LocalLDA
from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.ops import gibbs_fused as tfused
from lda_thesis_tpu_torch.parallel import make_mesh
from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, restore_model, save_model
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs

ALPHA, BETA = 0.1, 0.01
SMALL = dict(n_train=40, n_test=8, V=200, max_types=20, mean_types=8)
BLOCKS = (2, 2, 1, 2)  # block lengths of a call sequence: two keys, M = 2 and 1


def _same(a, b):
    return chip_smoke._bitwise(chip_smoke._flat(a), chip_smoke._flat(b))


def _chained(state, chains: int):
    """``state`` with a leading axis of ``chains`` copies."""
    if not chains:
        return state
    return type(state)(*(tuple(t.expand(chains, *t.shape).clone() for t in part)
                         if isinstance(part, tuple) else part.expand(chains, *part.shape).clone()
                         for part in state))


def _generators(seed, chains):
    gens = [torch.Generator().manual_seed(seed + j) for j in range(max(chains, 1))]
    return gens if chains else gens[0]


@pytest.mark.parametrize("draws", ["generator", "uniforms"])
@pytest.mark.parametrize("chains", [0, 3])
def test_fused_blocks_equal_chained_function(chains, draws):
    """Blocks of ``FusedBlocks`` (lengths ``BLOCKS``) == as many chained
    ``fused_train_block_buckets`` calls, bit for bit after each: drawn from
    a generator (one per chain) in the old ``_block``'s order, or fed
    uniforms.  The runner owns a copy of the state and updates it in
    place; the CPU never captures and counts no launch."""
    state, *inputs = chip_smoke.fused_problem("cpu", 1, 21, 9, 13)
    state = _chained(state, chains)
    run = tfused.FusedBlocks(state, *inputs, ALPHA, BETA)
    assert run.holds(run.state) and not run.holds(state) and _same(run.state, state)
    gen, twin = _generators(5, chains), _generators(5, chains)
    lead = (chains,) if chains else ()
    draw = torch.Generator().manual_seed(9)
    launches = fbc.launches
    for M in BLOCKS:
        us = None
        if draws == "uniforms":
            us = [torch.rand(lead + (M, *tv.shape), generator=draw) for tv in inputs[0]]
        got = run(M, generator=gen, uniforms=us)
        state = tfused.fused_train_block_buckets(state, *inputs, ALPHA, BETA, M, uniforms=us,
                                                 generator=None if us else twin)
        assert got is run.state and _same(got, state)
    assert fbc.launches == launches
    assert run._graphs == {} and run.calls == len(BLOCKS)
    assert run._key_calls == {2: 3, 1: 1} and sorted(run._u) == [1, 2]


@pytest.mark.parametrize("M", [1, 3])
def test_fused_blocks_match_jax(M):
    """Two blocks of ``FusedBlocks`` over two buckets, fed the uniforms JAX's
    ``fused_train_block_buckets`` draws (bucket g's from ``fold_in(key,
    g)``), equal JAX's blocks: z, n_dk, n_vk and n_k."""
    state, tv, tf, li, lv = chip_smoke.fused_problem("cpu", 2, 17, 7, 13)
    run = tfused.FusedBlocks(state, tv, tf, li, lv, ALPHA, BETA)
    want = jfused.FusedBucketState(*(tuple(jnp.asarray(t.numpy()) for t in part)
                                     if isinstance(part, tuple) else jnp.asarray(part.numpy())
                                     for part in state))
    j_in = [[jnp.asarray(t.numpy()) for t in x] for x in (tv, tf, li, lv)]
    for b in range(2):
        key = jax.random.PRNGKey(11 + b)
        want = jfused.fused_train_block_buckets(key, want, *j_in, ALPHA, BETA, M)
        us = [torch.from_numpy(np.array(jax.random.uniform(
            jax.random.fold_in(key, g), (M, *t.shape), dtype=jnp.float32)))
            for g, t in enumerate(tv)]
        got = run(M, uniforms=us)
        for a, w in zip(chip_smoke._flat(got), chip_smoke._flat(want)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(w))


def _compact_problem(seed, D=48, U=8, K=64, V=40):
    """tests/test_torch_gibbs_exact.py's problem on the compact support:
    shared words at one position, f = 0 gaps, padded topics."""
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    tok_v[:, 2] = rng.integers(0, 3, size=D)
    tok_f = rng.integers(1, 4, size=(D, U)).astype(np.int32)
    tok_f[rng.random((D, U)) < 0.2] = 0
    labs = (rng.random((D, K)) < 0.1).astype(np.float32)
    labs[:, 0], labs[:, 50:] = 1.0, 0.0
    lab_ids, lab_valid = compact_labels(labs)
    return tok_v, tok_f, lab_ids, lab_valid, V, K


@pytest.mark.parametrize("draws", ["generator", "jax-uniforms"])
def test_compact_sweep_class_equals_function_and_jax(draws):
    """3 ``CompactSweep`` calls == 3 ``compact_sweep`` calls from one state,
    bit for bit after each; fed JAX's uniforms, both equal JAX's
    ``train_sweep_compact`` (z, n_dk, n_vk, n_k).  The class writes z in
    place, the function returns a new z and leaves its input."""
    tok_v, tok_f, lab_ids, lab_valid, V, K = _compact_problem(3)
    key = jax.random.PRNGKey(4)
    jc = jgibbs.init_counts_compact(key, *(jnp.asarray(x) for x in (tok_v, tok_f, lab_ids,
                                                                     lab_valid)), V, K)
    z = torch.from_numpy(np.array(jc.z)).T.contiguous()
    counts = [torch.from_numpy(np.array(x)) for x in (jc.n_dk, jc.n_vk, jc.n_k)]
    ref = [x.clone() for x in counts]
    args = (torch.from_numpy(tok_v.T.astype(np.int64)).contiguous(),
            torch.from_numpy(tok_f.T.astype(np.float32)).contiguous(),
            torch.from_numpy(lab_ids.astype(np.int64)), torch.from_numpy(lab_valid),
            ALPHA, BETA, float(V * BETA))
    z_static = z.clone()
    run = tgibbs.CompactSweep(z_static, *counts, *args)
    gen, twin = torch.Generator().manual_seed(6), torch.Generator().manual_seed(6)
    for i in range(3):
        k = jax.random.fold_in(key, i + 1)
        if draws == "generator":
            u, got = torch.rand(tuple(z.shape), generator=twin), run(gen)
        else:
            u = torch.from_numpy(np.array(jax.random.uniform(k, tuple(z.shape), jnp.float32)))
            got = run(uniforms=u)
            jc = jgibbs.train_sweep_compact(k, jc, *(jnp.asarray(x) for x in (
                tok_v, tok_f, lab_ids, lab_valid)), ALPHA, BETA)
        z_in, z_kept = z, z.clone()
        z = tgibbs.compact_sweep(z_in, *ref, *args, u)
        assert got is z_static and torch.equal(z_in, z_kept)
        assert chip_smoke._bitwise([got, *counts], [z, *ref])
        if draws != "generator":
            for name, a, w in zip(("z", "n_dk", "n_vk", "n_k"), (got.T, *counts), jc):
                np.testing.assert_array_equal(a.numpy(), np.asarray(w), err_msg=name)
    assert run._graph is None and run.calls == 3


def _labeled(sweep="fused", seed=0, corpus_seed=2):
    c = planted_corpus(corpus_seed, **SMALL)
    return LabeledLDA(c.train_docs, c.train_labs, c.labelset, Dictionary(c.train_docs),
                      ALPHA, BETA, seed=seed, sweep=sweep, device="cpu")


def _local(seed=0, K=5):
    c = planted_corpus(2, **SMALL)
    texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) + "." for d in c.train_docs]
    return LocalLDA(texts, alpha=ALPHA, beta=BETA, K=K, seed=seed, device="cpu")


def _chains(seed=0):
    c = planted_corpus(2, **SMALL)
    return DistributedLabeledLDA(c.train_docs, c.train_labs, c.labelset,
                                 Dictionary(c.train_docs), ALPHA, BETA,
                                 mesh=make_mesh(device="cpu"), n_chains=3, seed=seed,
                                 n_buckets=2)


@pytest.mark.parametrize("kind", ["labeled-fused", "labeled-compact", "local", "chains"])
def test_models_equal_eager_loop(kind):
    """Two training calls of each model equal ``chip_smoke``'s eager loop
    of functional calls from the state before each: z, the counts, φ̂, θ̂,
    the perplexities and the generators' states.  The fused calls run
    M = 4 and a trailing block of 2 (two block lengths); ``counts`` stays
    the runner's static state."""
    if kind == "chains":
        m = _chains()
        for _ in range(2):
            want = chip_smoke.eager_chains_training(m, 10, 4, 64)
            m.run_training(10, 4, total_iters=64)
            assert chip_smoke.chains_equal(m, want)
        assert m._merge_M == 4 and m._loop.blocks.run._key_calls == {4: 4, 2: 2}
        return
    m = _local() if kind == "local" else _labeled(kind.split("-")[1])
    for _ in range(2):
        if kind == "labeled-fused":
            before, want = len(m.cur_perplx), chip_smoke.eager_training(m, 10, 4, 64, True)
            m.run_training(10, 4, perplexity=True, total_iters=64)
            assert len(m.cur_perplx) == before + 2
        elif kind == "labeled-compact":
            before, want = len(m.cur_perplx), chip_smoke.eager_training(m, 5, 2, None, True)
            m.run_training(5, 2)
        else:
            before, want = 0, chip_smoke.eager_training(m, 6, 3)
            m.run_training(6, 3)
        assert chip_smoke.training_equal(m, want, before)
    if kind != "labeled-compact":
        assert m.counts is m._fused.state


def _model_of(kind, seed=0):
    return _labeled(seed=seed) if kind == "labeled" else _local(seed=seed)


def _train(m, kind, first: bool, iters=8):
    if kind == "labeled":
        m.run_training(iters, 4, perplexity=True, continue_avg=not first, total_iters=16)
    else:
        m.run_training(iters, 4, total_iters=16)


def _same_result(a, b, kind) -> bool:
    """z, the counts, the thinned means, the perplexities and the generator."""
    same = (chip_smoke._bitwise(chip_smoke._flat(a.counts), chip_smoke._flat(b.counts))
            and torch.equal(a._gen.get_state(), b._gen.get_state()))
    if kind == "labeled":
        return (same and chip_smoke._bitwise([a.ph_hat, *a._th_hat_t], [b.ph_hat, *b._th_hat_t])
                and a.cur_perplx == b.cur_perplx and len(a.cur_perplx) == 4)
    return same and np.array_equal(a.ph_hat, b.ph_hat) and np.array_equal(a.th_hat, b.th_hat)


@pytest.mark.parametrize("case", ["checkpoint", "resumed-chunks", "pickle"])
@pytest.mark.parametrize("kind", ["labeled", "local"])
def test_replaced_state_keeps_the_bits(tmp_path, kind, case):
    """Between two training calls, a state that replaces ``counts`` from
    elsewhere is copied into the model's runner, and the result equals the
    uninterrupted run's bits: a checkpoint restored into a model whose
    runner already holds another chain (``convert.py``'s load), a resumed
    chunked run of ``utils/elastic.py`` (its restore, then chunks of 4
    sweeps), and a pickled model (its graphs dropped)."""
    ref = _model_of(kind)
    _train(ref, kind, True)
    _train(ref, kind, False, iters=4)
    _train(ref, kind, False, iters=4)

    m1 = _model_of(kind)
    _train(m1, kind, True)
    ckpt = str(tmp_path / "ck")
    if case == "pickle":
        m2 = pickle.loads(pickle.dumps(m1))
        assert m2.counts is m2._fused.state and m2._fused._graphs == {}
    else:
        save_model(ckpt, m1, extra_meta={"iters_done": 8})
        m2 = _model_of(kind, seed=99)
        _train(m2, kind, True)  # its runner holds another chain
        runner = m2._fused
        assert not torch.equal(m2.counts.n_vk, m1.counts.n_vk)
        if case == "checkpoint":
            restore_model(ckpt, m2)
        else:
            eg = ElasticGibbs(m2, ckpt, resume=True)
            assert eg.iters == 8
        assert not m2._fused.holds(m2.counts)
    if case == "resumed-chunks":
        kw = dict(perplexity=True) if kind == "labeled" else {}
        eg.run(16, 4, save_every=4, **kw)
        assert load_checkpoint(ckpt)[1]["iters_done"] == 16
    else:
        _train(m2, kind, False, iters=4)
        _train(m2, kind, False, iters=4)
    if case != "pickle":
        assert m2._fused is runner  # the same runner, its state copied in
    assert m2.counts is m2._fused.state
    assert _same_result(m2, ref, kind)


def test_fused_blocks_load_refuses_another_shape():
    state, *inputs = chip_smoke.fused_problem("cpu", 1, 21, 9, 13)
    run = tfused.FusedBlocks(state, *inputs, ALPHA, BETA)
    other, *_ = chip_smoke.fused_problem("cpu", 1, 20, 9, 13)
    with pytest.raises(ValueError, match="must keep the shape"):
        run.load(other)


class _StandInGraph:
    """A captured body: capture runs the body (so its wrappers count) and
    puts the state back, as a CUDA capture runs nothing; each replay runs
    the body again on the runner's static buffers, its wrappers' counts
    taken back, as a replay calls no wrapper."""

    def __init__(self, fn, run):
        saved = [t.clone() for t in chip_smoke._flat(run.state)]
        fn()
        for t, s in zip(chip_smoke._flat(run.state), saved):
            t.copy_(s)
        self._fn = fn

    def replay(self):
        n, entries = fbc.launches, tfused.table_entries
        self._fn()
        fbc.launches, tfused.table_entries = n, entries


def test_replay_rule_keeps_a_graph_per_block_length(monkeypatch):
    """``_Replayed``'s rule on ``FusedBlocks`` with a stand-in graph (the CPU
    cannot capture): the first block of each length runs eagerly, the
    second captures and replays, later ones replay; one graph per length;
    the launches and the gathered table entries counted while capturing are
    taken back and each replay adds them again, so the counter reads one
    launch per bucket per block; the state equals the chained eager blocks
    after each call."""
    state, *inputs = chip_smoke.fused_problem("cpu", 3, 21, 9, 13)
    run = tfused.FusedBlocks(state, *inputs, ALPHA, BETA)
    run._graphed = True
    captured = []

    def capture(fn, device):
        captured.append(len(captured))
        return _StandInGraph(fn, run)

    def counted(*args):
        fbc.launches += 1
        return fbc.fused_block_torch(*args)

    monkeypatch.setattr(tgibbs, "capture_graph", capture)
    monkeypatch.setattr(tfused, "fused_block", counted)
    monkeypatch.setattr(fbc, "launches", 0)
    gen, twin = _generators(8, 0), _generators(8, 0)
    for i, M in enumerate(BLOCKS + (1, 2)):
        got = run(M, generator=gen)
        state = tfused.fused_train_block_buckets(state, *inputs, ALPHA, BETA, M,
                                                 generator=twin)
        fbc.launches -= 2  # the eager reference's
        assert _same(got, state) and fbc.launches == 2 * (i + 1)
    assert sorted(run._graphs) == [1, 2] and len(captured) == 2
    entries = sum(tv.numel() * li.shape[1] for tv, li in zip(inputs[0], inputs[2]))
    assert [added for _, added in run._graphs.values()] == [[2, 0, 0, 0, entries]] * 2
    clone = pickle.loads(pickle.dumps(run))
    assert clone._graphs == {} and clone._u == {} and clone.calls == 0
    assert _same(clone.state, run.state)
