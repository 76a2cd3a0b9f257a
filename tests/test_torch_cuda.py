"""Card-only checks of the port's CUDA kernels, with no JAX import.

Each test is marked ``cuda`` and skips without a CUDA device.  The file
imports nothing of JAX, so it also runs where JAX is not installed:

    LDA_TESTS_KEEP_PLATFORM=1 python -m pytest -m cuda tests/test_torch_cuda.py

(``LDA_TESTS_KEEP_PLATFORM=1`` keeps tests/conftest.py from importing JAX.)
"""

import numpy as np
import pytest
import torch

import chip_smoke
from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs

ALPHA, BETA = 0.1, 0.01


def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs these checks on the card")


def _step_inputs(seed, D, K):
    """One exact-sweep position: a third of f = 0 and one all-zero label row."""
    rng = np.random.default_rng(seed)
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    f = rng.integers(1, 4, size=D).astype(np.float32)
    f[rng.random(D) < 0.33] = 0.0
    labs[1], f[1] = 0.0, 0.0
    z_old = (rng.random(D) * K).astype(np.int32)
    n_dk = rng.integers(0, 20, size=(D, K)).astype(np.float32)
    n_dk[np.arange(D), z_old] += f
    cv = rng.integers(0, 300, size=(D, K)).astype(np.float32)
    recip = (1.0 / (rng.integers(1000, 9000, size=K) + 89.69)).astype(np.float32)
    u = rng.random(D).astype(np.float32)
    return [torch.from_numpy(x).cuda() for x in (u, f, z_old, labs, n_dk, cv, recip)]


def _same_bits(a, b):
    return a.dtype == b.dtype and torch.equal(a.contiguous().view(torch.int32),
                                              b.contiguous().view(torch.int32))


DRAW_SHAPES = [(64, 128), (37, 40), (300, 512), (9, 7), (1000, 371), (50, 1100), (5, 1)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DRAW_SHAPES, ids=lambda s: f"D{s[0]}-K{s[1]}")
def test_draw_update_kernel_matches_plain_version(shape):
    _needs_card()
    args = _step_inputs(sum(shape), *shape)
    before = duc.launches
    got = duc.draw_update(*[t.clone() for t in args], ALPHA, BETA)
    want = duc.draw_update_torch(*[t.clone() for t in args], ALPHA, BETA)
    torch.cuda.synchronize()
    assert duc.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    assert int(got[1][1]) == int(args[2][1])  # the all-zero row keeps its topic


@pytest.mark.cuda
def test_exact_sweep_on_card_matches_cpu():
    _needs_card()
    rng = np.random.default_rng(0)
    D, U, K, V = 200, 12, 128, 50
    tok_v = torch.from_numpy(rng.integers(0, V, size=(D, U)))
    tok_v[:, 3] = 7  # every document has word 7 at position 3
    tok_f = torch.from_numpy(rng.integers(0, 4, size=(D, U)))
    labs = torch.from_numpy((rng.random((D, K)) < 0.1).astype(np.float32))
    labs[:, 0] = 1.0
    g = torch.Generator().manual_seed(1)
    c = tgibbs.init_counts(tok_v, tok_f, labs, V, generator=g)
    u = torch.rand((U, D), generator=g)
    before = duc.launches
    on_card = tgibbs.train_sweep(tgibbs.LDACounts(*(t.cuda() for t in c)), tok_v.cuda(),
                                 tok_f.cuda(), labs.cuda(), ALPHA, BETA, uniforms=u.cuda())
    on_cpu = tgibbs.train_sweep(c, tok_v, tok_f, labs, ALPHA, BETA, uniforms=u)
    torch.cuda.synchronize()
    assert duc.launches == before + U
    assert all(_same_bits(a.cpu(), b) for a, b in zip(on_card, on_cpu))
    assert torch.equal(on_card.n_k, on_card.n_vk.sum(0))


def _sweep_step(seed, D, K, V=60):
    """One sweep position in the sweep's own form: slots over a (V, K)
    table, the decremented totals and the live rows."""
    rng = np.random.default_rng(seed)
    u, f, z, labs, n_dk, _, _ = _step_inputs(seed, D, K)
    rows = torch.from_numpy(rng.integers(0, V, size=D)).cuda()
    table = torch.from_numpy(rng.integers(0, 300, size=(V, K)).astype(np.float32)).cuda()
    n_k = table.sum(0) + 17.0
    live = torch.nonzero(f > 0).flatten().to(torch.int32)
    return u, f, z, labs, n_dk, table, rows, n_k, live


@pytest.mark.cuda
@pytest.mark.parametrize("shape", DRAW_SHAPES + [(40, 64, "none live")],
                         ids=lambda s: "-".join(map(str, s)))
def test_draw_rows_kernel_matches_plain_version(shape):
    """The sweep's draw: table rows read in place, recip from n_k, only the
    live rows launched; with no live row there is no launch."""
    _needs_card()
    u, f, z, labs, n_dk, table, rows, n_k, live = _sweep_step(sum(shape[:2]), *shape[:2])
    if len(shape) > 2:
        live = live[:0]
    words = rows[live.long()]
    outs = []
    for fn in (duc.draw_rows, duc.draw_rows_torch):
        zz, nd = z.clone(), n_dk.clone()
        before = duc.launches
        fn(u, f, zz, labs, nd, table, words, n_k, live, ALPHA, BETA, 0.6)
        outs.append((zz, nd, duc.launches - before))
    torch.cuda.synchronize()
    (zk, nk_, launched), (zp, np_, _) = outs
    assert launched == (1 if live.numel() else 0)
    assert _same_bits(zk, zp) and _same_bits(nk_, np_)
    if not live.numel():
        assert torch.equal(zk, z) and _same_bits(nk_, n_dk)


@pytest.mark.cuda
@pytest.mark.parametrize("parts", ["dec", "inc", "both"])
def test_commit_kernel_matches_index_add(parts):
    _needs_card()
    *_, table, rows, n_k, live = _sweep_step(3, 2000, 371)
    slots = []
    for seed in (5, 6):
        r = np.random.default_rng(seed)
        f = torch.from_numpy(r.integers(0, 4, size=2000).astype(np.float32)).cuda()
        slots.append(duc.Slots(torch.from_numpy(r.integers(0, 60, size=2000)).cuda(),
                               torch.from_numpy(r.integers(0, 371, size=2000)
                                                .astype(np.int32)).cuda(), f,
                               torch.nonzero(f > 0).flatten().to(torch.int32)))
    dec = slots[0] if parts in ("dec", "both") else None
    inc = slots[1] if parts in ("inc", "both") else None
    got_t, got_k = table.clone(), n_k.clone()
    before = duc.commit_launches
    duc.commit_counts(got_t, got_k, dec, inc)
    want_t, want_k = table.clone(), n_k.clone()
    duc.commit_counts_torch(want_t, want_k, dec, inc)
    torch.cuda.synchronize()
    assert duc.commit_launches == before + 1
    assert _same_bits(got_t, want_t) and _same_bits(got_k, want_k)


def _small_dense_model():
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA

    c = planted_corpus(1, n_train=400, n_test=8, V=600, n_labels=40, max_labels=6,
                       mean_types=20.0, max_types=64)
    dicti = prune_dict(c.train_docs, lower=0, upper=1)
    return LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, alpha=ALPHA,
                      beta=BETA, seed=3, sweep="dense", device="cuda")


def _dense_state(model, device):
    """A copy of ``model``'s dense state on ``device``, z position-major."""
    st = model.counts
    return ([z.T.clone(memory_format=torch.contiguous_format).to(device) for z in st.z],
            [x.to(device, copy=True) for x in st.n_dk], st.n_vk.to(device, copy=True),
            st.n_k.to(device, copy=True))


def _bucket_runners(model):
    state = _dense_state(model, "cuda")
    z_t, n_dk, n_vk, n_k = state
    runs = [tgibbs.ExactSweep(z_t[g], n_dk[g], n_vk, n_k, model._toks_v_t[g],
                              model._toks_f_t[g], model.labs_t[g], ALPHA, BETA,
                              model.V * BETA)
            for g in range(model.buckets.n_buckets)]
    return runs, state


def _planned(model):
    """(draws, commits) of one sweep over all of ``model``'s buckets."""
    plan = [chip_smoke.planned_sweep_launches(tf) for tf in model._toks_f_t]
    return sum(p[0] for p in plan), sum(p[1] for p in plan)


@pytest.mark.cuda
def test_graphed_sweeps_equal_eager_and_cpu():
    """Three exact sweeps over all buckets: replayed CUDA graphs, eager
    launches on the card, and the plain versions on the CPU, from the same
    uniforms, give the same bits; replays count their captured launches."""
    _needs_card()
    model = _small_dense_model()
    gen = torch.Generator().manual_seed(9)
    us = [[torch.rand(tuple(tv.shape), generator=gen) for tv in model._toks_v_t]
          for _ in range(3)]
    results = {}
    for name, device in (("graph", "cuda"), ("eager", "cuda"), ("cpu", "cpu")):
        d0, c0 = duc.launches, duc.commit_launches
        if name == "graph":
            runs, state = _bucket_runners(model)
            for sweep in us:
                for run, u in zip(runs, sweep):
                    run(uniforms=u.to(device))
            assert all(r._graph is not None for r in runs)
        else:
            state = _dense_state(model, device)
            z_t, n_dk, n_vk, n_k = state
            for sweep in us:
                for g, u in enumerate(sweep):
                    tgibbs.exact_sweep(z_t[g], n_dk[g], n_vk, n_k,
                                       model._toks_v_t[g].to(device),
                                       model._toks_f_t[g].to(device),
                                       model.labs_t[g].to(device), ALPHA, BETA,
                                       model.V * BETA, u.to(device))
        results[name] = [t.cpu() for part in state for t in
                         (part if isinstance(part, list) else [part])]
        if device == "cuda":
            draws, commits = _planned(model)
            assert (duc.launches - d0, duc.commit_launches - c0) == (3 * draws, 3 * commits)
    for name in ("eager", "cpu"):
        assert all(_same_bits(a, b) for a, b in zip(results["graph"], results[name])), name
    n_vk, n_k = results["graph"][-2:]
    assert torch.equal(n_k, n_vk.sum(0))


@pytest.mark.cuda
def test_graph_replay_launches_match_profiler_records():
    """The counters add a replay's captured launches; the profiler sees
    each kernel node of the replayed graph."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    _needs_card()
    model = _small_dense_model()
    runs, _ = _bucket_runners(model)
    gen = torch.Generator(device="cuda").manual_seed(2)
    for _ in range(2):  # eager, then capture and the first replay
        for run in runs:
            run(gen)
    torch.cuda.synchronize()
    d0, c0 = duc.launches, duc.commit_launches
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for run in runs:
            run(gen)
        torch.cuda.synchronize()
    draws, commits = duc.launches - d0, duc.commit_launches - c0
    assert (draws, commits) == _planned(model)
    events = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    assert sum(e.count for e in events if "draw_update_kernel" in e.key) == draws
    assert sum(e.count for e in events if "count_commit_kernel" in e.key) == commits


# ---- the merge-block kernel (fused_block.cu) against fused_block_torch


def _check_block(args):
    before = fbc.launches
    got = fbc.fused_block(*args, ALPHA, BETA)
    want = fbc.fused_block_torch(*args, ALPHA, BETA)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    assert all(_same_bits(g, w) for g, w in zip(got, want))
    return got


# (D, U, A, M, gaps, zero_doc): the main path's four buckets (depth-3
# abstracts, A = 24, M = 25), then chip_smoke.py's edge cases: ragged
# shapes, two waves of CTAs, one and 32 slots, a document with no live
# position, interior gaps, U = 512, and documents of one or two positions
# (with one, each step's next step is the same position); then the warp
# route's slot and position counts past the staged route's limits, the wide
# route's past the warp route's widest A, and the general route's past the
# wide route's widest
BLOCK_CASES = {
    "bucket0": (1653, 32, 24, 25, 0.0, False),
    "bucket1": (1148, 48, 24, 25, 0.0, False),
    "bucket2": (955, 80, 24, 25, 0.0, False),
    "bucket3": (415, 128, 24, 25, 0.0, False),
    **chip_smoke.edge_cases(),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(BLOCK_CASES))
def test_fused_block_kernel_matches_plain_version(case):
    _needs_card()
    D, U, A, M, gaps, zero_doc = BLOCK_CASES[case]
    args = chip_smoke.block_case("cuda", D + U + A, D, U, A, M, gaps, zero_doc)
    before = chip_smoke._route_counts(fbc)
    z, ndk = _check_block(args)
    assert chip_smoke._launched_on(fbc, before) == fbc.route(U, A)
    if zero_doc:  # no live position: z and n_dk come back as they went in
        assert torch.equal(z[:, 0], args[3][:, 0])
        assert _same_bits(ndk[:, 0], args[6][:, 0])


@pytest.mark.cuda
def test_fused_block_shared_memory_layout_and_limit():
    """The staged route runs at the widest document its shared memory holds
    (at A = 32, at least the 512 positions of the old cap); one position
    past it, at A = 33 and at the warp route's widest A, the warp route
    runs; one slot past that and up to its own widest A (9,852 on an H100),
    the wide route; one slot past that, the general route: each bitwise
    equal to the plain version, each counted on its own route, and nothing
    is refused."""
    _needs_card()
    U = fbc.max_positions(32)
    widest = 32 * fbc.WARP_ROWS_MAX
    wide = fbc.wide_max_slots()
    assert U >= 512 and wide == chip_smoke.WIDE_SLOTS_H100
    assert fbc.route(U, 32) == "staged"
    assert fbc.route(U + 1, 32) == fbc.route(8, 33) == fbc.route(8, widest) == "warp"
    assert fbc.route(8, widest + 1) == fbc.route(8, wide) == "wide"
    assert fbc.route(8, wide + 1) == "general"
    cases = [((1, 4, U, 32, 1), (1, 0, 0, 0)), ((1, 4, U + 1, 32, 1), (1, 1, 0, 0)),
             ((2, 4, 8, 33, 2), (1, 1, 0, 0)), ((3, 4, 8, widest, 2), (1, 1, 0, 0)),
             ((4, 4, 8, widest + 1, 2), (1, 0, 1, 0)), ((5, 3, 4, wide, 2), (1, 0, 1, 0)),
             ((6, 3, 4, wide + 1, 2), (1, 0, 0, 1))]
    for args, moved in cases:
        before = chip_smoke._route_counts(fbc)
        _check_block(chip_smoke.block_case("cuda", *args))
        after = chip_smoke._route_counts(fbc)
        assert tuple(a - b for a, b in zip(after, before)) == moved, args
    with pytest.raises(ValueError, match="slots"):
        fbc.max_positions(33)


# ---- LocalLDA on the card against the CPU


def _local_lda(K, sweep, device):
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA

    c = planted_corpus(2, n_train=300, n_test=0, V=500, n_labels=30, max_labels=4,
                       mean_types=20.0, max_types=64)
    docs = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) for d in c.train_docs]
    return LocalLDA(docs, alpha=ALPHA, beta=BETA, K=K, seed=4, sweep=sweep, device=device)


@pytest.mark.cuda
@pytest.mark.parametrize("sweep,K", [("fused", 20), ("fused", 50), ("fused", 100),
                                     ("fused", 300), ("dense", 20)])
def test_local_lda_sweeps_on_card_equal_cpu(sweep, K):
    """Three LocalLDA sweeps from one state and the same uniforms: on the
    card (kernel 1 on the staged route at K = 20, on the warp route at K =
    50 and 100 and on the wide route at K = 300, or the dense sweep's
    graphed kernels) and on the CPU (the plain versions) give the same
    bits."""
    from lda_thesis_tpu_torch.ops import gibbs_fused as tfused

    _needs_card()
    card, cpu = _local_lda(K, sweep, "cuda"), _local_lda(K, sweep, "cpu")
    st = card.counts
    cpu.counts = type(st)(*([t.to("cpu", copy=True) for t in part] if isinstance(part, tuple)
                            else part.to("cpu", copy=True) for part in st))
    gen = torch.Generator().manual_seed(5)
    us = [[torch.rand(tuple(tv.shape), generator=gen) for tv in card._toks_v_t]
          for _ in range(3)]
    ends = []
    for m in (card, cpu):
        dev = m.device
        if sweep == "fused":
            before = chip_smoke._route_counts(fbc)
            for sw in us:
                m.counts = tfused.fused_train_block_buckets(
                    m.counts, m._toks_v_t, m._toks_f_t, m.lab_ids_t, m._lab_valid_tt,
                    m.a, m.b, 1, uniforms=[u[None].to(dev) for u in sw])
            if dev.type == "cuda":
                n = 3 * m.buckets.n_buckets
                after = chip_smoke._route_counts(fbc)
                assert tuple(a - b for a, b in zip(after, before)) == (
                    n, n if 32 < K <= 256 else 0, n if K > 256 else 0, 0)
            state = [*m.counts.z, *m.counts.n_dk, m.counts.n_vk, m.counts.n_k]
        else:
            st = m.counts
            z_t = [z.T.clone(memory_format=torch.contiguous_format) for z in st.z]
            runs = [tgibbs.ExactSweep(z_t[g], st.n_dk[g], st.n_vk, st.n_k, m._toks_v_t[g],
                                      m._toks_f_t[g], m.labs_t[g], m.a, m.b, m.V * m.b)
                    for g in range(m.buckets.n_buckets)]
            for sw in us:
                for run, u in zip(runs, sw):
                    run(uniforms=u.to(dev))
            state = [*z_t, *st.n_dk, st.n_vk, st.n_k]
        ends.append([t.cpu() for t in state])
    assert all(_same_bits(a, b) for a, b in zip(*ends))
    n_vk, n_k = ends[0][-2:]
    assert torch.equal(n_k, n_vk.sum(0)) and float(n_vk.sum()) == card.n_tokens


HSLDA_FORMS = ["opt1", "opt2-sparse", "opt3"]  # the model's three couplings


@pytest.mark.cuda
@pytest.mark.parametrize("form", HSLDA_FORMS)
def test_hslda_replayed_cycles_equal_eager(form):
    """Two HSLDA training calls of 6 cycles and 2 saves each through the
    model's cycle and save runners (the first call's first cycle and save
    eager, their second calls captured, the rest replayed) against the
    eager loop from the same state: z, the counts, η, a, β, φ̂, z̄ and the
    generator bitwise equal; the second call captures nothing."""
    _needs_card()
    opt, _ = chip_smoke.HSLDA_FORMS[form]
    docs, labs, labelset = chip_smoke.hslda_small_problem(0)
    r = chip_smoke.hslda_replay_case("cuda", docs, labs, labelset, 0, opt, 6, 3,
                                     chip_smoke.HSLDA_SMALL_K)
    torch.cuda.synchronize()
    assert r["equal"] and r["added"] == [[2, 2], [0, 0]]
    assert opt in r["model"]._cycle._graphs


@pytest.mark.cuda
def test_hslda_chain_cycles_replay_equal_eager_and_single_chains():
    """A one-rank DistributedHSLDA of three chains: a training call through
    its loop's cycle runner (replayed) equals the eager loop bitwise, and
    at least 99% of its draws equal three single-chain runners' (batched
    matmuls may round otherwise; chip_smoke.py's phase 14a at full width)."""
    _needs_card()
    docs, labs, labelset = chip_smoke.hslda_small_problem(0)
    r = chip_smoke.hslda_chain_runners_case("cuda", docs, labs, labelset, 0, 3, 6, 3,
                                            chip_smoke.HSLDA_SMALL_K)
    torch.cuda.synchronize()
    assert r["equal"] and r["equal_draws"] >= chip_smoke.MIN_EQUAL_DRAWS
    assert 1 in r["model"]._loops[1]._run._graphs


@pytest.mark.cuda
@pytest.mark.parametrize("form", list(chip_smoke.HSLDA_FORMS))
def test_hslda_cycle_on_card_equals_cpu(form):
    """One HSLDA cycle of every coupling form on the card against the CPU,
    from one state and one set of draws."""
    _needs_card()
    out = chip_smoke.hslda_cycle_case("cuda", 0, form)
    assert float((out["cuda"][0] == out["cpu"][0]).to(torch.float32).mean()) >= 0.99
    for got, want in zip(out["cuda"][4:], out["cpu"][4:]):
        assert float((got - want).abs().max()) <= chip_smoke.HSLDA_TOL


@pytest.mark.cuda
def test_batched_chains_equal_single_chain_launches():
    """Three chains in one merge-block launch (their documents side by
    side) against three single-chain launches with the same uniforms: z,
    n_dk and the tables bitwise equal, one launch against three (the check
    of chip_smoke.py's phase 13a, here at a small size)."""
    _needs_card()
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import Dictionary
    from lda_thesis_tpu_torch.parallel import DistributedLabeledLDA, make_mesh

    c = planted_corpus(0, n_train=200, n_test=10, V=300, n_labels=30)
    model = DistributedLabeledLDA(c.train_docs, c.train_labs, c.labelset,
                                  Dictionary(c.train_docs), alpha=ALPHA, beta=BETA,
                                  mesh=make_mesh(device="cuda"), n_chains=3, seed=0)
    rec = chip_smoke.chains_batch_case(model, 4)
    assert rec["launches_batched"] == 1 and rec["launches_single"] == 3


@pytest.mark.cuda
@pytest.mark.parametrize("C,D,K", [(3, 37, 40), (8, 300, 512), (3, 50, 1100), (1, 64, 24)],
                         ids=lambda x: str(x))
def test_batched_draw_and_commit_kernels_equal_plain_and_single_chain(C, D, K):
    """One sweep position over a chain axis: the commit and draw kernels,
    one launch each for all C chains, equal their plain versions on the
    same inputs and one single-chain launch per chain, bitwise (a ragged
    live list with an f = 0 row; K = 1,100 takes the two-pass draw)."""
    _needs_card()
    t = chip_smoke.chain_step_inputs("cuda", C + D + K, C, D, K, 60)
    chip_smoke.chain_step_check(t, ALPHA, BETA, 0.6, f"C={C}, D={D}, K={K}")


@pytest.mark.cuda
def test_batched_exact_sweep_replays_equal_single_chain_replays():
    """Three chains in one ExactSweep against three single-chain
    ExactSweeps from the same generators, four sweeps (eager, capture, two
    replays): z and every count bitwise; each batched sweep counts one
    sweep's launches, not three."""
    _needs_card()
    rng = np.random.default_rng(4)
    D, U, V, K, L = 300, 16, 80, 128, 3
    tok_v = torch.from_numpy(rng.integers(0, V, size=(D, U))).cuda()
    tok_f = torch.from_numpy(rng.integers(0, 4, size=(D, U))).cuda()
    tok_f[:, -1] = 0
    labs = torch.from_numpy((rng.random((D, K)) < 0.1).astype(np.float32)).cuda()
    labs[:, 0] = 1.0
    states = []
    for c in range(L):
        s = tgibbs.init_counts(tok_v, tok_f, labs, V,
                               generator=torch.Generator("cuda").manual_seed(c))
        states.append((s.z.T.contiguous(), s.n_dk, s.n_vk, s.n_k))
    batched = [torch.stack([st[i] for st in states]) for i in range(4)]
    singles = [[x.clone() for x in st] for st in states]
    args = (tok_v.T.contiguous(), tok_f.T.to(torch.float32).contiguous(), labs, ALPHA, BETA,
            V * BETA)
    run = tgibbs.ExactSweep(*batched, *args)
    runs = [tgibbs.ExactSweep(*st, *args) for st in singles]
    plan = chip_smoke.planned_sweep_launches(args[1])
    g_b = [torch.Generator("cuda").manual_seed(10 + c) for c in range(L)]
    g_s = [torch.Generator("cuda").manual_seed(10 + c) for c in range(L)]
    for _ in range(4):
        d0, c0 = duc.launches, duc.commit_launches
        run(g_b)
        assert (duc.launches - d0, duc.commit_launches - c0) == plan
        for r, g in zip(runs, g_s):
            r(g)
    torch.cuda.synchronize()
    assert run._graph is not None and all(r._graph is not None for r in runs)
    for c in range(L):
        assert all(_same_bits(b[c], s) for b, s in zip(batched, singles[c])), c
    assert torch.equal(batched[3], batched[2].sum(dim=1))


@pytest.mark.cuda
def test_hslda_batched_sweep_equals_single_chain_sweeps():
    """Three HSLDA chains in one z-sweep (their documents side by side, one
    CUDA graph) against three single-chain sweeps with the same generators,
    three sweeps each: the batched graph's replays equal its eager sweeps
    bitwise, every chain keeps its count invariants, and at least 99% of the
    draws equal the single-chain ones (batched matmuls may round otherwise;
    chip_smoke.py's phase 14a at full width)."""
    _needs_card()
    docs, labs, labelset = chip_smoke.hslda_small_problem(0)
    r = chip_smoke.hslda_chains_case("cuda", docs, labs, labelset, 0, 3, 3,
                                     chip_smoke.HSLDA_SMALL_K)
    torch.cuda.synchronize()
    sweep, bufs = r["graphed"]
    assert sweep._graph is not None
    assert all(_same_bits(a, b) for a, b in zip(bufs, r["eager"][1]))
    total = r["model"].n_tokens
    for c in range(3):
        n_dk, n_vk, n_k = bufs[1][c], bufs[2][c], bufs[3][c]
        assert int(n_dk.sum()) == int(n_vk.sum()) == int(n_k.sum()) == total
        assert torch.equal(n_vk.sum(dim=0, dtype=torch.int32), n_k)
    assert r["equal_draws"] >= chip_smoke.MIN_EQUAL_DRAWS


def _foldin_problem(seed, D=300, U=24, K=40, V=120, chains=1, alpha_form="per_row",
                    edges=False):
    """Held-out documents (a third of the slots empty), a frozen φ and a
    state of them, on the card.  With ``chains`` C the D rows are C chains'
    documents side by side over stacked ``(C·V, K)`` tables, as
    ``models/hslda.chains_test_loop`` lays them out.  α is ``per_row``
    ``(D, K)``, ``per_topic`` ``(K,)`` or ``scalar`` (0.1).  ``edges``:
    document 0 reads only word 0, whose φ rows are all zero (totals 0), and
    document 1 has no live position."""
    rng = np.random.default_rng(seed)
    Dc = D // chains
    tok_v = rng.integers(0, V, size=(Dc, U))
    tok_f = rng.integers(1, 4, size=(Dc, U)) * (rng.random((Dc, U)) > 0.33)
    phi = np.concatenate([rng.dirichlet(np.ones(V), size=K).T.astype(np.float32)
                          for _ in range(chains)])
    if edges:
        tok_v[0], tok_f[1], phi[::V] = 0, 0, 0.0
    rows = np.repeat(np.arange(chains), Dc)
    tok_v = np.tile(tok_v, (chains, 1)) + (V * rows)[:, None]
    tok_f = np.tile(tok_f, (chains, 1))
    z = rng.integers(0, K, size=(D, U)).astype(np.int32)
    n_dk = np.zeros((D, K), np.float32)
    for d in range(D):
        np.add.at(n_dk[d], z[d], tok_f[d].astype(np.float32))
    alpha = (rng.random((D, K)) * 0.2 + 0.01).astype(np.float32)
    if alpha_form == "per_topic":
        alpha = alpha[0]
    out = [torch.from_numpy(x).cuda() for x in (z, n_dk, tok_v, tok_f, phi, alpha)]
    if alpha_form == "scalar":
        out[-1] = ALPHA
    return out


# (D, U, K, V, chains, α): the first two are the cases this test had; then
# both prediction cells' shapes (llda_d3: K = 512, a number; hslda_jel:
# K = 15, α·β per topic), HSLDA's chains over stacked tables, chunks of 64
# topics (D = 100, K = 512), of 128 (K = 1,024) and of 256 (the kernel's
# wide route, K = 1,100), and of 1,024 past the rule's unsigned wrap
# (D = 9,000, K = 15); then the kernel's other register rows (K = 100, 200,
# 1,000) and D = 2, the fewest rows torch does not scan with CUB (chunks of
# 512 topics).
FOLDIN_SHAPES = {
    "scalar": (300, 24, 40, 120, 1, "scalar"),
    "per_row": (300, 24, 40, 120, 1, "per_row"),
    "llda_d3": (464, 128, 512, 600, 1, "scalar"),
    "hslda_jel": (464, 200, 15, 600, 1, "per_topic"),
    "hslda_chains4": (4 * 464, 200, 15, 300, 4, "per_row"),
    "W64-D100-K512": (100, 40, 512, 200, 1, "per_row"),
    "W128-D50-K1024": (50, 40, 1024, 200, 1, "scalar"),
    "wide-W256-D64-K1100": (64, 24, 1100, 200, 1, "per_row"),
    "W1024-D9000-K15": (9000, 24, 15, 200, 1, "per_row"),
    "K100": (200, 30, 100, 150, 1, "per_topic"),
    "W128-D20-K200": (20, 30, 200, 150, 1, "scalar"),
    "K1000": (600, 20, 1000, 150, 1, "per_row"),
    "W512-D2-K512": (2, 60, 512, 150, 1, "per_row"),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FOLDIN_SHAPES))
def test_foldin_replays_equal_eager_sweeps(case, monkeypatch):
    """Four ``FoldinSweep`` calls (eager, capture and replay, replays: one
    fold-in kernel launch each) against four eager ``foldin_sweep`` calls
    (the plain PyTorch body) from one state and seed: z, n_dk and the
    running average bitwise after each (chip_smoke.py's phase 15 at full
    width), and the kernel's counter one launch up per call, none for the
    capture itself."""
    _needs_card()
    from lda_thesis_tpu_torch.ops import foldin_cuda

    D, U, K, V, chains, form = FOLDIN_SHAPES[case]
    z, n_dk, tok_v, tok_f, phi, alpha = _foldin_problem(0, D, U, K, V, chains, form,
                                                        edges=True)
    counts = []
    real = tgibbs.FoldinSweep.__call__

    def counted(self, *a, **k):
        before = foldin_cuda.launches
        real(self, *a, **k)
        counts.append(foldin_cuda.launches - before)

    monkeypatch.setattr(tgibbs.FoldinSweep, "__call__", counted)
    run, _ = chip_smoke.foldin_sweeps_case(
        z, n_dk, tok_v, tok_f, phi, alpha, 0,
        lambda x: x / torch.clamp(x.sum(dim=1, keepdim=True), min=1.0), sweeps=4)
    torch.cuda.synchronize()
    assert run._graph is not None and run.calls == 4
    assert counts == [1, 1, 1, 1]


@pytest.mark.cuda
def test_cascade_replays_equal_eager_sweeps():
    """Four ``CascadeSweep`` calls, each position's Gumbel noise drawn into
    its slice of the static buffer, against four eager ``cascade_sweep``
    calls drawing at each position: z and n_dk bitwise after each."""
    _needs_card()
    rng = np.random.default_rng(1)
    R, U, V, Kg, Kt = 200, 16, 80, 30, 8
    tok_v = rng.integers(0, V, size=(R, U))
    tok_f = rng.integers(0, 4, size=(R, U))
    phi = rng.dirichlet(np.ones(V), size=Kg).T.astype(np.float32)
    phi[0] = 0.0  # a word with no mass: the (φ + β) fallback
    lab_ids = np.stack([rng.choice(Kg, Kt, replace=False) for _ in range(R)])
    lab_mask = (np.arange(Kt)[None, :] < rng.integers(2, Kt + 1, size=(R, 1))).astype(np.float32)
    args = [torch.from_numpy(x).cuda() for x in (tok_v, tok_f, phi, lab_ids, lab_mask)]
    run, _ = chip_smoke.cascade_sweeps_case(*args, ALPHA, BETA, 0, sweeps=4)
    torch.cuda.synchronize()
    assert run._graph is not None and run.calls == 4


@pytest.mark.cuda
def test_log_likelihood_replays_equal_eager():
    """``LogLikelihood`` called with four (θ, φ) pairs, the last two
    replayed, each bitwise equal to ``log_likelihood``."""
    _needs_card()
    _, n_dk, tok_v, tok_f, phi, _ = _foldin_problem(2)
    run = tgibbs.LogLikelihood(tok_v, tok_f)
    for i in range(4):
        theta = (n_dk + ALPHA * (i + 1)) / (n_dk + ALPHA * (i + 1)).sum(dim=1, keepdim=True)
        got, want = run(theta, phi * (1 + i)), tgibbs.log_likelihood(theta, phi * (1 + i),
                                                                     tok_v, tok_f)
        assert _same_bits(got[0], want[0]) and int(got[1]) == int(want[1])
    assert run._graph is not None


@pytest.mark.cuda
def test_run_test_sees_new_phi():
    """Two ``run_test`` calls with training between: each equals an eager
    fold-in from the same generator state, bitwise, the second against the
    new φ̂, so the two differ."""
    _needs_card()
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import Dictionary
    from lda_thesis_tpu_torch.models import labeled_lda
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA

    c = planted_corpus(0, n_train=200, n_test=30, V=300, n_labels=30)
    model = LabeledLDA(c.train_docs, c.train_labs, c.labelset, Dictionary(c.train_docs),
                       alpha=ALPHA, beta=BETA, seed=0, device="cuda")
    model.run_training(10, 5)
    with chip_smoke._recording(labeled_lda, "fold_in_test") as calls:
        first = model.run_test(c.test_docs, 6, 3)
        model.run_training(10, 5)
        second = model.run_test(c.test_docs, 6, 3)
    for n, call in enumerate(calls):
        chip_smoke._same_as_eager(chip_smoke.eager_fold_in, call, f"run_test {n + 1}")
    assert torch.equal(calls[1][0][0], model.ph_hat)
    assert not torch.equal(calls[0][0][0], calls[1][0][0]) and not np.array_equal(first, second)


@pytest.mark.cuda
@pytest.mark.parametrize("name, route, chains", [
    ("interior gaps", "staged", 0), ("interior gaps", "staged", 3), ("A=56", "warp", 0),
    (f"A={32 * fbc.WARP_ROWS_MAX + 8}", "wide", 0),
    (f"A={32 * fbc.WARP_ROWS_MAX + 8}", "wide", 3),
    ("A=1000", "wide", 0), ("A=16000", "general", 0)])
def test_fused_blocks_replay_equal_eager_blocks(name, route, chains):
    """Four merge blocks of ``FusedBlocks`` (eager, capture and replay,
    replays) at an ``edge_cases`` shape of each route of kernel 1 against
    four eager ``fused_train_block_buckets`` calls from one seed, bitwise
    after each (``chip_smoke.replayed_blocks_case``); the counters count
    every replayed launch, on its route: one per bucket per block."""
    _needs_card()
    r = chip_smoke.replayed_blocks_case("cuda", 0, name, calls=4, chains=chains)
    torch.cuda.synchronize()
    n = 4 * 2
    want = {"staged": (n, 0, 0, 0), "warp": (n, n, 0, 0), "wide": (n, 0, n, 0),
            "general": (n, 0, 0, n)}[route]
    assert r["route"] == route and r["launches"] == want
    assert sorted(r["run"]._graphs) == [2] and r["run"].calls == 4


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["labeled-fused", "labeled-compact", "local", "chains"])
def test_training_replays_equal_eager_loop(kind):
    """Two training calls of each model on the card (the second replays
    every block or sweep) equal ``chip_smoke``'s eager loop of functional
    calls from the state before each, bitwise (phase 16 at full width)."""
    _needs_card()
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import Dictionary
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA
    from lda_thesis_tpu_torch.parallel import make_mesh
    from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA

    c = planted_corpus(0, n_train=300, n_test=20, V=400, n_labels=30)
    dicti = Dictionary(c.train_docs)
    if kind == "chains":
        m = DistributedLabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA, BETA,
                                  mesh=make_mesh(device="cuda"), n_chains=3, n_buckets=2)
        for _ in range(2):
            want = chip_smoke.eager_chains_training(m, 10, 4, 64)
            m.run_training(10, 4, total_iters=64)
            assert chip_smoke.chains_equal(m, want)
        assert sorted(m._loop.blocks.run._graphs) == [2, 4]
        return
    if kind == "local":
        texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) for d in c.train_docs]
        m = LocalLDA(texts, alpha=ALPHA, beta=BETA, K=50, seed=0, device="cuda")
    else:
        m = LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA, BETA, seed=0,
                       sweep=kind.split("-")[1], device="cuda")
    for _ in range(2):
        before = len(getattr(m, "cur_perplx", ()))
        if kind == "labeled-fused":
            want = chip_smoke.eager_training(m, 10, 4, 64, True)
            m.run_training(10, 4, perplexity=True, total_iters=64)
        elif kind == "labeled-compact":
            want = chip_smoke.eager_training(m, 5, 2, None, True)
            m.run_training(5, 2)
        else:
            want = chip_smoke.eager_training(m, 6, 3)
            m.run_training(6, 3)
        assert chip_smoke.training_equal(m, want, before)
    if kind != "labeled-compact":
        assert sorted(m._fused._graphs) == ([1] if kind == "local" else [2, 4])


def _card_model(kind):
    """A small model of ``kind`` on the card (``test_saves_and_second_call_replay``)."""
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import Dictionary
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA
    from lda_thesis_tpu_torch.parallel import make_mesh
    from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA

    c = planted_corpus(0, n_train=300, n_test=20, V=400, n_labels=30)
    dicti = Dictionary(c.train_docs)
    family, sweep = kind.split("-")
    if family == "chains":
        return DistributedLabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA,
                                     BETA, mesh=make_mesh(device="cuda"), n_chains=3,
                                     sweep="dense" if sweep == "dense" else "fused",
                                     n_buckets=2 if sweep == "bucketed" else 1)
    if family == "local":
        texts = [" ".join(chip_smoke.csv_word(int(w[1:])) for w in d) for d in c.train_docs]
        return LocalLDA(texts, alpha=ALPHA, beta=BETA, K=20, seed=0, sweep=sweep,
                        device="cuda")
    return LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, ALPHA, BETA, seed=0,
                      sweep=sweep, device="cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["labeled-fused", "labeled-compact", "labeled-dense",
                                  "local-fused", "local-dense", "chains-bucketed",
                                  "chains-dense"])
def test_saves_and_second_call_replay(kind):
    """Three training calls of each model on the card, the saves and every
    block or sweep replayed from the second save or block on, equal
    ``chip_smoke``'s eager loops (``eager_training`` with ``continue_avg``
    for a ``LabeledLDA``'s later calls, ``eager_chains_training``,
    ``eager_dense_chains_training``) from the state before each, bitwise;
    the second and third calls capture no graph and run no body eagerly
    (``chip_smoke.replay_counts``: the runners' graphs and keys)."""
    _needs_card()
    m = _card_model(kind)
    family = kind.split("-")[0]
    for n in range(3):
        before = chip_smoke.replay_counts(m)
        if family == "chains":
            want = (chip_smoke.eager_dense_chains_training(m, 8, 4) if kind == "chains-dense"
                    else chip_smoke.eager_chains_training(m, 8, 4, 64))
            m.run_training(8, 4, total_iters=64)
            assert chip_smoke.chains_equal(m, want)
        elif family == "labeled":
            perps = len(m.cur_perplx)
            want = chip_smoke.eager_training(m, 8, 4, 64, True, continue_avg=n > 0)
            m.run_training(8, 4, continue_avg=n > 0, total_iters=64)
            assert chip_smoke.training_equal(m, want, perps)
        else:
            want = chip_smoke.eager_training(m, 8, 4, 64)
            m.run_training(8, 4, total_iters=64)
            assert chip_smoke.training_equal(m, want)
        torch.cuda.synchronize()
        after = chip_smoke.replay_counts(m)
        if n == 0:
            assert after[0] == after[1] > 0  # every runner's body captured once
        else:
            assert after == before, (n, before, after)
    assert all(r._graphs for r in chip_smoke._runners(m))
