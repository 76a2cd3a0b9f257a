"""Port's merge-block sampler ops against the JAX package's, same inputs.

Inputs are made with NumPy from a seed and fed to both packages; the JAX
side runs on the CPU through its XLA twin (``fused_block_xla``), which its
own tests hold bitwise to the Pallas kernel.  z and every count must be
equal: the port's cumsum order differs from the twin's ``tril @ w``, so a
draw could differ only on a CDF tie within a few ULPs, which is
measure-zero at these sizes (as tests/test_fused.py argues for its NumPy
oracle).  The CUDA kernel itself is held to ``fused_block_torch`` on the
card (chip_smoke.py, and the ``cuda``-marked test here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu.ops import gibbs_fused as jfused
from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.ops import gibbs_fused as tfused

D, U, A, K, V = 16, 8, 8, 128, 40
ALPHA, BETA = 0.1, 0.01


def _make_problem(D=D, U=U, A=A, gaps=0.0, zero_doc=False, max_labels=4, label_set=20,
                  all_valid=False):
    """tests/test_fused.py's problem: (tok_v, tok_f, lab_ids, lab_valid),
    each document carrying 2..``max_labels`` labels of ``label_set`` (all
    ``A`` with ``all_valid``); optionally a share ``gaps`` of f = 0
    positions inside the documents and a first document whose f is all
    zero."""
    rng = np.random.default_rng(1)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    n_types = rng.integers(2, U + 1, size=(D,))
    tok_f = (np.arange(U)[None, :] < n_types[:, None]).astype(np.int32)
    tok_f *= rng.integers(1, 4, size=(D, U)).astype(np.int32)
    lab_ids = np.zeros((D, A), np.int32)
    lab_valid = np.zeros((D, A), np.float32)
    for d in range(D):
        n_labels = A if all_valid else min(A, rng.integers(2, max_labels + 1))
        ids = np.sort(rng.choice(label_set, size=n_labels, replace=False))
        lab_ids[d, : len(ids)] = ids
        lab_valid[d, : len(ids)] = 1.0
    if gaps:
        tok_f[rng.random((D, U)) < gaps] = 0
    if zero_doc:
        tok_f[0] = 0
    return tok_v, tok_f, lab_ids, lab_valid


# documents with up to A labels, so that draws land in every group of eight
# slots of the port's grouped scan and its group-total prefix decides them
WIDE_24 = dict(D=37, A=24, max_labels=24, label_set=100)
WIDE_32 = dict(D=37, A=32, max_labels=32, label_set=120)
# every slot valid, past the staged kernel's 32 lanes: the warp route's
# shapes (LocalLDA at K = 50 and K = 100, a label set of 136), whose
# group-total prefix spans 7, 13 and 17 groups of eight, and the wide
# route's: the first multiple of 8 past the warp route's widest, LocalLDA
# at K = 300 (A = 304) and K = 1,000, whose prefix spans 33, 38 and 125
# groups over 9, 10 and 32 rows of 32 slots
WIDE_56 = dict(D=37, A=56, label_set=100, all_valid=True)
WIDE_104 = dict(D=37, A=104, label_set=150, all_valid=True)
WIDE_136 = dict(D=37, A=136, label_set=200, all_valid=True)
PAST_WARP = 32 * fbc.WARP_ROWS_MAX + 8
WIDE_PAST_WARP = dict(D=37, A=PAST_WARP, label_set=PAST_WARP + 40, all_valid=True)
WIDE_304 = dict(D=37, A=304, label_set=344, all_valid=True)
WIDE_1000 = dict(D=37, A=1000, label_set=1040, all_valid=True)


@pytest.fixture(scope="module")
def problem():
    return _make_problem()


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _topics(lab_ids) -> int:
    """The topic count: K, or the label set padded to 128 where it is wider."""
    return max(K, -(-(int(lab_ids.max()) + 1) // 128) * 128)


def _jax_state(problem, seed=0):
    tok_v, tok_f, lab_ids, lab_valid = problem
    return jfused.init_fused(jax.random.PRNGKey(seed), jnp.asarray(tok_v),
                             jnp.asarray(tok_f), jnp.asarray(lab_ids),
                             jnp.asarray(lab_valid), V, _topics(lab_ids))


def _to_torch_state(st):
    return tfused.FusedLDAState(*_t(*(np.asarray(x) for x in st)))


def _assert_state_equal(got, want):
    for name, g, w in zip(("z", "n_dk", "n_vk", "n_k"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _kernel_inputs(problem, st):
    """(U, A, D) cv for the JAX twin, (D, U, A) for the port, and nkg."""
    tok_v, tok_f, lab_ids, lab_valid = problem
    n_vk, n_k = np.asarray(st.n_vk), np.asarray(st.n_k)
    cv_uad = n_vk[tok_v.T[:, None, :], lab_ids.T[None, :, :]]
    nkg = (n_k[lab_ids].T + np.float32(V * BETA)).astype(np.float32)
    return cv_uad, cv_uad.transpose(2, 0, 1), nkg


@pytest.mark.parametrize("M, shape", [
    pytest.param(1, {}, id="1"),
    pytest.param(3, {}, id="3"),
    pytest.param(3, dict(A=1), id="A1"),
    pytest.param(3, dict(zero_doc=True), id="zero-doc"),
    pytest.param(3, dict(gaps=0.4), id="gaps"),
    pytest.param(3, dict(D=37), id="D37"),
    pytest.param(3, WIDE_24, id="A24"),
    pytest.param(3, WIDE_32, id="A32"),
    pytest.param(2, WIDE_56, id="A56"),
    pytest.param(2, WIDE_104, id="A104"),
    pytest.param(2, WIDE_136, id="A136"),
    pytest.param(2, WIDE_PAST_WARP, id=f"A{PAST_WARP}"),
    pytest.param(2, WIDE_304, id="A304"),
    pytest.param(2, WIDE_1000, id="A1000"),
])
def test_fused_block_torch_matches_xla_twin(M, shape):
    problem = _make_problem(**shape)
    tok_v, tok_f, lab_ids, lab_valid = problem
    n_docs, n_pos = tok_v.shape
    n_slots = lab_ids.shape[1]
    st = _jax_state(problem)
    cv_uad, cv_dua, nkg = _kernel_inputs(problem, st)
    u = np.array(jax.random.uniform(jax.random.PRNGKey(7), (M, n_pos, n_docs)))
    f_t = tok_f.T.astype(np.float32)
    z_j, ndk_j = jfused.fused_block_xla(
        jnp.asarray(cv_uad), jnp.asarray(f_t), jnp.asarray(u), st.z,
        jnp.asarray(nkg), jnp.asarray(lab_valid.T), st.n_dk,
        jnp.tril(jnp.ones((n_slots, n_slots), jnp.float32)), ALPHA, BETA, M)
    args = _t(cv_dua, f_t, u, np.asarray(st.z), nkg, lab_valid.T, np.asarray(st.n_dk))
    z_t, ndk_t = fbc.fused_block_torch(*args, ALPHA, BETA)
    if n_slots > 8:  # draws land in the last group of eight slots
        assert (z_t.numpy()[f_t > 0] >= n_slots - 8).any()
    np.testing.assert_array_equal(z_t.numpy(), np.asarray(z_j))
    np.testing.assert_array_equal(ndk_t.numpy(), np.asarray(ndk_j))
    # on CPU tensors the wrapper is the plain version
    z_w, ndk_w = fbc.fused_block(*args, ALPHA, BETA)
    assert torch.equal(z_w, z_t) and torch.equal(ndk_w, ndk_t)


@pytest.mark.parametrize("M, shape", [
    pytest.param(1, {}, id="1"),
    pytest.param(3, {}, id="3"),
    pytest.param(3, WIDE_24, id="A24"),
    pytest.param(3, WIDE_32, id="A32"),
    pytest.param(2, WIDE_56, id="A56"),
    pytest.param(2, WIDE_104, id="A104"),
    pytest.param(2, WIDE_136, id="A136"),
    pytest.param(2, WIDE_PAST_WARP, id=f"A{PAST_WARP}"),
    pytest.param(2, WIDE_304, id="A304"),
    pytest.param(2, WIDE_1000, id="A1000"),
])
def test_fused_train_block_matches_jax(M, shape):
    problem = _make_problem(**shape)
    tok_v, tok_f, lab_ids, lab_valid = problem
    U, D = tok_v.T.shape
    st = _jax_state(problem)
    key = jax.random.PRNGKey(7 + M)
    want = jfused.fused_train_block(
        key, st, jnp.asarray(tok_v.T), jnp.asarray(tok_f.T.astype(np.float32)),
        jnp.asarray(lab_ids), jnp.asarray(lab_valid.T), ALPHA, BETA, M)
    u = np.array(jax.random.uniform(key, (M, U, D), dtype=jnp.float32))
    tv_t, tf_t, li, lv_t, u_t = _t(tok_v.T, tok_f.T.astype(np.float32), lab_ids,
                                   lab_valid.T, u)
    got = tfused.fused_train_block(_to_torch_state(st), tv_t, tf_t, li, lv_t,
                                   ALPHA, BETA, M, uniforms=u_t)
    _assert_state_equal(got, want)


def test_init_counts_compact_matches_jax(problem):
    tok_v, tok_f, lab_ids, lab_valid = problem
    key = jax.random.PRNGKey(3)
    want = jgibbs.init_counts_compact(key, jnp.asarray(tok_v), jnp.asarray(tok_f),
                                      jnp.asarray(lab_ids), jnp.asarray(lab_valid),
                                      V, K)
    u = np.array(jax.random.uniform(key, (U, D), dtype=jnp.float32))
    got = tgibbs.init_counts_compact(*_t(tok_v, tok_f, lab_ids, lab_valid), V, K,
                                     uniforms=torch.from_numpy(u))
    _assert_state_equal(got, want)
    # the fused layout is its transpose
    got_f = tfused.init_fused(*_t(tok_v, tok_f, lab_ids, lab_valid), V, K,
                              uniforms=torch.from_numpy(u))
    assert torch.equal(got_f.z, got.z.T) and torch.equal(got_f.n_dk, got.n_dk.T)


def test_gather_cv_matches_jax(problem):
    tok_v, tok_f, lab_ids, lab_valid = problem
    rng = np.random.default_rng(5)
    n_vk = rng.integers(0, 2**20, size=(V, K)).astype(np.float32)
    want = np.asarray(jfused.gather_cv(jnp.asarray(n_vk), jnp.asarray(tok_v.T),
                                       jnp.asarray(lab_ids)))  # (U, A, D)
    got = tfused.gather_cv(*_t(n_vk, tok_v.T, lab_ids))  # (D, U, A)
    np.testing.assert_array_equal(got.numpy(), want.transpose(2, 0, 1))


def test_scatter_deltas_matches_jax(problem):
    tok_v, tok_f, lab_ids, lab_valid = problem
    st = _jax_state(problem)
    rng = np.random.default_rng(9)
    n_valid = lab_valid.sum(axis=1).astype(int)
    z1 = (rng.random((U, D)) * n_valid[None, :]).astype(np.int32)
    f_t = tok_f.T.astype(np.float32)
    want = jfused._scatter_deltas(st.n_vk, jnp.asarray(tok_v.T), jnp.asarray(f_t),
                                  jnp.asarray(lab_ids), st.z, jnp.asarray(z1))
    got = tfused._scatter_deltas(*_t(np.asarray(st.n_vk), tok_v.T, f_t, lab_ids,
                                     np.asarray(st.z), z1))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_theta_from_fused_matches_jax(problem):
    tok_v, tok_f, lab_ids, lab_valid = problem
    st = _jax_state(problem)
    want = np.asarray(jfused.theta_from_fused(st.n_dk, jnp.asarray(lab_ids),
                                              jnp.asarray(lab_valid), ALPHA, K))
    got = tfused.theta_from_fused(*_t(np.asarray(st.n_dk), lab_ids, lab_valid),
                                  ALPHA, K)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    dense = tfused.densify_ndk_fused(*_t(np.asarray(st.n_dk), lab_ids), K)
    want_dense = jgibbs.densify_ndk(st.n_dk.T, jnp.asarray(lab_ids), K)
    np.testing.assert_array_equal(dense.numpy(), np.asarray(want_dense))


def test_select_merge_block_matches_jax():
    for args in [(25, 25, 2000), (25, 25, 50), (25, 4, 4), (10, 25, 400), (1, 7, 9)]:
        assert tfused.select_merge_block(*args) == jfused.select_merge_block(*args)


# ---- invariants (tests/test_fused.py, on the port)


def _port_state(problem, seed=0):
    g = torch.Generator().manual_seed(seed)
    return tfused.init_fused(*_t(*problem), V, K, generator=g)


def test_init_invariants(problem):
    tok_v, tok_f, lab_ids, lab_valid = problem
    st = _port_state(problem)
    total = float(tok_f.sum())
    assert float(st.n_vk.sum()) == total
    assert float(st.n_dk.sum()) == total
    assert torch.equal(st.n_k, st.n_vk.sum(0))
    valid_count = lab_valid.sum(axis=1).astype(int)
    z = st.z.numpy()
    f = tok_f.T
    for d in range(D):
        assert (z[f[:, d] > 0, d] < valid_count[d]).all()


@pytest.mark.parametrize("M", [1, 2, 4])
def test_block_invariants(problem, M):
    tok_v, tok_f, lab_ids, lab_valid = problem
    st = _port_state(problem)
    total = float(tok_f.sum())
    gen = torch.Generator().manual_seed(10)
    tv_t, tf_t, li, lv_t = _t(tok_v.T, tok_f.T.astype(np.float32), lab_ids, lab_valid.T)
    for _ in range(3):
        st = tfused.fused_train_block(st, tv_t, tf_t, li, lv_t, ALPHA, BETA, M,
                                      generator=gen)
    assert float(st.n_vk.sum()) == total
    assert float(st.n_dk.sum()) == total
    assert float(st.n_vk.min()) >= 0
    assert float(st.n_dk.min()) >= 0
    assert torch.equal(st.n_k, st.n_vk.sum(0))


# ---- the chain axis


def _stack_states(states):
    return tfused.FusedLDAState(*(torch.stack(list(x)) for x in zip(*states)))


@pytest.mark.parametrize("shape", [pytest.param({}, id="A8"), pytest.param(WIDE_24, id="A24")])
def test_chain_axis_matches_jax_per_chain(shape):
    """Three chains through one call over the leading chain axis (their
    documents side by side in one kernel call): each chain's z and counts
    equal JAX's single-chain merge block from that chain's state with its
    uniforms, bitwise."""
    problem = _make_problem(**shape)
    tok_v, tok_f, lab_ids, lab_valid = problem
    n_pos, n_docs = tok_v.T.shape
    M, L = 2, 3
    states = [_jax_state(problem, seed=j) for j in range(L)]
    keys = [jax.random.PRNGKey(20 + j) for j in range(L)]
    j_args = (jnp.asarray(tok_v.T), jnp.asarray(tok_f.T.astype(np.float32)),
              jnp.asarray(lab_ids), jnp.asarray(lab_valid.T), ALPHA, BETA, M)
    wants = [jfused.fused_train_block(k, st, *j_args) for k, st in zip(keys, states)]
    u = np.stack([np.array(jax.random.uniform(k, (M, n_pos, n_docs), dtype=jnp.float32))
                  for k in keys])
    calls = fbc.launches
    got = tfused.fused_train_block(_stack_states([_to_torch_state(st) for st in states]),
                                   *_t(tok_v.T, tok_f.T.astype(np.float32), lab_ids,
                                       lab_valid.T), ALPHA, BETA, M,
                                   uniforms=torch.from_numpy(u))
    assert fbc.launches == calls  # CPU tensors: the plain version, no launch
    assert got.z.shape == (L, n_pos, n_docs) and got.n_vk.shape[0] == L
    for j, want in enumerate(wants):
        _assert_state_equal([x[j] for x in got], want)


def test_chain_axis_buckets_and_generators_equal_single_chains(problem):
    """Two buckets, three chains, each drawing from its own generator: one
    call over the chain axis equals three single-chain calls drawing from
    generators seeded alike, bitwise, and keeps the count invariants."""
    tok_v, tok_f, lab_ids, lab_valid = problem
    L, M = 3, 2
    halves = (slice(0, 9), slice(9, D))
    ins = [[x[h] for h in halves] for x in _t(tok_v, tok_f, lab_ids, lab_valid)]
    singles = [tfused.init_fused_buckets(*ins, V, K, generator=torch.Generator().manual_seed(j))
               for j in range(L)]
    chained = tfused.FusedBucketState(
        tuple(torch.stack([s.z[g] for s in singles]) for g in range(2)),
        tuple(torch.stack([s.n_dk[g] for s in singles]) for g in range(2)),
        torch.stack([s.n_vk for s in singles]), torch.stack([s.n_k for s in singles]))
    args = ([t.T.contiguous() for t in ins[0]], [t.T.float().contiguous() for t in ins[1]],
            ins[2], [t.T.contiguous() for t in ins[3]], ALPHA, BETA, M)
    gens = [torch.Generator().manual_seed(100 + j) for j in range(L)]
    got = tfused.fused_train_block_buckets(chained, *args, generator=gens)
    for j, s in enumerate(singles):
        want = tfused.fused_train_block_buckets(
            s, *args, generator=torch.Generator().manual_seed(100 + j))
        for g in range(2):
            assert torch.equal(got.z[g][j], want.z[g]) and torch.equal(got.n_dk[g][j],
                                                                        want.n_dk[g])
        assert torch.equal(got.n_vk[j], want.n_vk) and torch.equal(got.n_k[j], want.n_k)
    assert torch.equal(got.n_k, got.n_vk.sum(dim=1))
    assert (got.n_vk.sum(dim=(1, 2)) == float(tok_f.sum())).all()


def test_chain_axis_refuses_past_the_kernel_document_limit(problem):
    """More chains x documents than the kernel's int document count is
    refused before anything is gathered or drawn."""
    tok_v, tok_f, lab_ids, lab_valid = problem
    L = tfused.MAX_KERNEL_DOCS // D + 1
    st = _port_state(problem)
    huge = tfused.FusedLDAState(*(x.expand(L, *x.shape) for x in st))  # stride-0 views
    with pytest.raises(ValueError, match="documents per launch"):
        tfused.fused_train_block(huge, *_t(tok_v.T, tok_f.T.astype(np.float32), lab_ids,
                                           lab_valid.T), ALPHA, BETA, 1)


# ---- the wrapper


def _small_args(problem, M=2):
    st = _jax_state(problem)
    _, cv_dua, nkg = _kernel_inputs(problem, st)
    u = np.random.default_rng(2).random((M, U, D)).astype(np.float32)
    tok_v, tok_f, lab_ids, lab_valid = problem
    return list(_t(cv_dua, tok_f.T.astype(np.float32), u, np.asarray(st.z), nkg,
                   lab_valid.T, np.asarray(st.n_dk)))


def test_fused_block_rejects_bad_inputs(problem):
    args = _small_args(problem)
    bad_dtype = list(args)
    bad_dtype[3] = bad_dtype[3].long()
    with pytest.raises(TypeError):
        fbc.fused_block(*bad_dtype, ALPHA, BETA)
    bad_shape = list(args)
    bad_shape[4] = bad_shape[4][:, :-1]
    with pytest.raises(ValueError):
        fbc.fused_block(*bad_shape, ALPHA, BETA)


def test_fused_block_has_no_plain_fallback_off_cpu(problem):
    """A tensor off the CPU goes to the kernel or raises; it never takes
    the plain version."""
    args = [t.to("meta") for t in _small_args(problem)]
    with pytest.raises(ValueError, match="no kernel"):
        fbc.fused_block(*args, ALPHA, BETA)


@pytest.mark.cuda
def test_kernel_matches_plain_version_on_card(problem):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; chip_smoke.py runs this check on the card")
    args = [t.cuda() for t in _small_args(problem, M=3)]
    before = fbc.launches
    z, ndk = fbc.fused_block(*args, ALPHA, BETA)
    z_p, ndk_p = fbc.fused_block_torch(*args, ALPHA, BETA)
    torch.cuda.synchronize()
    assert fbc.launches == before + 1
    assert torch.equal(z, z_p)
    assert torch.equal(ndk.view(torch.int32), ndk_p.view(torch.int32))
