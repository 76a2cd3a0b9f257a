"""Port's exact samplers and draw-update kernel wrapper against the JAX package.

The same NumPy inputs, and the same uniforms, go through both packages on the
CPU.  The JAX side runs ``train_sweep``'s XLA branch, which
``tests/test_pallas_parity.py`` holds bitwise to the Pallas kernel on an
accelerator; the port runs the kernel's plain version ``draw_update_torch``
on CPU tensors.  z and every count must be equal: the port's cumsum is
summed in another order than JAX's ``w @ triu`` matmul, so a draw could
differ only on a CDF tie within a few ULPs, which is measure-zero at these
sizes.  The CUDA kernel itself is held bitwise to ``draw_update_torch`` on
the card (chip_smoke.py and tests/test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lda_thesis_tpu.data.encode import compact_labels
from lda_thesis_tpu.models import state as jstate
from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.models import state as tstate

D, U, K, V = 64, 8, 128, 40
ALPHA, BETA = 0.1, 0.01
SWEEPS = 3

j_init = jax.jit(jgibbs.init_counts, static_argnums=4)
j_sweep = jax.jit(jgibbs.train_sweep, static_argnames=("alpha", "beta"))
j_init_c = jax.jit(jgibbs.init_counts_compact, static_argnums=(5, 6))
j_sweep_c = jax.jit(jgibbs.train_sweep_compact, static_argnames=("alpha", "beta"))


def _problem(seed):
    """Tokens with duplicate words at one position, f = 0 slots (padding at
    the end and gaps inside documents), and labels over the first 100 of
    K = 128 topics (the rest are padded topics)."""
    rng = np.random.default_rng(seed)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    tok_v[:, 2] = rng.integers(0, 3, size=D)  # many docs share a word at position 2
    tok_f = rng.integers(1, 4, size=(D, U)).astype(np.int32)
    tok_f[rng.random((D, U)) < 0.2] = 0
    tok_f[:, -1] = 0
    labs = (rng.random((D, K)) < 0.08).astype(np.float32)
    labs[:, 0] = 1.0
    labs[:, 100:] = 0.0
    return tok_v, tok_f, labs


def _t(*xs):
    return tuple(torch.from_numpy(np.array(x)) for x in xs)


def _uniforms(key, shape):
    return torch.from_numpy(np.array(jax.random.uniform(key, shape, dtype=jnp.float32)))


def _assert_state_equal(got, want):
    for name, g, w in zip(("z", "n_dk", "n_vk", "n_k"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)


def _jax_args(*xs):
    return tuple(jnp.asarray(x) for x in xs)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_init_counts_matches_jax(seed):
    tok_v, tok_f, labs = _problem(seed)
    key = jax.random.PRNGKey(seed)
    want = j_init(key, *_jax_args(tok_v, tok_f, labs), V)
    got = tgibbs.init_counts(*_t(tok_v, tok_f, labs), V, uniforms=_uniforms(key, (U, D)))
    _assert_state_equal(got, want)


@pytest.mark.parametrize("vbeta", [None, 0.37])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_sweep_matches_jax(seed, vbeta):
    tok_v, tok_f, labs = _problem(seed)
    key = jax.random.PRNGKey(10 + seed)
    cj = j_init(key, *_jax_args(tok_v, tok_f, labs), V)
    ct = tgibbs.LDACounts(*_t(*(np.asarray(x) for x in cj)))
    for i in range(SWEEPS):
        k = jax.random.fold_in(key, i + 1)
        cj = j_sweep(k, cj, *_jax_args(tok_v, tok_f, labs), alpha=ALPHA, beta=BETA,
                     vbeta=vbeta)
        ct = tgibbs.train_sweep(ct, *_t(tok_v, tok_f, labs), ALPHA, BETA, vbeta=vbeta,
                                uniforms=_uniforms(k, (U, D)))
        _assert_state_equal(ct, cj)
    assert torch.equal(ct.n_k, ct.n_vk.sum(0))


@pytest.mark.parametrize("vbeta", [None, 0.37])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_train_sweep_compact_matches_jax(seed, vbeta):
    tok_v, tok_f, labs = _problem(seed)
    lab_ids, lab_valid = compact_labels(labs)
    key = jax.random.PRNGKey(20 + seed)
    cj = j_init_c(key, *_jax_args(tok_v, tok_f, lab_ids, lab_valid), V, K)
    ct = tgibbs.init_counts_compact(*_t(tok_v, tok_f, lab_ids, lab_valid), V, K,
                                    uniforms=_uniforms(key, (U, D)))
    _assert_state_equal(ct, cj)
    for i in range(SWEEPS):
        k = jax.random.fold_in(key, i + 1)
        cj = j_sweep_c(k, cj, *_jax_args(tok_v, tok_f, lab_ids, lab_valid), alpha=ALPHA,
                       beta=BETA, vbeta=vbeta)
        ct = tgibbs.train_sweep_compact(ct, *_t(tok_v, tok_f, lab_ids, lab_valid), ALPHA,
                                        BETA, vbeta=vbeta, uniforms=_uniforms(k, (U, D)))
        _assert_state_equal(ct, cj)


def _buckets():
    """Three buckets of different widths sharing one table."""
    parts = []
    for g, (Dg, Ug) in enumerate([(20, 4), (30, 8), (14, 16)]):
        rng = np.random.default_rng(40 + g)
        tv = rng.integers(0, V, size=(Dg, Ug)).astype(np.int32)
        tf = rng.integers(0, 4, size=(Dg, Ug)).astype(np.int32)
        lb = (rng.random((Dg, K)) < 0.08).astype(np.float32)
        lb[:, 0] = 1.0
        lb[:, 100:] = 0.0
        parts.append((tv, tf, lb))
    return [list(x) for x in zip(*parts)]


def _assert_buckets_equal(got, want):
    for g in range(len(want.z)):
        np.testing.assert_array_equal(got.z[g].numpy(), np.asarray(want.z[g]))
        np.testing.assert_array_equal(got.n_dk[g].numpy(), np.asarray(want.n_dk[g]))
    np.testing.assert_array_equal(got.n_vk.numpy(), np.asarray(want.n_vk))
    np.testing.assert_array_equal(got.n_k.numpy(), np.asarray(want.n_k))


@pytest.mark.parametrize("sweep", ["dense", "compact"])
def test_bucket_variants_match_jax(sweep):
    toks_v, toks_f, labs_t = _buckets()
    key = jax.random.PRNGKey(5)
    k_sweep = jax.random.PRNGKey(6)

    def us(k, g):
        return _uniforms(jax.random.fold_in(k, g), toks_v[g].T.shape)

    jv, jf = [jnp.asarray(x) for x in toks_v], [jnp.asarray(x) for x in toks_f]
    tv, tf = [torch.from_numpy(x) for x in toks_v], [torch.from_numpy(x) for x in toks_f]
    init_u = [us(key, g) for g in range(3)]
    sweep_u = [us(k_sweep, g) for g in range(3)]
    if sweep == "dense":
        jl = [jnp.asarray(x) for x in labs_t]
        tl = [torch.from_numpy(x) for x in labs_t]
        want = jgibbs.init_bucket_counts(key, jv, jf, jl, V)
        got = tgibbs.init_bucket_counts(tv, tf, tl, V, uniforms=init_u)
        _assert_buckets_equal(got, want)
        want = jgibbs.train_sweep_buckets(k_sweep, want, jv, jf, jl, ALPHA, BETA)
        got = tgibbs.train_sweep_buckets(got, tv, tf, tl, ALPHA, BETA, uniforms=sweep_u)
    else:
        comp = [compact_labels(x) for x in labs_t]
        A = max(li.shape[1] for li, _ in comp)
        comp = [(np.pad(li, ((0, 0), (0, A - li.shape[1]))),
                 np.pad(lv, ((0, 0), (0, A - lv.shape[1])))) for li, lv in comp]
        jli, jlv = [jnp.asarray(li) for li, _ in comp], [jnp.asarray(lv) for _, lv in comp]
        tli = [torch.from_numpy(li) for li, _ in comp]
        tlv = [torch.from_numpy(lv) for _, lv in comp]
        want = jgibbs.init_bucket_counts_compact(key, jv, jf, jli, jlv, V, K)
        got = tgibbs.init_bucket_counts_compact(tv, tf, tli, tlv, V, K, uniforms=init_u)
        _assert_buckets_equal(got, want)
        want = jgibbs.train_sweep_buckets_compact(k_sweep, want, jv, jf, jli, jlv,
                                                  ALPHA, BETA)
        got = tgibbs.train_sweep_buckets_compact(got, tv, tf, tli, tlv, ALPHA, BETA,
                                                 uniforms=sweep_u)
    _assert_buckets_equal(got, want)


# ---- the draw-update step against a direct evaluation of the XLA step


def _xla_step(u, f, z_old, labs, n_dk, cv, nk_minus, vbeta):
    """lda_thesis_tpu/ops/gibbs.py:205-221 written out (cv already gathered
    after the decrement, n_k already decremented)."""
    Kk = labs.shape[1]
    ff = jnp.asarray(f)
    fo = ff[:, None] * jax.nn.one_hot(z_old, Kk, dtype=jnp.float32)
    n = jnp.asarray(n_dk) - fo
    w = jnp.asarray(labs) * (n + ALPHA) * (jnp.asarray(cv) + BETA) * (
        1.0 / (jnp.asarray(nk_minus) + jnp.float32(vbeta)))
    c = jnp.dot(w, jnp.triu(jnp.ones((Kk, Kk), jnp.float32)),
                preferred_element_type=jnp.float32)
    r = jnp.asarray(u) * c[:, -1]
    z_new = jnp.sum(c < r[:, None], axis=1).astype(jnp.int32)
    z_new = jnp.where(ff > 0, z_new, z_old)
    fn = ff[:, None] * jax.nn.one_hot(z_new, Kk, dtype=jnp.float32)
    return n + fn, z_new, fn.sum(axis=0) - fo.sum(axis=0)


def _step_inputs(seed, Dd, Kk, zero_labs_row=False):
    rng = np.random.default_rng(seed)
    labs = (rng.random((Dd, Kk)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    f = rng.integers(1, 4, size=Dd).astype(np.float32)
    f[rng.random(Dd) < 0.33] = 0.0
    if zero_labs_row:
        labs[3] = 0.0
        f[3] = 0.0
    z_old = (rng.random(Dd) * Kk).astype(np.int32)
    n_dk = rng.integers(0, 20, size=(Dd, Kk)).astype(np.float32)
    n_dk[np.arange(Dd), z_old] += f
    cv = rng.integers(0, 300, size=(Dd, Kk)).astype(np.float32)
    nk_minus = rng.integers(1000, 9000, size=Kk).astype(np.float32)
    u = rng.random(Dd).astype(np.float32)
    return u, f, z_old, labs, n_dk, cv, nk_minus


@pytest.mark.parametrize("shape", [(64, 128, False), (37, 40, True), (50, 512, False),
                                   (9, 7, False), (40, 371, False), (12, 1100, True)],
                         ids=lambda s: f"D{s[0]}-K{s[1]}")
def test_draw_update_torch_matches_xla_step(shape):
    Dd, Kk, zero_row = shape
    u, f, z_old, labs, n_dk, cv, nk_minus = _step_inputs(Dd * Kk, Dd, Kk, zero_row)
    vbeta = 89.69
    want = _xla_step(u, f, z_old, labs, n_dk, cv, nk_minus, vbeta)
    recip = (1.0 / (torch.from_numpy(nk_minus) + vbeta))
    args = _t(u, f, z_old, labs, n_dk, cv)
    before = duc.launches
    got = duc.draw_update(*args[:5], args[5], recip, ALPHA, BETA)
    assert duc.launches == before  # the CPU takes the plain version
    assert got[0] is args[4]  # n_dk is updated in place
    for name, g, w in zip(("n_dk", "z_new", "dnk"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w), err_msg=name)
    if zero_row:
        assert int(got[1][3]) == int(z_old[3]) and np.isfinite(got[0].numpy()).all()


@pytest.mark.parametrize("Kk", [1, 7, 32, 40, 100, 512, 1100])
def test_chunk_cumsum_is_a_cumsum(Kk):
    """The kernel's order: a Hillis–Steele scan within each 32-topic chunk
    plus the running carry of the chunk totals, written out here with
    float32 numpy adds in that order."""
    rng = np.random.default_rng(Kk)
    w = rng.random((5, Kk)).astype(np.float32)
    got = duc._chunk_cumsum(torch.from_numpy(w)).numpy()
    np.testing.assert_allclose(got, np.cumsum(w.astype(np.float64), axis=1), rtol=1e-5)
    n_chunks = -(-Kk // 32)
    lanes = np.zeros((5, n_chunks * 32), np.float32)
    lanes[:, :Kk] = w
    want = np.empty_like(lanes)
    carry = np.zeros(5, np.float32)
    for i in range(n_chunks):
        s = lanes[:, 32 * i:32 * (i + 1)].copy()
        off = 1
        while off < 32:
            s[:, off:] = s[:, off:] + s[:, :-off].copy()
            off *= 2
        want[:, 32 * i:32 * (i + 1)] = carry[:, None] + s
        carry = carry + s[:, 31]
    np.testing.assert_array_equal(got, want[:, :Kk])


def _draw_args():
    u, f, z_old, labs, n_dk, cv, nk_minus = _step_inputs(1, 16, 40)
    return list(_t(u, f, z_old, labs, n_dk, cv, 1.0 / (nk_minus + 50.0)))


def test_draw_update_rejects_bad_inputs():
    bad = _draw_args()
    bad[2] = bad[2].long()
    with pytest.raises(TypeError):
        duc.draw_update(*bad, ALPHA, BETA)
    bad = _draw_args()
    bad[5] = bad[5][:, :-1]
    with pytest.raises(ValueError):
        duc.draw_update(*bad, ALPHA, BETA)


def test_draw_update_has_no_plain_fallback_off_cpu():
    """A tensor off the CPU goes to the kernel or raises; it never takes
    the plain version."""
    args = [t.to("meta") for t in _draw_args()]
    with pytest.raises(ValueError, match="no kernel"):
        duc.draw_update(*args, ALPHA, BETA)


# ---- the port's own invariants


def _np_counts(z, tok_v, tok_f, Kk):
    n_dk = np.zeros((z.shape[0], Kk))
    n_vk = np.zeros((V, Kk))
    for d in range(z.shape[0]):
        for n in range(z.shape[1]):
            n_dk[d, z[d, n]] += tok_f[d, n]
            n_vk[tok_v[d, n], z[d, n]] += tok_f[d, n]
    return n_dk, n_vk


def test_exact_sweep_invariants():
    tok_v, tok_f, labs = _problem(7)
    g = torch.Generator().manual_seed(0)
    c = tgibbs.init_counts(*_t(tok_v, tok_f, labs), V, generator=g)
    for _ in range(SWEEPS):
        c = tgibbs.train_sweep(c, *_t(tok_v, tok_f, labs), ALPHA, BETA, generator=g)
        n_dk, n_vk = _np_counts(c.z.numpy(), tok_v, tok_f, K)
        np.testing.assert_array_equal(c.n_dk.numpy(), n_dk)
        np.testing.assert_array_equal(c.n_vk.numpy(), n_vk)
        assert torch.equal(c.n_k, c.n_vk.sum(0))
        z = c.z.numpy()
        assert all(labs[d, z[d, n]] == 1 for d in range(D) for n in range(U)
                   if tok_f[d, n] > 0)


@pytest.mark.parametrize("Dd, Uu", [(1, 6), (9, 1)], ids=["D1", "U1"])
def test_train_sweep_leaves_input_counts_unmodified(Dd, Uu):
    """The sweep writes z in place into its position-major copy; at D = 1
    or U = 1 a transpose of the caller's z would share its storage."""
    rng = np.random.default_rng(Dd * 10 + Uu)
    tok_v = torch.from_numpy(rng.integers(0, V, size=(Dd, Uu)))
    tok_f = torch.from_numpy(rng.integers(1, 4, size=(Dd, Uu)))
    labs = torch.ones((Dd, K), dtype=torch.float32)
    g = torch.Generator().manual_seed(2)
    c = tgibbs.init_counts(tok_v, tok_f, labs, V, generator=g)
    before = [t.clone() for t in c]
    out = tgibbs.train_sweep(c, tok_v, tok_f, labs, ALPHA, BETA, generator=g)
    assert all(torch.equal(a, b) for a, b in zip(c, before))
    assert not torch.equal(out.z, c.z)  # the sweep did move some topic


def test_compact_sweep_equals_dense():
    """The compact sweep is the same sampler with the zero lanes removed:
    from the same uniforms every draw lands on the same global topic
    (as tests/test_gibbs.py:227 holds for the JAX package)."""
    tok_v, tok_f, labs = _problem(8)
    lab_ids, lab_valid = compact_labels(labs)
    li, lv = _t(lab_ids, lab_valid)
    g = torch.Generator().manual_seed(1)
    u0 = torch.rand((U, D), generator=g)
    cd = tgibbs.init_counts(*_t(tok_v, tok_f, labs), V, uniforms=u0)
    cc = tgibbs.init_counts_compact(*_t(tok_v, tok_f), li, lv, V, K, uniforms=u0)
    for _ in range(SWEEPS):
        u = torch.rand((U, D), generator=g)
        cd = tgibbs.train_sweep(cd, *_t(tok_v, tok_f, labs), ALPHA, BETA, uniforms=u)
        cc = tgibbs.train_sweep_compact(cc, *_t(tok_v, tok_f), li, lv, ALPHA, BETA,
                                        uniforms=u)
    assert torch.equal(cd.z.long(), torch.gather(li.long(), 1, cc.z.long()))
    assert torch.equal(cd.n_vk, cc.n_vk) and torch.equal(cd.n_k, cc.n_k)
    assert torch.equal(cd.n_dk, tgibbs.densify_ndk(cc.n_dk, li, K))


def test_phi_unsmoothed_matches_jax():
    rng = np.random.default_rng(9)
    n_vk = rng.integers(0, 9, size=(V, K)).astype(np.float32)
    n_vk[:, 5] = 0.0  # an empty topic gives a 0 column, not NaN
    mask = (np.arange(K) < 100).astype(np.float32)
    want = jstate.phi_unsmoothed(jnp.asarray(n_vk), jnp.asarray(mask))
    got = tstate.phi_unsmoothed(*_t(n_vk, mask))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

