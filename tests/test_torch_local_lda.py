"""The port's LocalLDA against the JAX package's, and its own contracts.

Both packages build LocalLDA from the same texts; the vocabulary, the
sentence documents and the bucket layout must be equal.  Fed the JAX
model's own uniforms (``jax.random.uniform`` of the keys it folds per
bucket), the port's init and first merge block must give the same z and
counts exactly, at K = 4 (A = 8, the staged kernel's shape), at K = 50
(A = 56, the warp route's shape) and at K = 300 (A = 304, the wide
route's; here on the CPU through the plain version).  The JAX side runs the fused XLA twin, whose ``tril @ w`` scan
differs from the port's grouped scan in the last bits of c (not in the
draws, at these sizes).  Then the port of ``tests/test_local_lda.py``:
invariants, the dense and fused samplers, and a kill/resume through the
LocalLDA checkpoint that equals the uninterrupted run bit for bit.  Last,
whole runs of both packages, whose perplexities must agree in
distribution over three seeds.
"""

import functools

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from chip_smoke import csv_word
from lda_thesis_tpu.models.local_lda import LocalLDA as JaxLocalLDA
from lda_thesis_tpu.ops import gibbs_fused as jfused
from lda_thesis_tpu.utils.checkpoint import save_model as jax_save_model
from lda_thesis_tpu_torch.convert import local_lda_state_from_numpy
from lda_thesis_tpu_torch.data.synthetic import planted_corpus
from lda_thesis_tpu_torch.models.local_lda import LocalLDA
from lda_thesis_tpu_torch.ops import gibbs_fused as tfused
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, restore_model, save_model

DOCS = [
    "The cat sat on the mat. The dog barked loudly! Cats and dogs are pets.",
    "Stock markets rallied today. Investors bought equities, bonds fell.",
    "The economy grew strongly. Inflation remained low - growth continued.",
    "Dogs chase cats around the garden. The garden has many flowers.",
] * 4


def _texts(seed=0, n=60, V=150):
    """A small planted corpus as abstracts: "q"+consonant words, which the
    LocalLDA pipeline keeps unchanged, with sentence marks between."""
    c = planted_corpus(seed, n_train=n, n_test=0, V=V, n_labels=6, max_labels=2,
                       mean_types=12, max_types=24, words_per_label=12)
    rng = np.random.default_rng(seed)
    out = []
    for doc in c.train_docs:
        words = [csv_word(int(w[1:])) for w in doc]
        cut = int(rng.integers(1, len(words)))
        out.append(" ".join(words[:cut]) + ". " + " ".join(words[cut:]) + "!")
    return out


def _port(docs, **kw):
    kw.setdefault("device", "cpu")
    return LocalLDA(docs, **kw)


SEED = 2


@functools.lru_cache(maxsize=None)
def _jax_model(K, local_lda=True):
    """The JAX LocalLDA of ``_texts(1)`` (two buckets), built once per
    configuration: its constructor compiles the init per bucket."""
    return JaxLocalLDA(_texts(1), 0.1, 0.01, K=K, local_lda=local_lda, seed=SEED,
                       n_buckets=2)


@pytest.mark.parametrize("local_lda", [True, False], ids=["sentences", "whole-docs"])
def test_vocabulary_and_buckets_equal_jax(local_lda):
    jm = _jax_model(4, local_lda)
    pm = _port(_texts(1), alpha=0.1, beta=0.01, K=4, local_lda=local_lda, n_buckets=2)
    assert pm.word2id.token2id == jm.word2id.token2id
    assert (pm.V, pm.D, pm.Kp, pm.A, pm.n_tokens) == (jm.V, jm.D, jm.Kp, jm.A, jm.n_tokens)
    assert pm.buckets.n_buckets == jm.buckets.n_buckets == 2
    for name in ("doc_idx", "tok_v", "tok_f"):
        for a, b in zip(getattr(pm.buckets, name), getattr(jm.buckets, name)):
            np.testing.assert_array_equal(a, b, err_msg=name)
    for a, b in zip(pm.lab_ids_t, jm.lab_ids_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(pm.lab_valid_t, jm.lab_valid_t):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def _state_equal(got, want):
    for name, g, w in zip(("z", "n_dk"), (got.z, got.n_dk), (want.z, want.n_dk)):
        for a, b in zip(g, w):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b), err_msg=name)
    np.testing.assert_array_equal(got.n_vk.numpy(), np.asarray(want.n_vk))
    np.testing.assert_array_equal(got.n_k.numpy(), np.asarray(want.n_k))


@pytest.mark.parametrize("K", [4, 50, 300])
def test_init_and_first_merge_block_match_jax(K):
    jm = _jax_model(K)
    pm = _port(_texts(1), alpha=0.1, beta=0.01, K=K, seed=SEED, n_buckets=2)
    assert pm.A == jm.A == ((K + 7) // 8) * 8
    # the JAX constructor's init key, and its per-bucket uniforms
    _, k0 = jax.random.split(jax.random.PRNGKey(SEED))
    u0 = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(k0, g), tuple(tv.T.shape), dtype=jnp.float32)))
        for g, tv in enumerate(pm.toks_v)]
    init = tfused.init_fused_buckets(pm.toks_v, pm.toks_f, pm.lab_ids_t, pm.lab_valid_t,
                                     pm.V, pm.Kp, uniforms=u0)
    _state_equal(init, jm.counts)

    key = jax.random.PRNGKey(11)
    M = 1
    want = jfused.fused_train_block_buckets(
        key, jm.counts, jm._toks_v_t, jm._toks_f_t, jm.lab_ids_t, jm._lab_valid_tt,
        jm.a, jm.b, M, identity_slots=True, table_i16=jm._table_i16)
    u1 = [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.fold_in(key, g), (M, *tv.shape), dtype=jnp.float32)))
        for g, tv in enumerate(pm._toks_v_t)]
    got = tfused.fused_train_block_buckets(init, pm._toks_v_t, pm._toks_f_t, pm.lab_ids_t,
                                           pm._lab_valid_tt, pm.a, pm.b, M, uniforms=u1)
    _state_equal(got, want)
    # the block moved tokens, and into every group of eight topics at K = 50,
    # past the first 256 slots (the warp route's widest) at K = 300
    moved = np.concatenate([(np.asarray(a) != np.asarray(b)).ravel()
                            for a, b in zip(got.z, init.z)])
    assert moved.any()
    if K > 32:
        assert max(int(z.max()) for z in got.z) >= 48
    if K > 256:
        assert max(int(z.max()) for z in got.z) >= 256


def test_train_and_estimators():
    m = _port(DOCS, alpha=0.5, beta=0.1, K=4, seed=0)
    assert m.sweep == "fused" and m.D > len(DOCS)
    m.run_training(10, 5)
    assert m._merge_M == 1
    ph, th = m.get_phi(), m.get_theta()
    assert ph.shape == (4, m.V) and th.shape == (m.D, 4)
    np.testing.assert_allclose(ph.sum(axis=1), 1.0, rtol=1e-4)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-4)
    assert m.ph_hat.shape == (4, m.V) and m.th_hat.shape == (m.D, 4)
    np.testing.assert_allclose(m.ph_hat.sum(axis=1), 1.0, rtol=1e-4)
    top = m.print_topwords(5)
    assert len(top) == 4 and all(len(row) == 6 for row in top)
    assert m.perplexity() > 1.0


@pytest.mark.parametrize("sweep", ["fused", "dense"])
def test_counts_conserved(sweep):
    m = _port(DOCS, alpha=0.5, beta=0.1, K=4, seed=1, sweep=sweep)
    total = m.n_tokens
    m.run_training(5, 5)
    st = m.counts
    assert sum(float(x.sum()) for x in st.n_dk) == total
    assert float(st.n_vk.sum()) == total
    assert float(st.n_vk.min()) >= 0 and min(float(x.min()) for x in st.n_dk) >= 0
    assert torch.equal(st.n_vk.sum(dim=0), st.n_k)
    if sweep == "dense":  # z back in the JAX package's (D_g, U_g) layout
        for z, tv in zip(st.z, m.toks_v):
            assert z.shape == tv.shape and z.dtype == torch.int32


def test_whole_doc_mode():
    m = _port(DOCS, alpha=0.5, beta=0.1, K=3, local_lda=False, seed=0)
    assert m.D <= len(DOCS)
    m.run_training(3, 3)
    assert m.get_theta().shape[1] == 3


def test_fused_vs_dense_same_structure():
    md = _port(DOCS, alpha=0.5, beta=0.1, K=4, seed=0, sweep="dense")
    md.run_training(20, 10)
    mf = _port(DOCS, alpha=0.5, beta=0.1, K=4, seed=0)
    mf.run_training(20, 10)
    np.testing.assert_allclose(md.get_phi().sum(axis=1), 1.0, rtol=1e-4)
    pd_, pf = md.perplexity(), mf.perplexity()
    assert 1.0 < pf < md.V and 1.0 < pd_ < md.V
    assert pf < 3.0 * pd_ and pd_ < 3.0 * pf


def test_unknown_sweep_and_default_device():
    with pytest.raises(ValueError, match="unknown sweep"):
        _port(DOCS, alpha=0.5, beta=0.1, K=4, sweep="compact")
    if not torch.cuda.is_available():
        with pytest.raises((RuntimeError, AssertionError)):
            LocalLDA(DOCS, alpha=0.5, beta=0.1, K=4)


@pytest.mark.parametrize("sweep", ["fused", "dense"])
def test_checkpoint_resume_bit_identical(tmp_path, sweep):
    """Kill/resume through the LocalLDA checkpoint reproduces the
    uninterrupted chain bit for bit: counts, means and generator state."""
    kw = dict(alpha=0.5, beta=0.1, K=4, seed=3, sweep=sweep)
    full = _port(DOCS, **kw)
    full.run_training(4, 4, total_iters=8)
    full.run_training(4, 4, total_iters=8)

    part = _port(DOCS, **kw)
    part.run_training(4, 4, total_iters=8)
    path = str(tmp_path / "ck")
    save_model(path, part, {"iters_done": 4})
    arrays, meta = load_checkpoint(path)
    assert meta["kind"] == "LocalLDA" and meta["sweep"] == sweep
    assert meta["token2id"] == part.word2id.token2id
    assert (meta.get("sampler_formula") is not None) == (sweep == "fused")
    assert arrays["ph_hat"].shape == (4, part.V)

    resumed = _port(DOCS, **kw)
    assert restore_model(path, resumed)["iters_done"] == 4
    np.testing.assert_array_equal(resumed.ph_hat, part.ph_hat)
    resumed.run_training(4, 4, total_iters=8)
    for a, b in zip(full.counts.z, resumed.counts.z):
        assert torch.equal(a, b)
    for a, b in zip(full.counts.n_dk, resumed.counts.n_dk):
        assert torch.equal(a, b)
    assert torch.equal(full.counts.n_vk, resumed.counts.n_vk)
    assert torch.equal(full._gen.get_state(), resumed._gen.get_state())
    np.testing.assert_array_equal(full.ph_hat, resumed.ph_hat)
    np.testing.assert_array_equal(full.th_hat, resumed.th_hat)


def test_checkpoint_guards(tmp_path):
    path = str(tmp_path / "ck")
    docs = _texts()
    m = _port(docs, alpha=0.5, beta=0.1, K=4, seed=3)
    save_model(path, m)  # untrained: no means yet
    assert "ph_hat" not in load_checkpoint(path)[0]
    fresh = _port(docs, alpha=0.5, beta=0.1, K=4, seed=4)
    restore_model(path, fresh)
    assert fresh.ph_hat is None and torch.equal(fresh.counts.n_vk, m.counts.n_vk)
    with pytest.raises(ValueError, match="sweep kernel mismatch"):
        restore_model(path, _port(docs, alpha=0.5, beta=0.1, K=4, sweep="dense"))
    with pytest.raises(ValueError, match="bucket count mismatch"):
        restore_model(path, _port(docs, alpha=0.5, beta=0.1, K=4, n_buckets=2))
    m.run_training(8, 4, total_iters=16)  # M = 1 at merge_every = 1
    save_model(path, m)
    other = _port(docs, alpha=0.5, beta=0.1, K=4, merge_every=2)
    restore_model(path, other)
    with pytest.raises(ValueError, match="merge-block mismatch"):
        other.run_training(8, 4, total_iters=16)


def test_jax_checkpoint_restores_with_stream_warning(tmp_path):
    """A JAX LocalLDA checkpoint (counts and thinned means) loads into the
    port as it is; the means stand in for a trained run's."""
    jm = _jax_model(4)
    rng = np.random.default_rng(0)
    jm.ph_hat = rng.random((jm.K, jm.V)).astype(np.float32)
    jm.th_hat = rng.random((jm.D, jm.K)).astype(np.float32)
    path = str(tmp_path / "jax")
    jax_save_model(path, jm)
    jm.ph_hat = jm.th_hat = None
    pm = _port(_texts(1), alpha=0.1, beta=0.01, K=4, seed=0, n_buckets=2)
    with pytest.warns(UserWarning, match="threefry"):
        restore_model(path, pm)
    _state_equal(pm.counts, jm.counts)
    arrays = np.load(path + ".npz")
    np.testing.assert_array_equal(pm.ph_hat, arrays["ph_hat"])
    np.testing.assert_array_equal(pm.th_hat, arrays["th_hat"])
    np.testing.assert_allclose(pm.get_phi(), jm.get_phi(), rtol=1e-6)
    np.testing.assert_allclose(pm.get_theta(), jm.get_theta(), rtol=1e-6)
    np.testing.assert_allclose(pm.perplexity(), jm.perplexity(), rtol=1e-6)
    pm.run_training(2, 2)  # and trains on in the port
    assert float(pm.counts.n_vk.sum()) == pm.n_tokens
    # the converter rejects a state of another sampler
    with pytest.raises(ValueError, match="sweep mismatch"):
        local_lda_state_from_numpy({}, pm, {"sweep": "dense"})


def test_perplexity_agrees_with_jax_over_seeds():
    """Both packages train K = 4 for (30; 10) on ``_jax_model``'s corpus
    and configuration with three seeds each (last in this file, so the JAX
    side reuses the programs the tests above compiled).  The two draw from
    different random streams (threefry and torch's), so the runs cannot
    agree draw for draw: their mean perplexities must agree within three
    times the larger of the two seed spreads (the standard deviation over
    the three seeds)."""
    docs = _texts(1)
    kw = dict(alpha=0.1, beta=0.01, K=4, n_buckets=2)
    jax_p, port_p = [], []
    for seed in range(3):
        jm = JaxLocalLDA(docs, seed=seed, **kw)
        jm.run_training(30, 10)
        jax_p.append(jm.perplexity())
        pm = _port(docs, seed=seed, **kw)
        pm.run_training(30, 10)
        port_p.append(pm.perplexity())
    spread = max(np.std(jax_p), np.std(port_p))
    assert all(1.0 < p < pm.V for p in jax_p + port_p)
    assert abs(np.mean(port_p) - np.mean(jax_p)) <= 3.0 * spread, (port_p, jax_p)
