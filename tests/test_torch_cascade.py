"""Port's CascadeLDA, its fold-in loop and tree reassembly against the JAX package.

``cascade_test_loop`` is held to the JAX function draw for draw: the Gumbel
noise of each position is made with JAX, from the keys the JAX function
splits, and passed to the port.  Its logits are computed with another
``log`` implementation, so they may differ by ULPs, which flips an argmax
only on a near-tie; the averages are compared at rtol 1e-6.  The model's
checks are those of tests/test_cascade.py, rerun on the port's
``CascadeLDA(device="cpu")`` over the same toy corpus.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lda_thesis_tpu.data.vocab import Dictionary as JaxDictionary
from lda_thesis_tpu.eval.cascade import setup_theta as jax_setup_theta
from lda_thesis_tpu.models.cascade_lda import CascadeLDA as JaxCascadeLDA
from lda_thesis_tpu.models.cascade_lda import _bucket as jax_bucket
from lda_thesis_tpu.ops import gibbs as jgibbs
from lda_thesis_tpu.ops import sampling as jsampling
from lda_thesis_tpu_torch.data.synthetic import JEL_LETTERS, jel_corpus
from lda_thesis_tpu_torch.data.vocab import Dictionary
from lda_thesis_tpu_torch.eval.cascade import setup_theta
from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA
from lda_thesis_tpu_torch.ops import gibbs as tgibbs
from lda_thesis_tpu_torch.ops import sampling as tsampling

j_cascade = jax.jit(jgibbs.cascade_test_loop,
                    static_argnames=("it", "thinning", "alpha", "beta"))


# ---- ops against the JAX package


def test_mask_and_gumbel_argmax_match_jax():
    rng = np.random.default_rng(0)
    mask = (rng.random((50, 12)) < 0.5).astype(np.float32)
    mask[:, 0] = 1.0
    mask[7] = 0.0  # a row with no admissible topic gives index 0
    np.testing.assert_array_equal(tsampling.mask_to_logits(torch.from_numpy(mask)).numpy(),
                                  np.asarray(jsampling.mask_to_logits(jnp.asarray(mask))))
    logits = np.log(rng.random((50, 12)).astype(np.float32)) + np.where(mask > 0, 0, -np.inf)
    logits = logits.astype(np.float32)
    key = jax.random.PRNGKey(3)
    want = jsampling.gumbel_argmax(key, jnp.asarray(logits), axis=1)
    noise = np.array(jax.random.gumbel(key, logits.shape, dtype=jnp.float32))
    got = tsampling.gumbel_argmax(torch.from_numpy(logits), 1, gumbels=torch.from_numpy(noise))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(got[7]) == 0


def test_gumbel_noise_is_finite():
    g = torch.Generator().manual_seed(0)
    noise = tsampling.gumbel((200_000,), "cpu", generator=g)
    assert torch.isfinite(noise).all()
    assert abs(float(noise.mean()) - 0.5772) < 0.01  # Euler–Mascheroni


def _task_problem(seed):
    """24 tasks over a global φ of 20 topics: local topic lists of 2–8
    labels, one padded task (no labels, f = 0), and a word whose φ is zero
    on every topic, which takes the (φ+β) fallback."""
    rng = np.random.default_rng(seed)
    R, U, Vv, Kg, Kt = 24, 6, 30, 20, 8
    tok_v = rng.integers(0, Vv, size=(R, U)).astype(np.int32)
    tok_v[:, 1] = 0  # word 0 has an all-zero φ row
    tok_f = rng.integers(1, 4, size=(R, U)).astype(np.int32)
    tok_f[rng.random((R, U)) < 0.2] = 0
    phi = rng.dirichlet(np.ones(Vv), size=Kg).T.astype(np.float32)  # (V, Kg)
    phi[0] = 0.0
    phi[rng.random((Vv, Kg)) < 0.2] = 0.0
    lab_ids = np.zeros((R, Kt), np.int32)
    lab_mask = np.zeros((R, Kt), np.float32)
    for r in range(R - 1):
        n = rng.integers(2, Kt + 1)
        lab_ids[r, :n] = rng.choice(Kg, n, replace=False)
        lab_mask[r, :n] = 1.0
    tok_f[R - 1] = 0
    return tok_v, tok_f, phi, lab_ids, lab_mask


def _jax_noise(key, U, shape, it):
    k_init, k_sweeps = jax.random.split(key)
    init = [jax.random.gumbel(k, shape, dtype=jnp.float32)
            for k in jax.random.split(k_init, U)]
    sweeps = [[jax.random.gumbel(k, shape, dtype=jnp.float32)
               for k in jax.random.split(ks, U)]
              for ks in jax.random.split(k_sweeps, it)]
    return torch.from_numpy(np.array(init)), torch.from_numpy(np.array(sweeps))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_cascade_test_loop_matches_jax(seed):
    tok_v, tok_f, phi, lab_ids, lab_mask = _task_problem(seed)
    it, thinning, alpha, beta = 7, 3, 0.1, 0.01
    key = jax.random.PRNGKey(seed)
    want = j_cascade(key, *(jnp.asarray(x) for x in (tok_v, tok_f, phi, lab_ids, lab_mask)),
                     it=it, thinning=thinning, alpha=alpha, beta=beta)
    g_init, g_sweeps = _jax_noise(key, tok_v.shape[1], lab_ids.shape, it)
    got = tgibbs.cascade_test_loop(
        *(torch.from_numpy(x) for x in (tok_v, tok_f, phi, lab_ids, lab_mask)),
        it, thinning, alpha, beta, init_gumbels=g_init, sweep_gumbels=g_sweeps)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)
    # two saves, each a normalised distribution over the task's topics
    np.testing.assert_allclose(got.numpy()[:-1].sum(axis=1), 1.0, rtol=1e-5)
    assert float(got[-1].sum()) == 0.0  # the padded task holds no counts


def test_setup_theta_matches_jax():
    rng = np.random.default_rng(4)
    corpus = jel_corpus(1, n_train=30, n_test=5, V=200, n_l2=12, n_l3=20,
                        max_types=30, mean_types=12)
    labelmap = {l: i for i, l in enumerate(["root"] + corpus.labelset)}
    l1p, l2p, l3p = [], [], []
    for lab in corpus.train_labs:
        one = [x for x in lab if len(x) == 1]
        two = [x for x in lab if len(x) == 2]
        l1p.append([(x, float(rng.random())) for x in one])
        l2p.append([[(x, float(rng.random())) for x in two if x[0] == p] + [(p, 0.1)]
                    for p in one])
        l3p.append([[(x, float(rng.random())) for x in lab if len(x) == 3 and x[:2] == p]
                    for p in two])
    np.testing.assert_array_equal(setup_theta(l1p, l2p, l3p, labelmap),
                                  jax_setup_theta(l1p, l2p, l3p, labelmap))


def test_jel_corpus_has_the_depth3_shape():
    c = jel_corpus(0)
    assert (len(c.train_docs), len(c.test_docs)) == (4171, 464)
    assert len({w for d in c.train_docs for w in d}) == 8969
    by_depth = [sum(len(x) == n for x in c.labelset) for n in (1, 2, 3)]
    assert by_depth == [20, 120, 251]
    assert {x[0] for x in c.labelset} == set(JEL_LETTERS)
    assert {x for lab in c.train_labs for x in lab} == set(c.labelset)
    for lab in c.train_labs + c.test_labs:  # every code carries its ancestors
        assert all(x[:-1] in lab for x in lab if len(x) > 1)
    assert max(len(set(d)) for d in c.train_docs) == 128


# ---- the model (tests/test_cascade.py on the port)


def _toy_corpus():
    """Two disjoint branches: A (animals) and B (finance), depth 3."""
    a_docs = [
        "cat dog cat pet animal fur".split(),
        "dog bark pet animal tail fur".split(),
        "cat purr pet whisker animal".split(),
        "dog cat pet animal play".split(),
    ]
    b_docs = [
        "stock bond market price trade".split(),
        "bond yield market finance price".split(),
        "stock equity trade finance market".split(),
        "price market finance stock bond".split(),
    ]
    a_labs = [["A", "A1", "A11"], ["A", "A1", "A12"],
              ["A", "A2", "A21"], ["A", "A1", "A11"]]
    b_labs = [["B", "B1", "B11"], ["B", "B1", "B12"],
              ["B", "B2", "B21"], ["B", "B1", "B11"]]
    docs = a_docs + b_docs
    labs = a_labs + b_labs
    labelset = sorted({x for lab in labs for x in lab})
    return docs, labs, labelset, Dictionary(docs)


def _model(sweep="auto", **kw):
    docs, labs, labelset, dicti = _toy_corpus()
    kw.setdefault("device", "cpu")
    return CascadeLDA(docs, labs, labelset, dicti, alpha=0.1, beta=0.01, seed=0,
                      sweep=sweep, **kw)


@pytest.fixture(scope="module")
def trained():
    docs, labs, labelset, dicti = _toy_corpus()
    m = _model()
    m.go_down_tree(it=20, s=5)
    return m, docs, labs, dicti


def test_tree_structure(trained):
    m, *_ = trained
    assert m.sweep == "dense"
    assert m.lablist[0] == "root"
    assert set(m.lablist_l1) == {"A", "B"}
    assert set(m.lablist_l2) == {"A1", "A2", "B1", "B2"}
    assert m._children("A") == ["A1", "A2"]
    assert m._children("B1") == ["B11", "B12"]


def test_ph_rows_normalised_and_disjoint(trained):
    """Joint level training factorises: node-A children only put mass on
    words of A-branch documents."""
    m, docs, labs, dicti = trained
    for lab in ["root", "A", "B", "A1", "B2", "A11", "B12"]:
        row = m.ph[m.labelmap[lab]]
        assert row.min() >= 0
        assert 0.0 < row.sum() <= 1.0 + 1e-4
    for lab in ["A", "B"]:
        np.testing.assert_allclose(m.ph[m.labelmap[lab]].sum(), 1.0, rtol=1e-4)

    a_vocab = {dicti.token2id[w] for d, l in zip(docs, labs) if "A" in l for w in d}
    b_vocab = {dicti.token2id[w] for d, l in zip(docs, labs) if "B" in l for w in d}
    only_b = np.array(sorted(b_vocab - a_vocab))
    only_a = np.array(sorted(a_vocab - b_vocab))
    for lab in ["A1", "A2", "A11", "A12", "A21"]:
        assert m.ph[m.labelmap[lab]][only_b].sum() == 0.0
    for lab in ["B1", "B2", "B11", "B12", "B21"]:
        assert m.ph[m.labelmap[lab]][only_a].sum() == 0.0


def test_level_stats(trained):
    m, *_ = trained
    # root (80; 10), then the letter level and the two-char level (20; 5)
    assert [s["sweeps"] for s in m.level_stats] == [80, 20, 20]
    assert [s["rows"] for s in m.level_stats] == [8, 8, 8]
    assert [s["topics"] for s in m.level_stats] == [3, 6, 10]
    assert all(s["positions"] > 0 and s["seconds"] > 0 for s in m.level_stats)


def test_cascaded_prediction_recovers_branch(trained):
    m, *_ = trained
    doc = "cat dog pet animal fur purr".split()
    l1, l2, l3 = m.test_down_tree(doc, it=20, thinning=5, threshold=0.95)
    assert "A" in [lab for lab, _ in l1]
    probs = [p for _, p in l1]
    assert probs == sorted(probs, reverse=True)
    assert all(0 <= p <= 1 for p in probs)
    expanded = {lab for tups in l2 for lab, _ in tups}
    assert any(lab.startswith("A") for lab in expanded)


def test_batch_matches_single(trained):
    m, *_ = trained
    docs = ["cat dog pet".split(), "stock bond market".split()]
    l1, l2, l3 = m.test_down_tree_batch(docs, it=10, thinning=5)
    assert len(l1) == len(l2) == len(l3) == 2
    assert all(isinstance(t, list) for t in l1)


def test_flat_run_test(trained):
    """Flat fold-in over the depth-1 slice [root, A, B].  A four-word
    document can fall wholly to the root topic in one chain, so five chains
    are run: the document's own branch never loses to the other and wins in
    most of them."""
    m, *_ = trained
    docs = ["cat dog pet animal".split(), "stock market price".split()]
    labels = [x for x in m.lablist if len(x) in (1, 4)]
    a_col, b_col = labels.index("A"), labels.index("B")
    wins = np.zeros(2, int)
    for seed in range(5):
        m._gen.manual_seed(seed)
        th = m.run_test(docs, it=10, thinning=5, depth=1)
        assert th.shape == (2, 3)
        np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-4)
        assert th[0, a_col] >= th[0, b_col] and th[1, b_col] >= th[1, a_col]
        wins += [th[0, a_col] > th[0, b_col], th[1, b_col] > th[1, a_col]]
    assert (wins >= 3).all(), wins


def test_setup_theta_multiplies_down_tree():
    labelmap = {"root": 0, "A": 1, "B": 2, "A1": 3, "A11": 4}
    th = setup_theta([[("A", 0.8), ("root", 0.15)]], [[[("A1", 0.6), ("A", 0.3)]]],
                     [[[("A11", 0.5), ("A1", 0.4)]]], labelmap)
    assert th.shape == (1, 5)
    np.testing.assert_allclose(th[0, labelmap["A"]], 0.8)
    np.testing.assert_allclose(th[0, labelmap["A1"]], 0.6 * 0.8)
    np.testing.assert_allclose(th[0, labelmap["A11"]], 0.5 * 0.6 * 0.8)
    np.testing.assert_allclose(th[0, labelmap["root"]], 0.15)


def test_setup_theta_empty_levels():
    th = setup_theta([[("A", 0.9)]], [[]], [[]], {"root": 0, "A": 1})
    np.testing.assert_allclose(th[0, 1], 0.9)


def test_root_level_schedule():
    """go_down_tree(root_it=, root_s=) gives the root model its own schedule."""
    m = _model()
    m.go_down_tree(it=4, s=2, root_it=12, root_s=3)
    assert [s["sweeps"] for s in m.level_stats] == [12, 4, 4]
    for lab in ("root", "A", "B", "A1", "A11"):
        row = m.ph[m.labelmap[lab]]
        assert np.isfinite(row).all() and row.sum() > 0
    th = m.run_test(_toy_corpus()[0][:2], it=4, thinning=2, depth=1)
    assert th.shape[0] == 2 and np.isfinite(th).all()


@pytest.mark.parametrize("sweep", ["fused", "compact"])
def test_other_sweeps_train_and_predict(sweep):
    """The merge-block and compact samplers train the whole tree, keep the
    branch topics disjoint and predict the right branch."""
    docs, _, _, dicti = _toy_corpus()
    m = _model(sweep)
    m.go_down_tree(it=20, s=5)
    a_words = {w for d in docs[:4] for w in d}
    b_cols = [dicti.token2id[w] for w in {w for d in docs[4:] for w in d}
              if w not in a_words]
    for lab in ("A1", "A11", "A2"):
        assert m.ph[m.labelmap[lab], b_cols].sum() == 0
    l1, _, _ = m.test_down_tree("cat dog pet animal".split(), it=30, thinning=5)
    assert max(l1, key=lambda t: t[1])[0] == "A"


def test_compact_equals_dense():
    """The compact sampler is the dense one with the zero lanes removed:
    from one seed both draw the same chain and give the same φ̂."""
    dense, compact = _model("dense"), _model("compact")
    dense.go_down_tree(it=8, s=2)
    compact.go_down_tree(it=8, s=2)
    np.testing.assert_array_equal(dense.ph, compact.ph)


# ---- the model against the JAX model


def _small_jel():
    c = jel_corpus(2, n_train=60, n_test=5, V=200, n_l2=10, n_l3=16, max_types=24,
                   mean_types=10)
    return c.train_docs, c.train_labs, c.labelset


def _both_models(corpus, sweep="dense", seed=0):
    docs, labs, labelset = corpus
    kw = dict(alpha=0.1, beta=0.01, seed=seed, sweep=sweep)
    port = CascadeLDA(docs, labs, labelset, Dictionary(docs), device="cpu", **kw)
    ref = JaxCascadeLDA(docs, labs, labelset, JaxDictionary(docs), **kw)
    return port, ref


@pytest.mark.parametrize("corpus", ["toy", "jel"])
def test_level_rows_match_jax(corpus):
    """Every level's (doc, node) rows, label masks, node roots and children
    are the JAX model's, and so are the encoded documents they index."""
    port, ref = _both_models(_toy_corpus()[:3] if corpus == "toy" else _small_jel())
    np.testing.assert_array_equal(port.tok_v, ref.tok_v)
    np.testing.assert_array_equal(port.tok_f, ref.tok_f)
    assert port.labelmap == ref.labelmap
    for parents in (port.lablist_l1, port.lablist_l2):
        got, want = port._level_rows(parents), ref._level_rows(parents)
        for g, w in zip(got[:3], want[:3]):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)
        assert got[3:] == want[3:]
        assert got[1].shape[0] > 0 and got[1].sum() > got[1].shape[0]


def _jax_level_uniforms(ref, it: int, s: int):
    """The uniforms the JAX model draws in ``go_down_tree(it, s)``, level by
    level in the order it draws them (the init's, then one per sweep), each
    cut from its padded (Up, Rp) draw to the level's (U, R)."""
    key = ref._key
    levels = [(ref.D, 4 * it)]
    for parents in (ref.lablist_l1, ref.lablist_l2):
        levels.append((len(ref._level_rows(parents)[0]), it))
    U = ref.tok_v.shape[1]
    Up = jax_bucket(U, 32, 8)
    out = []
    for R, iters in levels:
        Rp = jax_bucket(R, 512, 128)
        key, k0, k1 = jax.random.split(key, 3)
        draws = [k0] + list(jax.random.split(k1, iters + 1)[:iters])
        out += [torch.from_numpy(np.array(
            jax.random.uniform(k, (Up, Rp), dtype=jnp.float32))[:U, :R].copy())
            for k in draws]
    return out


@pytest.mark.parametrize("sweep", ["dense", "compact"])
@pytest.mark.parametrize("corpus", ["toy", "jel"])
def test_go_down_tree_matches_jax_draw_for_draw(monkeypatch, corpus, sweep):
    """From the JAX model's own uniforms, the port's ``go_down_tree`` gives
    the JAX model's φ: the same rows and masks per level, the same root
    schedule, the same saves and the same splice of each level's columns
    into the global table.  The JAX sweep sums its CDF with a matmul, the
    port with a lane-ordered sum; they may differ by ULPs, which flips a
    draw only on a tie, so φ is compared at rtol 1e-6."""
    it, s = 6, 2
    port, ref = _both_models(_toy_corpus()[:3] if corpus == "toy" else _small_jel(),
                             sweep=sweep)
    queue = _jax_level_uniforms(ref, it, s)
    ref.go_down_tree(it=it, s=s)

    def jax_rand(shape, out=None, **_):
        u = queue.pop(0)
        assert tuple(u.shape) == tuple(shape)
        return u if out is None else out.copy_(u)

    monkeypatch.setattr(torch, "rand", jax_rand)
    port.go_down_tree(it=it, s=s)
    assert not queue  # every draw of the JAX model was used, in order
    assert [st["sweeps"] for st in port.level_stats] == [4 * it, it, it]
    np.testing.assert_allclose(port.ph, ref.ph, rtol=1e-6, atol=0)
    assert (port.ph > 0).sum() > port.V  # the levels wrote their rows


def test_default_device_is_cuda():
    if torch.cuda.is_available():
        assert _model(device=None).device.type == "cuda"
    else:
        with pytest.raises((RuntimeError, AssertionError)):
            _model(device=None)
