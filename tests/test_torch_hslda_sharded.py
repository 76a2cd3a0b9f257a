"""The port's sharded HSLDA (``parallel/hslda_sharded.py``) on gloo ranks.

One sharded blocked-Gibbs cycle on a (2 chains, 2 data) mesh of four
spawned CPU ranks against JAX's ``_build_cycle`` on a (2, 2) mesh of four
fake devices: both start from JAX's ``init_hslda_sharded`` state (loaded
through ``convert``), the port draws JAX's noise rebuilt from the cycle key
as ``hslda_sharded.py:199-202`` splits it (the z Gumbels per position, η's
normals, a's uniforms, m's Gumbels and β's Gammas of each chain and shard),
and both divide ``mdot`` by the same ``D_total``.  z, n_dk, n_vk and n_k
equal exactly, ``mdot`` too; η within 1e-5, β within 1e-6, and a within
1e-6 in reflected CDF (the tolerances of ``tests/test_torch_hslda.py``).

Ported cases of ``tests/test_hslda_sharded.py`` on the same mesh: the init
and cycle invariants, ``pooled_ph``, vocab-sharded equal to replicated
bitwise, and the vocab trainer end to end (a kill and resume through the
sharded checkpoint).  All the four-rank runs go through one spawn.  Also,
on one process: the chain-batched sweep at C = 3 equals three single-chain
sweeps, bitwise.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import special

from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel.hslda_sharded import init_hslda_sharded as j_init
from lda_thesis_tpu.parallel.hslda_sharded import make_hslda_train_step as j_make_step
from lda_thesis_tpu.parallel.hslda_sharded import shard_hslda_corpus as j_shard
from lda_thesis_tpu_torch.data.encode import encode_instances
from lda_thesis_tpu_torch.models.hslda import HSLDA
from lda_thesis_tpu_torch.ops import hslda_gibbs as tg
from lda_thesis_tpu_torch.ops.sampling import gumbel, stirling_table
from lda_thesis_tpu_torch.parallel.launch import spawn

MESH, WORLD, C = (2, 2), 4, 4
JOBS = "lda_thesis_tpu_torch.parallel.jobs:multi_job"
FIELDS = ("z", "n_dk", "n_vk", "n_k", "eta", "a", "beta")


def _problem(seed=0, D=23, V=40, K=6, L=5):
    """``D`` short documents over ``V`` words, a root label and one other;
    23 documents pad to 24 over two data shards."""
    rng = np.random.default_rng(seed)
    docs = [rng.integers(0, V, size=rng.integers(4, 10)).tolist() for _ in range(D)]
    tok_v, mask = encode_instances(docs)
    labs = np.zeros((D, L), np.float32)
    labs[:, 0] = 1
    for d in range(D):
        labs[d, rng.integers(1, L)] = 1
    return (tok_v, mask, labs), V, K


def _logs():
    t = stirling_table(16)
    return np.log(np.where(t > 0, t, 1e-300)).astype(np.float32)


def _assemble(results, field, doc_axis, key="state"):
    """Global (C, …) array from the ranks' local ones (rank = ci·2 + di)."""
    rows = []
    for ci in range(2):
        parts = [results[ci * 2 + di][key][field] for di in range(2)]
        rows.append(np.concatenate(parts, axis=doc_axis) if doc_axis is not None
                    else parts[0])
    return np.concatenate(rows, axis=0)


def _jax_cycle_case():
    """JAX's init and one cycle on a (2, 2) mesh of four chains, and the noise
    of each (chain, shard) rebuilt from the cycle key; the Gamma variates of
    β are drawn at JAX's own concentration, mdot + α', with mdot recomputed
    from JAX's m draw."""
    arrays, V, K = _problem()
    tok_v, mask, labs = arrays
    D_total = tok_v.shape[0]
    logs = _logs()
    S = logs.shape[0]
    mesh = j_make_mesh(n_data=2, n_chains=2, devices=jax.devices()[:4])
    tv, mk, lb = j_shard(mesh, tok_v, mask, labs)
    state = j_init(jax.random.PRNGKey(0), mesh, tv, mk, lb, V, K, n_chains=C)
    step = j_make_step(mesh, C, jnp.asarray(logs), D_total=D_total)
    key = jax.random.PRNGKey(9)
    after = step(key, state, tv, mk, lb)
    init = {f: np.asarray(getattr(state, f)) for f in FIELDS}
    want = {f: np.asarray(getattr(after, f)) for f in FIELDS}
    N, D_s, L = tv.shape[1], tv.shape[0] // 2, lb.shape[1]
    noise, m_sums = {}, {}
    for ci in range(2):
        for j in range(2):
            g = ci * 2 + j
            kc = jax.random.fold_in(key, ci * 1009 + j)
            kz, keta, ka, km, kbeta = jax.random.split(kc, 5)
            for di in range(2):
                kd = jax.random.fold_in(kc, di + 1)
                kz_l, ka_l, km_l = jax.random.split(kd, 3)
                z = np.asarray(jax.vmap(lambda k: jax.random.gumbel(k, (D_s, K)))(
                    jax.random.split(kz_l, N)))
                m_noise = np.asarray(jax.random.gumbel(km_l, (D_s, K, S)))
                noise[(g, di)] = dict(
                    z=z, eta=np.asarray(jax.random.normal(keta, (K, L))),
                    a=np.asarray(jax.random.uniform(ka_l, (D_s, L), jnp.float32, 1e-7, 1.0)),
                    m=m_noise)
                # JAX's m: Antoniak draw from the swept n_dk and the old β
                n = np.minimum(want["n_dk"][g][di * D_s:(di + 1) * D_s], S - 1)
                log_ab = np.log(np.maximum(np.float32(1.0) * init["beta"][g], 1e-38))
                logits = (jnp.asarray(logs)[n] + jnp.arange(S, dtype=jnp.float32)
                          [None, None, :] * jnp.asarray(log_ab, jnp.float32)[None, :, None])
                m = np.asarray(jnp.argmax(logits + m_noise, axis=2))
                m_sums[g] = m_sums.get(g, 0) + m.astype(np.float32).sum(axis=0)
            mdot = m_sums[g] / np.float32(D_total)
            gam = np.asarray(jax.random.gamma(kbeta, jnp.asarray(mdot) + 1.0))
            for di in range(2):
                noise[(g, di)]["beta"] = gam
                noise[(g, di)]["mdot"] = mdot
    payload = dict(mesh=MESH, n_chains=C, V=V, K=K, arrays=arrays, init=init, noise=noise,
                   D_total=D_total, logs=logs)
    return payload, want


def _vocab_case(shard, **kw):
    arrays, V, K = _problem(seed=7, D=24, V=41)  # V_p = 42: a pad row on the second shard
    return dict(mesh=MESH, n_chains=C, V=V, K=K, arrays=arrays, D_total=24, logs=_logs(),
                table_shard=shard, seed=3, **kw)


TRAINER_DOCS = [[f"w{i}" for i in np.random.default_rng(d).integers(0, 30, 8)]
                for d in range(24)]
TRAINER_LABS = [["A"] if d % 2 else ["B"] for d in range(24)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    parity, want = _jax_cycle_case()
    path = str(tmp_path_factory.mktemp("hv") / "hv")
    trainer = dict(docs=TRAINER_DOCS, labs=TRAINER_LABS, labelset=["A", "B"], mesh=MESH,
                   kw=dict(n_chains=C, k=4, seed=3, table_shard="vocab"),
                   steps=[(4, 2, 1, False)], test=(TRAINER_DOCS[:3], 4, 2),
                   resume={"path": path, "at": 2})
    cases = [
        ("hslda_arrays_job", parity),
        ("hslda_arrays_job", _vocab_case("replicated", cycles=3)),
        ("hslda_arrays_job", _vocab_case("replicated", loop=(4, 2))),
        ("hslda_arrays_job", _vocab_case("vocab", loop=(4, 2))),
        ("hslda_job", trainer),
    ]
    res = spawn(JOBS, WORLD, {"jobs": cases}, device="cpu", timeout=240)
    return [[r[i] for r in res] for i in range(len(cases))], want, parity


def _reflected_cdf(a, loc, flip):
    x = a.astype(np.float64) - loc
    return special.ndtr(np.where(flip, -x, x))


def test_sharded_cycle_matches_jax(runs):
    res, want, parity = runs[0][0], runs[1], runs[2]
    for f, axis in (("z", 1), ("n_dk", 1), ("n_vk", None), ("n_k", None)):
        np.testing.assert_array_equal(_assemble(res, f, axis)[:, :want[f].shape[1]], want[f],
                                      err_msg=f)
    np.testing.assert_allclose(_assemble(res, "eta", None), want["eta"], rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_assemble(res, "beta", None), want["beta"], rtol=1e-6,
                               atol=1e-7)
    for r in res:
        ci, di = r["coords"]
        for j in range(2):
            np.testing.assert_array_equal(r["mdot"][j], parity["noise"][(ci * 2 + j, di)]["mdot"])
    # a in probability: Φ of the standardised reflected draw
    a = _assemble(res, "a", 1)
    labs = np.concatenate([parity["arrays"][2], np.zeros((1, 5), np.float32)])
    zbar = want["n_dk"] / np.maximum(np.concatenate(
        [parity["arrays"][1].sum(axis=1), [0]]), 1)[None, :, None]
    mean_a = np.einsum("cdk,clk->cdl", zbar.astype(np.float32), want["eta"])
    flip = np.broadcast_to(labs > 0, a.shape)
    np.testing.assert_allclose(_reflected_cdf(a, mean_a, flip),
                               _reflected_cdf(want["a"], mean_a, flip), rtol=0, atol=1e-6)


def test_init_invariants(runs):
    res = runs[0][1]
    total = int(_problem(seed=7, D=24, V=41)[0][1].sum())
    n_dk = _assemble(res, "n_dk", 1, "init")
    n_vk = _assemble(res, "n_vk", None, "init")
    n_k = _assemble(res, "n_k", None, "init")
    for c in range(C):
        assert n_dk[c].sum() == total and n_vk[c].sum() == total
        np.testing.assert_array_equal(n_vk[c].sum(axis=0), n_k[c])
    for r in res:
        np.testing.assert_allclose(r["init"]["beta"].sum(axis=1), 1.0, rtol=1e-5)
    for ci in range(2):  # η and β are drawn alike on every shard of a chain
        for f in ("eta", "beta", "n_vk", "n_k"):
            np.testing.assert_array_equal(res[ci * 2]["init"][f], res[ci * 2 + 1]["init"][f])


def test_cycle_preserves_invariants(runs):
    res = runs[0][1]
    (tok_v, mask, labs), _, _ = _problem(seed=7, D=24, V=41)
    for r in res:
        assert r["invariants"]["ok"], r["invariants"]
        assert np.isfinite(r["state"]["eta"]).all()
        np.testing.assert_allclose(r["state"]["beta"].sum(axis=1), 1.0, rtol=1e-5)
    a = _assemble(res, "a", 1)
    for c in range(C):
        assert (a[c][labs > 0] > 0).all() and (a[c][labs == 0] < 0).all()
    z = _assemble(res, "z", 1)
    assert not np.array_equal(z[0], z[1])  # chains decorrelated
    for ci in range(2):  # the data row's replicas of a chain are equal
        for f in ("n_vk", "n_k", "eta", "beta"):
            np.testing.assert_array_equal(res[ci * 2]["state"][f], res[ci * 2 + 1]["state"][f])


def test_pooled_ph(runs):
    res = runs[0][1]
    for r in res:
        ph = r["pooled_ph"]
        assert ph.shape == (6, 41)
        np.testing.assert_allclose(ph.sum(axis=1), 1.0, rtol=1e-5)
        np.testing.assert_array_equal(ph, res[0]["pooled_ph"])  # the same on every rank


def test_vocab_sharded_matches_replicated(runs):
    rep, voc = runs[0][2], runs[0][3]
    V = 41
    for a, b in zip(rep, voc):
        assert a["n_saves"] == b["n_saves"] == 2
        for f in ("z", "n_dk", "n_k", "eta", "a", "beta"):
            np.testing.assert_array_equal(b["state"][f], a["state"][f], err_msg=f)
    for ci in range(2):
        table = np.concatenate([voc[ci * 2 + di]["state"]["n_vk"] for di in range(2)], axis=1)
        np.testing.assert_array_equal(table[:, :V], rep[ci * 2]["state"]["n_vk"])
        assert (table[:, V:] == 0).all()
        ph = np.concatenate([voc[ci * 2 + di]["ph_hat"] for di in range(2)], axis=2)
        np.testing.assert_array_equal(ph[:, :, :V], rep[ci * 2]["ph_hat"])
        assert (ph[:, :, V:] == 0).all()
        for di in range(2):  # the persistent table is sharded: (L, V_p/S, K)
            assert voc[ci * 2 + di]["state"]["n_vk"].shape == (2, 21, 6)
    np.testing.assert_array_equal(voc[0]["pooled_ph"], rep[0]["pooled_ph"])


def test_vocab_sharded_trainer_end_to_end(runs):
    res = runs[0][4]
    for r in res:
        assert all(r["replicas_equal"]) and r["invariants"]["ok"]
        assert r["scores"].shape == (3, 3) and np.isfinite(r["scores"]).all()
        np.testing.assert_array_equal(r["scores"], res[0]["scores"])
        assert r["resumed_meta"] == {"iters_done": 2, "n_saves": 1, "cycles_done": 2}
        for f in FIELDS:
            np.testing.assert_array_equal(r["resumed_state"][f], r["state"][f], err_msg=f)
        np.testing.assert_array_equal(r["resumed_ph_hat"], r["ph_hat"])
        for a, b in zip(r["resumed_gens"], r["uninterrupted_gens"]):
            np.testing.assert_array_equal(a, b)


def test_batched_sweep_equals_single_chain_sweeps():
    """The chain-batched ``_sweep_`` at C = 3 equals three C = 1 sweeps on the
    CPU, bitwise, for every coupling form (opt 2 compact and blockwise)."""
    docs = [("cat dog pet animal fur cat".split()), "stock bond market price".split(),
            "dog bark pet tail".split()] * 4
    labs = [["A", "A1"], ["B", "B1"], ["A", "A2"]] * 4
    ms = [HSLDA(docs, labs, ["A", "A1", "A2", "B", "B1"], k=5, seed=s, device="cpu")
          for s in range(3)]
    m0 = ms[0]
    N, D = m0.tok_v.shape[1], m0.D
    for opt, sparse in ((1, False), (2, True), (2, False), (3, False)):
        g = [gumbel((N, D, 5), "cpu", torch.Generator().manual_seed(i)) for i in range(3)]
        kw = dict(lab_pos_ids=m0._lab_pos_ids, lab_pos_valid=m0._lab_pos_valid) if sparse \
            else {}
        singles = [tg.hslda_z_sweep(m.counts, m.tok_v, m.mask, m.labs, m.eta, m.a,
                                    m.alpha * m.beta, 1.0, 0.0, opt=opt, gumbels=g[i], **kw)
                   for i, m in enumerate(ms)]
        counts = tg.HSLDACounts(*(torch.stack([getattr(m.counts, f) for m in ms])
                                  for f in tg.HSLDACounts._fields))
        out, M = tg.hslda_z_sweep(counts, m0.tok_v, m0.mask, m0.labs,
                                  torch.stack([m.eta for m in ms]),
                                  torch.stack([m.a for m in ms]),
                                  torch.stack([m.alpha * m.beta for m in ms]), 1.0, 0.0,
                                  opt=opt, gumbels=torch.stack(g, 1), **kw)
        for c, (want, M_want) in enumerate(singles):
            for f, (got_f, want_f) in enumerate(zip(out, want)):
                assert torch.equal(got_f[c], want_f), (opt, sparse, c, f)
            assert torch.equal(M[c], M_want)
