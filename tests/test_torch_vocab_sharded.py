"""The port's vocab-sharded table (``parallel/vocab_sharded.py``) on gloo ranks.

Ported cases of ``tests/test_vocab_sharded.py``: the single-chain cases on
a (1, 4) mesh of four spawned CPU ranks (JAX: (1, 8)), the chains×vocab
ones on (2, 2) (JAX: (2, 4)).  The toy vocabulary has V = 42 words, so the
table pads to 44 rows and any padded-V leak into the denominator's V·β
changes the draws.  Also one chains×vocab merge block against JAX's,
bitwise, from JAX's init state with JAX's uniforms.  Every run goes through
one spawn of four ranks.
"""

import numpy as np
import pytest
import torch

from lda_thesis_tpu_torch.ops.gibbs_fused import FusedLDAState, fused_train_block
from lda_thesis_tpu_torch.parallel.launch import spawn
from test_torch_distributed_trainer import _jax_block_case

D, U, A, K, V = 24, 8, 8, 128, 42
S = 4
VP = 44


def _problem():
    rng = np.random.default_rng(3)
    tok_v = rng.integers(0, V, size=(D, U)).astype(np.int32)
    n_types = rng.integers(2, U + 1, size=(D,))
    tok_f = (np.arange(U)[None, :] < n_types[:, None]).astype(np.int32)
    lab_ids = np.zeros((D, A), np.int32)
    lab_valid = np.zeros((D, A), np.float32)
    for d in range(D):
        ids = np.sort(rng.choice(30, size=rng.integers(2, 5), replace=False))
        lab_ids[d, : len(ids)] = ids
        lab_valid[d, : len(ids)] = 1.0
    return tok_v, tok_f, lab_ids, lab_valid


def _toy_docs():
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(40)]
    docs, labs = [], []
    for d in range(24):
        lab = ["A"] if d % 2 == 0 else ["B"]
        lo = 0 if lab == ["A"] else 20
        docs.append([vocab[lo + rng.integers(0, 20)] for _ in range(12)])
        labs.append(lab)
    return docs, labs, ["root", "A", "B"]


def _vocab(**kw):
    return dict(layout="vocab", mesh=(1, S), n_chains=1, V=V, K=K, arrays=_problem(), **kw)


def _oracle_uniforms(M=3):
    rng = np.random.default_rng(77)
    return {(0, di, 0): rng.random((M, U, D // S), dtype=np.float32) for di in range(S)}


def _table(res, key="state", field="n_vk"):
    """(C, V_p, K) from the ranks' vocab rows (rank order is row order)."""
    return np.concatenate([r[key][field] for r in res], axis=1)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    docs, labs, labelset = _toy_docs()
    parity, parity_want = _jax_block_case(docs, labs, labelset, 1, table_shard="vocab")
    tmp = tmp_path_factory.mktemp("vocab")
    chains = dict(docs=docs, labs=labs, labelset=labelset, mesh=(2, 2), steps=[(8, 4, None)])
    jobs = [
        ("arrays_job", _vocab(blocks=0)),
        ("arrays_job", _vocab(blocks=3, M=1)),
        ("arrays_job", _vocab(blocks=3, M=3)),
        ("arrays_job", _vocab(blocks=1, M=3, uniforms=_oracle_uniforms())),
        ("arrays_job", _vocab(blocks=10, M=2)),
        ("arrays_job", _vocab(blocks=2, M=2, loop=(4, 2), trace=True)),
        ("train_job", dict(docs=docs, labs=labs, labelset=labelset, mesh=(1, S),
                           kw=dict(alpha=0.1, beta=0.01, n_chains=1, seed=0,
                                   table_shard="vocab"),
                           steps=[(8, 4, None)], test=(docs[:4], 10, 5, None),
                           resume={"path": str(tmp / "v"), "at": 4})),
        ("train_job", dict(chains, kw=dict(alpha=0.1, beta=0.01, n_chains=4, seed=0))),
        ("train_job", dict(chains, kw=dict(alpha=0.1, beta=0.01, n_chains=4, seed=0,
                                           table_shard="vocab"),
                           test=(docs[:4], 4, 2, 1), resume={"path": str(tmp / "cv"), "at": 4})),
        ("block_job", parity),
    ]
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:multi_job", 4,
                {"jobs": jobs}, device="cpu", timeout=300)
    return [[r[i] for r in res] for i in range(len(jobs))], parity_want


def test_table_is_vocab_sharded(runs):
    for r in runs[0][0]:
        assert r["state"]["n_vk"].shape == (1, VP // S, K)
        assert r["state"]["ph_hat"].shape == (1, VP // S, K)
        assert r["rows"] == (r["coords"][1] * VP // S, (r["coords"][1] + 1) * VP // S)


@pytest.mark.parametrize("case", [1, 2], ids=["M1", "M3"])
def test_block_invariants(runs, case):
    res = runs[0][case]
    total = float(_problem()[1].sum())
    n_vk = _table(res)[0]
    assert float(n_vk.sum()) == total and n_vk.min() >= 0
    for r in res:
        np.testing.assert_array_equal(r["state"]["n_k"][0], n_vk.sum(axis=0))
    assert sum(float(r["state"]["n_dk"].sum()) for r in res) == total


def test_matches_unsharded_fused(runs):
    """The vocab-sharded block equals the port's unsharded fused block run
    per data shard against the same frozen (padded) table with the true
    V·β, its deltas committed once at block end."""
    res = runs[0][3]
    tok_v, tok_f, lab_ids, lab_valid = _problem()
    nvk0 = torch.as_tensor(_table(res, "init")[0])
    nk0 = torch.as_tensor(res[0]["init"]["n_k"][0])
    delta = torch.zeros_like(nvk0)
    u = _oracle_uniforms()
    ds = D // S
    for r in res:
        s = r["coords"][1]
        sl = slice(s * ds, (s + 1) * ds)
        st = FusedLDAState(z=torch.as_tensor(r["init"]["z"][0]),
                           n_dk=torch.as_tensor(r["init"]["n_dk"][0]), n_vk=nvk0, n_k=nk0)
        out = fused_train_block(
            st, torch.as_tensor(tok_v[sl].T).long().contiguous(),
            torch.as_tensor(tok_f[sl].T.astype(np.float32)).contiguous(),
            torch.as_tensor(lab_ids[sl]).long(), torch.as_tensor(lab_valid[sl].T).contiguous(),
            0.1, 0.01, 3, uniforms=torch.as_tensor(u[(0, s, 0)]), vbeta=V * 0.01)
        np.testing.assert_array_equal(r["state"]["z"][0], out.z.numpy())
        np.testing.assert_array_equal(r["state"]["n_dk"][0], out.n_dk.numpy())
        delta += out.n_vk - nvk0
    np.testing.assert_array_equal(_table(res)[0], (nvk0 + delta).numpy())


def test_learns_structure(runs):
    res = runs[0][4]
    _, _, lab_ids, lab_valid = _problem()
    allowed = np.zeros(K, bool)
    allowed[lab_ids[lab_valid > 0]] = True
    assert _table(res)[0][:, ~allowed].sum() == 0


def test_train_loop_thinned_means_and_sharding(runs):
    """The vocab training loop's thinned φ̂ equals a block-by-block oracle
    from the same draws, and its means stay vocab-sharded."""
    for r in runs[0][5]:
        looped = r["looped"]
        assert looped["s"] == 2 and looped["ph_hat"].shape == (1, VP // S, K)
        ph = np.zeros((VP // S, K), np.float32)
        for i, st in enumerate(r["states"]):
            cur = (st["n_vk"][0] + 0.01) / (st["n_k"][0] + V * 0.01)
            s = i + 1
            ph = (s - 1) / s * ph + cur / s
        np.testing.assert_allclose(looped["ph_hat"][0], ph, atol=1e-5)
        np.testing.assert_array_equal(looped["n_vk"], r["states"][-1]["n_vk"])
        np.testing.assert_array_equal(looped["z"], r["states"][-1]["z"])


def test_distributed_trainer_vocab_mode(runs):
    res = runs[0][6]
    for r in res:
        assert r["invariants"]["ok"]
        for f, want in r["state"].items():
            np.testing.assert_array_equal(r["resumed_state"][f], want, err_msg=f)
    docs, _, labelset = _toy_docs()
    from lda_thesis_tpu_torch.data.vocab import Dictionary

    dicti = Dictionary(docs)
    ph = res[0]["pooled_phi"]  # (K, V)
    a_cols = [dicti.token2id[w] for w in dicti.token2id if int(w[1:]) < 20]
    assert ph[1, a_cols].sum() > ph[2, a_cols].sum()
    assert res[0]["theta"].shape == (4, 3)
    assert res[0]["mc_error"] == 0.0


def test_chains_vocab_matches_replicated(runs):
    rep, voc = runs[0][7], runs[0][8]
    Vn = rep[0]["state"]["n_vk"].shape[1]
    for f in ("z", "n_dk", "n_k"):
        for a, b in zip(rep, voc):
            np.testing.assert_array_equal(b["state"][f], a["state"][f], err_msg=f)
    for ci in range(2):  # each chain row's table, gathered from its vocab rows
        table = np.concatenate([voc[ci * 2 + di]["state"]["n_vk"] for di in range(2)],
                               axis=1)[:, :Vn]
        np.testing.assert_array_equal(table, rep[ci * 2]["state"]["n_vk"])
    assert voc[0]["state"]["n_vk"].shape == (2, -(-Vn // 2), 128)
    np.testing.assert_allclose(voc[0]["pooled_phi"], rep[0]["pooled_phi"], rtol=1e-5,
                               atol=1e-7)
    assert voc[0]["mc_error"] > 0 and voc[0]["chain_phis_shape"] == (4, 3, Vn)


def test_chains_vocab_resume_bit_identical(runs):
    for r in runs[0][8]:
        assert r["resumed_meta_iters"] == 4
        for f, want in r["state"].items():
            np.testing.assert_array_equal(r["resumed_state"][f], want, err_msg=f)
    assert runs[0][8][0]["theta"].shape == (4, 3)


def test_chains_vocab_block_matches_jax(runs):
    """One chains×vocab merge block (M = 2) on the (2, 2) mesh from JAX's
    init state with JAX's uniforms: z, n_dk, each chain's table and n_k
    bitwise equal to JAX's."""
    res, want = runs[0][9], runs[1]
    z = np.concatenate([np.concatenate([res[ci * 2 + di]["state"]["z"] for di in range(2)],
                                       axis=2) for ci in range(2)])
    ndk = np.concatenate([np.concatenate([res[ci * 2 + di]["state"]["n_dk"]
                                          for di in range(2)], axis=2) for ci in range(2)])
    n_vk = np.concatenate([np.concatenate([res[ci * 2 + di]["state"]["n_vk"]
                                           for di in range(2)], axis=1) for ci in range(2)])
    n_k = np.concatenate([res[ci * 2]["state"]["n_k"] for ci in range(2)])
    np.testing.assert_array_equal(z, want["z"])
    np.testing.assert_array_equal(ndk, want["n_dk"])
    np.testing.assert_array_equal(n_vk, want["n_vk"])
    np.testing.assert_array_equal(n_k, want["n_k"])
