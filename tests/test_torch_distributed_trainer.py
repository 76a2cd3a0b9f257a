"""The port's DistributedLabeledLDA end to end on gloo ranks.

Ported cases of ``tests/test_distributed_trainer.py`` on a (2 chains, 2
data) mesh of four spawned CPU ranks (JAX: (2, 4) on eight fake devices),
four chains, two batched per rank: the pooled φ̂, the chain diagnostics,
the pooled fold-in, the dispatch chunks, and the bucketed layout with its
kill-and-resume.  Against JAX, bitwise, from JAX's init state with JAX's
uniforms rebuilt from its keys: one fused merge block and one bucketed
merge block on the (2, 2) mesh.  Also a two-rank kill-and-resume of the
fused trainer, and the CLI's ``--n-chains``, ``--n-data`` (two spawned
ranks) and refusals.
"""

import jax
import numpy as np
import pytest

from lda_thesis_tpu.data.vocab import Dictionary as JDictionary
from lda_thesis_tpu.parallel import make_mesh as j_make_mesh
from lda_thesis_tpu.parallel.trainer import DistributedLabeledLDA as JDistributed
from lda_thesis_tpu_torch.cli import evaluate_labeled_lda
from lda_thesis_tpu_torch.parallel._util import dispatch_chunks
from lda_thesis_tpu_torch.parallel.launch import spawn
from lda_thesis_tpu_torch.parallel.trainer import DistributedLabeledLDA
from test_cli_smoke import corpus_csv  # noqa: F401  (a fixture)

DOCS = [
    "cat dog pet animal fur".split(),
    "dog bark pet tail animal".split(),
    "stock bond market price trade".split(),
    "bond yield market finance price".split(),
    "cat purr whisker pet fur".split(),
    "equity trade finance market price".split(),
] * 6
LABS = [["A"], ["A"], ["B"], ["B"], ["A"], ["B"]] * 6
JOBS = "lda_thesis_tpu_torch.parallel.jobs:multi_job"


def _varied_docs():
    rng = np.random.default_rng(0)
    vocab = [f"w{i}" for i in range(40)]
    docs, labs = [], []
    for d in range(32):
        lab = ["A"] if d % 2 == 0 else ["B"]
        lo = 0 if lab == ["A"] else 20
        n = 4 if d % 4 < 2 else 14  # two length classes -> 2 real buckets
        docs.append([vocab[lo + rng.integers(0, 20)] for _ in range(n)])
        labs.append(lab)
    return docs, labs, ["A", "B"]


def _jax_block_case(docs, labs, labelset, n_buckets, table_shard="replicated"):
    """JAX's trainer on a (2, 2) mesh, four chains: its init state, one
    merge block of M = 2 (``run_training(2, 2, total_iters=16)``), and the
    block's uniforms of each (chain, shard, bucket) rebuilt from its keys."""
    mesh = j_make_mesh(n_data=2, n_chains=2, devices=jax.devices()[:4])
    m = JDistributed(docs, labs, labelset, JDictionary(docs), alpha=0.3, beta=0.05,
                     mesh=mesh, n_chains=4, seed=5, n_buckets=n_buckets,
                     table_shard=table_shard)
    init = {f: (np.asarray(v) if not isinstance(v, tuple) else None)
            for f, v in m.state._asdict().items()}
    if n_buckets > 1:
        for f in ("z", "n_dk", "th_hat"):
            for g, v in enumerate(getattr(m.state, f)):
                init[f"{f}_{g}"] = np.asarray(v)
            del init[f]
        widths = [(t.shape[0], t.shape[1] // 2) for t in m._corpus[0]]
    else:
        widths = [(m._tok_v_t.shape[0], m._tok_v_t.shape[1] // 2)]
    block_key = jax.random.fold_in(m._master_key, 0)
    m.run_training(2, 2, total_iters=16)
    assert m._merge_M == 2
    uniforms = {}
    for ci in range(2):
        for j in range(2):
            for di in range(2):
                k = jax.random.fold_in(jax.random.fold_in(block_key, ci * 1009 + j), di)
                for b, (U, D_s) in enumerate(widths):
                    kb = jax.random.fold_in(k, b) if n_buckets > 1 else k
                    uniforms[(ci * 2 + j, di, b)] = np.asarray(
                        jax.random.uniform(kb, (2, U, D_s), dtype=np.float32))
    if n_buckets > 1:
        want = {f"{f}_{g}": np.asarray(v) for f in ("z", "n_dk")
                for g, v in enumerate(getattr(m.state, f))}
    else:
        want = {"z": np.asarray(m.state.z), "n_dk": np.asarray(m.state.n_dk)}
    want.update(n_vk=np.asarray(m.state.n_vk), n_k=np.asarray(m.state.n_k))
    payload = dict(docs=docs, labs=labs, labelset=labelset, mesh=(2, 2), M=2, init=init,
                   uniforms=uniforms,
                   kw=dict(alpha=0.3, beta=0.05, n_chains=4, seed=5, n_buckets=n_buckets,
                           table_shard=table_shard))
    return payload, want


def _assemble(results, field, doc_axis, S=2):
    rows = []
    for ci in range(len(results) // S):
        parts = [np.asarray(results[ci * S + di]["state"][field]) for di in range(S)]
        rows.append(np.concatenate(parts, axis=doc_axis) if doc_axis else parts[0])
    return np.concatenate(rows, axis=0)


@pytest.fixture(scope="module")
def four_ranks(tmp_path_factory):
    docs, labs, labelset = _varied_docs()
    fused_case, fused_want = _jax_block_case(docs, labs, labelset, 1)
    bucket_case, bucket_want = _jax_block_case(docs, labs, labelset, 2)
    ck = str(tmp_path_factory.mktemp("bk") / "bk")
    jobs = [
        ("train_job", dict(docs=DOCS, labs=LABS, labelset=["A", "B"], mesh=(2, 2),
                           kw=dict(alpha=0.5, beta=0.1, n_chains=4, seed=0),
                           steps=[(20, 5, None)],
                           test=([d.split() for d in ("cat dog pet", "stock market price")],
                                 10, 5, None))),
        ("train_job", dict(docs=docs, labs=labs, labelset=labelset, mesh=(2, 2),
                           kw=dict(alpha=0.1, beta=0.01, n_chains=4, seed=0, n_buckets=2),
                           steps=[(8, 4, None)], test=(docs[:4], 4, 2, None),
                           resume={"path": ck, "at": 4, "wrong_kw": {"n_buckets": 1}})),
        ("block_job", fused_case),
        ("block_job", bucket_case),
    ]
    res = spawn(JOBS, 4, {"jobs": jobs}, device="cpu", timeout=300)
    return [[r[i] for r in res] for i in range(len(jobs))], fused_want, bucket_want


def test_pooled_phi_learns_branches(four_ranks):
    r0 = four_ranks[0][0][0]
    ph = r0["pooled_phi"]
    assert ph.shape == (3, 17)
    np.testing.assert_allclose(ph.sum(axis=1), 1.0, rtol=1e-4)
    w2v = JDictionary(DOCS).token2id  # the port's Dictionary numbers words alike
    assert ph[1, w2v["cat"]] > ph[1, w2v["market"]]
    assert ph[2, w2v["market"]] > ph[2, w2v["cat"]]
    for r in four_ranks[0][0]:
        np.testing.assert_array_equal(r["pooled_phi"], ph)  # same bits on every rank
        assert r["invariants"]["ok"] and r["merges_checked"] > 0


def test_chain_diagnostics(four_ranks):
    r0 = four_ranks[0][0][0]
    assert r0["chain_phis_shape"] == (4, 3, 17)
    assert r0["mc_error"] > 0


def test_run_test_pooled(four_ranks):
    th = four_ranks[0][0][0]["theta"]
    assert th.shape == (2, 3)
    np.testing.assert_allclose(th.sum(axis=1), 1.0, rtol=1e-4)
    assert th[0, 1] > th[0, 2] and th[1, 2] > th[1, 1]


def test_dispatch_chunks_align_to_thinning():
    chunks = list(dispatch_chunks(2000, 10))
    assert sum(chunks) == 2000
    assert set(chunks[:-1]) <= {400}
    assert all(c % 10 == 0 for c in chunks[:-1])
    assert list(dispatch_chunks(1003, 25)) == [400, 400, 203]
    assert list(dispatch_chunks(1000, 500)) == [500, 500]


def test_bucketed_chains_trains_and_conserves(four_ranks):
    res = four_ranks[0][1]
    assert len(res[0]["state"]["z"]) == 2
    n_vk = _assemble(res, "n_vk", None)
    assert n_vk.shape[0] == 4
    total = res[0]["invariants"]["total"]
    for c in range(4):
        assert float(n_vk[c].sum()) == total
    assert all(r["invariants"]["ok"] for r in res)
    np.testing.assert_allclose(res[0]["pooled_phi"].sum(axis=1), 1.0, rtol=1e-4)
    assert res[0]["theta"].shape == (4, 3)


def test_bucketed_chains_resume_bit_identical(four_ranks):
    """Kill/resume of the bucketed chains trainer through the sharded
    checkpoint reproduces the uninterrupted run; a bucket-count mismatch is
    refused with the fix-it hint."""
    for r in four_ranks[0][1]:
        assert "n_buckets=2" in r["wrong_restore"]
        assert r["resumed_meta_iters"] == 4
        for f, want in r["state"].items():
            got = r["resumed_state"][f]
            if isinstance(want, list):
                assert all(np.array_equal(a, b) for a, b in zip(got, want)), f
            else:
                np.testing.assert_array_equal(got, want, err_msg=f)


@pytest.mark.parametrize("layout", ["fused", "bucketed"])
def test_merge_block_matches_jax(four_ranks, layout):
    """One merge block (M = 2) on the (2, 2) mesh from JAX's init state with
    JAX's uniforms: z, n_dk, n_vk and n_k bitwise equal to JAX's."""
    res = four_ranks[0][2 if layout == "fused" else 3]
    want = four_ranks[1 if layout == "fused" else 2]
    got = {"n_vk": _assemble(res, "n_vk", None), "n_k": _assemble(res, "n_k", None)}
    if layout == "fused":
        got.update(z=_assemble(res, "z", 2), n_dk=_assemble(res, "n_dk", 2))
    else:
        for f in ("z", "n_dk"):
            for g in range(2):
                rows = [np.concatenate([res[ci * 2 + di]["state"][f][g] for di in range(2)],
                                       axis=2) for ci in range(2)]
                got[f"{f}_{g}"] = np.concatenate(rows)
    assert set(got) == set(want)
    for f in want:
        np.testing.assert_array_equal(got[f], want[f], err_msg=f)


@pytest.fixture(scope="module")
def two_ranks(corpus_csv, tmp_path_factory):  # noqa: F811
    ck = str(tmp_path_factory.mktemp("ck") / "ck")
    jobs = [
        ("train_job", dict(docs=DOCS, labs=LABS, labelset=["A", "B"], mesh=(1, 2),
                           kw=dict(alpha=0.5, beta=0.1, n_chains=2, seed=1),
                           steps=[(12, 3, None)], estimators=False,
                           resume={"path": ck, "at": 6})),
        ("cli_job", {"argv": ["-f", corpus_csv, "-d", "2", "-i", "4", "-s", "2", "--seed",
                              "3", "--device", "cpu", "--n-data", "2", "--n-chains", "2"]}),
    ]
    res = spawn(JOBS, 2, {"jobs": jobs}, device="cpu", timeout=300)
    return [[r[i] for r in res] for i in range(len(jobs))]


def test_two_rank_kill_resume_bit_identical(two_ranks):
    for r in two_ranks[0]:
        assert r["invariants"]["ok"] and r["merges_checked"] == 12
        for f, want in r["state"].items():
            np.testing.assert_array_equal(r["resumed_state"][f], want, err_msg=f)


def test_cli_n_data_two_ranks(two_ranks):
    r0, r1 = two_ranks[1]
    assert r0["rank"] == 0 and 0.0 <= r0["metrics"]["auc_roc"] <= 1.0
    assert r0["stats"]["train_iters"] == 4
    assert r1["rank"] == 1 and r1["metrics"] is None and r1["stats"] is None


def test_cli_n_chains(corpus_csv, capsys):  # noqa: F811
    res = evaluate_labeled_lda.main(["-f", corpus_csv, "-d", "2", "-i", "4", "-s", "2",
                                     "--seed", "3", "--device", "cpu", "--n-chains", "2"])
    out = capsys.readouterr().out
    m = res["model"]
    assert isinstance(m, DistributedLabeledLDA) and m.n_chains == 2
    assert m.state.z.shape[0] == 2  # both chains batched on the one rank
    assert "2 chains, mesh {'chains': 1, 'data': 1}" in out
    assert 0.0 <= res["metrics"]["auc_roc"] <= 1.0


@pytest.mark.parametrize("flags,why", [
    (["--table-shard", "vocab"], "requires --n-data > 1"),
    (["--n-chains", "2", "--sweep", "compact"], "single-device only"),
    (["--n-data", "2"], "does not divide 1 ranks"),
])
def test_cli_refusals(corpus_csv, flags, why):  # noqa: F811
    with pytest.raises(SystemExit, match=why):
        evaluate_labeled_lda.main(["-f", corpus_csv, "-d", "2", "-i", "4", "-s", "2",
                                   "--device", "cpu", *flags])
