"""End-to-end smokes of the port's CLIs on a tiny synthetic JEL corpus.

The port of ``tests/test_cli_smoke.py``, on the CPU (``--device cpu``):
drives the product ``main()`` functions, load → preprocess → prune → train →
fold-in test → metrics, with the Gibbs and the CAVI engine, and the
LocalLDA CLI.  Also: the multi-device options that the JAX CLI refuses
exit with an error, a run killed after its first checkpoint and resumed prints
the uninterrupted run's metrics, the corpus split and vocabulary equal the
JAX CLI's, and ``entry()`` builds ``__graft_entry__``'s toy problem.
"""

import os
import pickle
import re

import numpy as np
import pytest
import torch

from lda_thesis_tpu_torch.cli import (
    evaluate_cascade_lda,
    evaluate_labeled_lda,
    evaluate_local_lda,
)
from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint
from lda_thesis_tpu_torch.utils.elastic import ElasticGibbs
from test_cli_smoke import _capture, corpus_csv  # noqa: F401  (a fixture)

METRIC_LINES = re.compile(r"^(AUC ROC|one error|two error|F1 score).*$", re.M)


def _run(corpus_csv, *extra):
    return evaluate_labeled_lda.main(["-f", corpus_csv, "-d", "2", "-i", "4", "-s", "2",
                                      "--seed", "3", "--device", "cpu", *extra])


@pytest.mark.parametrize("sweep", ["auto", "dense", "compact"])
def test_labeled_lda_cli(corpus_csv, capsys, sweep):
    res = _run(corpus_csv, "--sweep", sweep)
    out, aucs = _capture(capsys)
    assert "Model:" in out and len(aucs) == 1 and 0.0 <= aucs[0] <= 1.0
    assert res["metrics"]["auc_roc"] == aucs[0]
    assert res["model"].sweep == ("fused" if sweep == "auto" else sweep)
    assert res["stats"]["train_iters"] == 4 and res["tokens_per_s"] > 0
    assert f"({res['pipeline']})" in out and "wall time by step: load+preprocess" in out


def test_labeled_lda_cli_progress_and_trace(corpus_csv, capsys, tmp_path):
    trace_dir = str(tmp_path / "trace")
    res = _run(corpus_csv, "--checkpoint", str(tmp_path / "ck"), "--save-every", "2",
               "--progress", "--trace", trace_dir)
    out, aucs = _capture(capsys)
    assert len(aucs) == 1
    assert "tokens/s" in out and "[4/4]" in out
    assert "device profile written" in out
    found = [f for _, _, fs in os.walk(trace_dir) for f in fs]
    assert any(f.endswith(".pt.trace.json") for f in found), found
    counts = res["stats"]["counts"]  # the CPU runs every runner call eagerly
    assert counts["foldin_sweep.eager"] == 4 and counts["merge_block.eager"] >= 1
    assert not any(k.endswith((".capture", ".replay")) for k in counts), counts


def test_labeled_lda_cli_max_restarts(corpus_csv, capsys, tmp_path):
    _run(corpus_csv, "--checkpoint", str(tmp_path / "ck"), "--save-every", "2",
         "--max-restarts", "2")
    out, aucs = _capture(capsys)
    assert len(aucs) == 1 and "checkpointed at iteration 4/4" in out


def test_labeled_lda_cli_n_buckets_resume(corpus_csv, capsys, tmp_path):
    """--n-buckets resumes a checkpoint recorded at another bucket layout;
    the layout is part of the draw stream, so the mismatch otherwise raises."""
    ck = str(tmp_path / "nb1")
    evaluate_labeled_lda.main(["-f", corpus_csv, "-d", "2", "-i", "2", "-s", "2",
                               "--seed", "3", "--checkpoint", ck, "--n-buckets", "1",
                               "--device", "cpu"])
    capsys.readouterr()
    with pytest.raises(ValueError, match="n_buckets=1"):
        _run(corpus_csv, "--checkpoint", ck, "--resume")
    capsys.readouterr()
    res = _run(corpus_csv, "--checkpoint", ck, "--resume", "--n-buckets", "1")
    out, aucs = _capture(capsys)
    assert "resumed from" in out and len(aucs) == 1
    assert res["stats"]["train_iters"] == 2


def test_killed_run_resumes_to_the_same_result(corpus_csv, capsys, tmp_path, monkeypatch):
    """A run that dies after its first checkpoint and is rerun with --resume
    ends with the uninterrupted run's checkpoint and metric lines."""
    flags = ["-i", "6", "-s", "2", "--save-every", "2"]
    _run(corpus_csv, *flags, "--checkpoint", str(tmp_path / "a"))
    want = METRIC_LINES.findall(capsys.readouterr().out)

    real_run = ElasticGibbs.run

    def killed(self, total_iters, thinning, save_every=0, **kw):
        real_run(self, save_every, thinning, save_every, **kw)
        raise KeyboardInterrupt("killed after the first checkpoint")

    monkeypatch.setattr(ElasticGibbs, "run", killed)
    with pytest.raises(KeyboardInterrupt):
        _run(corpus_csv, *flags, "--checkpoint", str(tmp_path / "b"))
    assert load_checkpoint(str(tmp_path / "b"))[1]["iters_done"] == 2
    monkeypatch.setattr(ElasticGibbs, "run", real_run)
    capsys.readouterr()
    _run(corpus_csv, *flags, "--checkpoint", str(tmp_path / "b"), "--resume")
    out = capsys.readouterr().out
    assert "resumed from" in out and METRIC_LINES.findall(out) == want and len(want) == 4
    a, b = load_checkpoint(str(tmp_path / "a"))[0], load_checkpoint(str(tmp_path / "b"))[0]
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_pickle_flag(corpus_csv, capsys, tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    res = _run(corpus_csv, "-p")
    with open("LabeledLDA_model.pkl", "rb") as f:
        model = pickle.load(f)
    with open("LabeledLDA_theta.pkl", "rb") as f:
        theta = pickle.load(f)
    assert model.device.type == "cpu" and model.K == res["model"].K
    assert torch.equal(model._gen.get_state(), res["model"]._gen.get_state())
    assert torch.equal(model.counts.n_vk, res["model"].counts.n_vk)
    assert theta.shape[1] == model.K
    with open("LabeledLDA_testset.pkl", "rb") as f:
        model.run_test(pickle.load(f).docs, 2, 2)


def test_cascade_cli_with_test_budget(corpus_csv, capsys):
    res = evaluate_cascade_lda.main(
        ["-f", corpus_csv, "-d", "2", "-i", "2", "-s", "2", "--seed", "3", "--root-it", "3",
         "--root-s", "3", "--test-it", "3", "--test-s", "3", "--device", "cpu"])
    out, aucs = _capture(capsys)
    assert len(aucs) == 2  # one metric block per depth
    assert all(0.0 <= a <= 1.0 for a in aucs)
    assert [m["auc_roc"] for m in res["metrics"]] == aucs
    assert [s["sweeps"] for s in res["model"].level_stats] == [3, 2, 2]


# the multi-device flags are ported; what the JAX CLI refuses still exits
@pytest.mark.parametrize("flags,item", [(["--n-chains", "2", "--sweep", "compact"],
                                         "single-device only"),
                                        (["--n-data", "2"], "does not divide 1 ranks"),
                                        (["--table-shard", "vocab"], "requires --n-data"),
                                        (["-p", "--n-chains", "2"],
                                         "-p pickles a single-device model")])
def test_options_not_ported_exit(corpus_csv, flags, item):
    with pytest.raises(SystemExit, match=item):
        _run(corpus_csv, *flags)


def test_hslda_cli_n_chains(corpus_csv, capsys):
    """``evaluate_hslda --n-chains 2``: two chains batched in one process,
    chain-averaged scores, the chain count and mesh on the step line."""
    from lda_thesis_tpu_torch.cli import evaluate_hslda
    from lda_thesis_tpu_torch.parallel import DistributedHSLDA

    res = evaluate_hslda.main(["-f", corpus_csv, "-d", "3", "-k", "4", "-i", "4", "-s", "2",
                               "--test-it", "4", "--test-s", "2", "--seed", "3",
                               "--n-chains", "2", "--device", "cpu"])
    out, aucs = _capture(capsys)
    m = res["model"]
    assert isinstance(m, DistributedHSLDA) and m.n_chains == 2 and m.device.type == "cpu"
    assert tuple(m.state.n_vk.shape[:1]) == (2,) and m._cycles_done == 4
    assert len(aucs) == 1 and 0.0 <= aucs[0] <= 1.0
    assert "(4 cycles, opt 1, 2 chains, mesh {'chains': 1, 'data': 1})" in out
    assert res["scores"].shape[1] == m.L and np.isfinite(res["scores"]).all()


def test_engine_vi_runs(corpus_csv, capsys):
    """``--engine vi``, once refused, runs the CAVI engine: -i CAVI
    iterations with a non-falling ELBO, a CAVI fold-in and the metric block."""
    from lda_thesis_tpu_torch.models.labeled_lda_vi import LabeledLDAVI

    res = _run(corpus_csv, "--engine", "vi")
    out, aucs = _capture(capsys)
    m = res["model"]
    assert isinstance(m, LabeledLDAVI) and m.device.type == "cpu"
    assert len(aucs) == 1 and res["metrics"]["auc_roc"] == aucs[0]
    assert "Labeled LDA (CAVI" in out and "CAVI iterations" in out
    e = np.asarray(m.elbo_history)
    assert res["stats"]["train_iters"] == len(e) >= 2
    assert np.all(np.diff(e) >= -1e-3 * np.abs(e[:-1]))


def test_local_lda_cli(corpus_csv, capsys):
    res = evaluate_local_lda.main(["-f", corpus_csv, "-k", "5", "-i", "4", "-s", "2",
                                   "--device", "cpu"])
    out = capsys.readouterr().out
    m = res["model"]
    assert m.sweep == "fused" and m.K == 5 and m.device.type == "cpu"
    assert f"LocalLDA: D={m.D} sentence-docs, V={m.V}, K=5" in out
    assert "perplexity:" in out and 1.0 < res["perplexity"] < m.V
    assert "wall time by step: load" in out and res["tokens_per_s"] > 0
    assert m.ph_hat.shape == (5, m.V)
    # CPU tensors take the plain versions: no kernel launches
    assert res["launches"] == {"fused_block": 0, "draw": 0, "commit": 0}
    dense = evaluate_local_lda.main(["-f", corpus_csv, "-k", "5", "-i", "2",
                                     "--sweep", "dense", "--no-sentences",
                                     "--device", "cpu"])
    assert dense["model"].sweep == "dense" and dense["model"].D <= m.D


@pytest.mark.skipif(torch.cuda.is_available(), reason="a CUDA device is visible")
@pytest.mark.parametrize("cli", [evaluate_labeled_lda, evaluate_cascade_lda,
                                 evaluate_local_lda])
def test_device_cuda_without_a_card_exits(corpus_csv, cli):
    with pytest.raises(SystemExit, match="no CUDA device"):
        cli.main(["-f", corpus_csv, "-i", "2"])


@pytest.mark.parametrize("mode", ["truncate", "prefix"])
def test_split_and_vocabulary_match_jax(corpus_csv, mode):
    from lda_thesis_tpu.data.corpus import load_corpus as jax_load
    from lda_thesis_tpu.data.corpus import split_data as jax_split
    from lda_thesis_tpu.data.encode import build_labelmap as jax_labelmap
    from lda_thesis_tpu.data.vocab import prune_dict as jax_prune
    from lda_thesis_tpu_torch.data.corpus import load_corpus, split_data
    from lda_thesis_tpu_torch.data.encode import build_labelmap
    from lda_thesis_tpu_torch.data.vocab import prune_dict

    d = 2 if mode == "truncate" else 3
    train, test = split_data(load_corpus(corpus_csv, d=d, mode=mode), seed=3)
    jtrain, jtest = jax_split(jax_load(corpus_csv, d=d, mode=mode), seed=3)
    assert (test.docs, test.labs) == (jtest.docs, jtest.labs)
    assert (train.docs, train.labs) == (jtrain.docs, jtrain.labs)
    for lower, upper in ((0, 1), (0.05, 0.95)):
        got = prune_dict(train.docs, lower=lower, upper=upper).token2id
        assert got == jax_prune(jtrain.docs, lower=lower, upper=upper).token2id
    assert build_labelmap(train.labelset) == jax_labelmap(jtrain.labelset)


def test_entry_builds_the_toy_problem():
    import __graft_entry__

    from lda_thesis_tpu_torch import entry

    for got, want in zip(entry._toy_problem(), __graft_entry__._toy_problem()):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    fn, args = entry.entry(device="cpu")
    tok_v, tok_f, _ = __graft_entry__._toy_problem()
    state, tvt, tft, li, lvt, gen = args
    np.testing.assert_array_equal(tvt.numpy(), tok_v.T)
    np.testing.assert_array_equal(tft.numpy(), tok_f.T.astype(np.float32))
    out = fn(*args)
    assert float(out.n_vk.sum()) == float(tok_f.sum()) == float(state.n_vk.sum())
    assert torch.equal(out.n_k, out.n_vk.sum(dim=0))
    assert out.z.shape == (8, 32) and out.n_dk.shape == li.T.shape


def test_config_matches_jax():
    from lda_thesis_tpu.utils.config import GibbsConfig as JaxGibbs
    from lda_thesis_tpu.utils.config import RunConfig as JaxRun
    from lda_thesis_tpu_torch.utils.config import GibbsConfig, RunConfig

    assert GibbsConfig(iters=40).thinning == 40  # the reference's thinning == 0 rule
    got = RunConfig(file="x.csv", gibbs=GibbsConfig(iters=10, thinning=5))
    want = JaxRun(file="x.csv", gibbs=JaxGibbs(iters=10, thinning=5))
    assert got.to_dict() == want.to_dict() and got.test_iters == 10
    for bad in (dict(iters=0), dict(alpha=-1)):
        with pytest.raises(ValueError):
            GibbsConfig(**bad)
    with pytest.raises(ValueError):
        RunConfig(label_mode="bogus")


def test_pipeline_helpers(corpus_csv):
    from lda_thesis_tpu.pipeline import split_corpus as jax_split_corpus
    from lda_thesis_tpu_torch.pipeline import split_corpus, test_labeled_lda, train_labeled_lda

    train, test = split_corpus(corpus_csv, d=2, seed=3)
    jtrain, jtest = jax_split_corpus(corpus_csv, d=2, seed=3)
    assert (train.docs, test.labs) == (jtrain.docs, jtest.labs)
    model = train_labeled_lda(train, it=4, s=2, l=0, u=1, seed=3, device="cpu")
    assert model.device.type == "cpu" and model._avg_s == 2
    th, preds = test_labeled_lda(model, test, it=4, thinning=2, n=3)
    assert th.shape == (len(test), model.K) and len(preds) == len(test)
    assert all(len(p) == 3 for p in preds)
