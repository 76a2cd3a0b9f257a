"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernel from the sources in this checkout, holds it
bitwise against its plain PyTorch version, then drives the Labeled-LDA main
path (``LabeledLDA`` → ``run_training`` → ``run_test`` → ranking metrics)
at the full width of the depth-3 abstracts split, on a synthetic labelled
corpus made from ``--seed``.  Phases:

1. environment: torch, CUDA, the card's name and power limit;
2. kernel build;
3. the kernel against ``fused_block_torch`` at every bucket of the main
   path's first merge block (A = 24, M = 25) and at one ragged case, and one
   whole merge block on the card against the same block on the CPU; times
   of the kernel, its plain version and the block's gather and scatter;
4. the main path: 50 sweeps at (50; 25) within a 2000-sweep budget, so the
   merge block is M = 25; count invariants, kernel launches, fold-in test
   of the held-out split and its AUC;
   then, with perplexity on (the CLI's default) and off (bench.py's
   setting), five more timed training calls and one under torch.profiler
   (device time by kernel, idle share);
5. one JSON line of kernel records, the card's line, and the result line.

Every check raises; the script exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

import numpy as np

SOURCE = "lda_thesis_tpu_torch/ops/csrc/fused_block.cu"
REPLACES = "lda_thesis_tpu/ops/gibbs_fused.py:246"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
OPS_PER_SLOT_DRAW = 12  # fp32 operations per (slot, position, sweep)
TRAIN_ITERS, THINNING, TOTAL_ITERS = 50, 25, 2000
MIN_AUC = 0.6
STEADY_CALLS = 5
DEVICE = "cuda"


def _median_ms(fn, reps: int) -> float:
    import torch

    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def _check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def _max_abs_err(got, want) -> float:
    return max(float((g.double() - w.double()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


def _bitwise(got, want) -> bool:
    """Tensors pairwise of one dtype and shape, with the same bits."""
    import torch

    return all(g.dtype == w.dtype and g.shape == w.shape and torch.equal(
        g.contiguous().view(torch.int32), w.contiguous().view(torch.int32))
        for g, w in zip(got, want))


def ragged_case(device, seed: int):
    """D not a multiple of the kernel's documents per block, A < 24, and a
    third of the frequencies 0 (padding and gaps inside documents)."""
    import torch

    D, U, A, M = 37, 20, 13, 3
    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, A + 1, size=D)
    valid = (np.arange(A)[:, None] < n_valid[None, :]).astype(np.float32)
    f = rng.integers(1, 4, size=(U, D)).astype(np.float32)
    f[rng.random((U, D)) < 0.3] = 0
    z0 = (rng.random((U, D)) * n_valid[None, :]).astype(np.int32)
    ndk0 = np.zeros((A, D), np.float32)
    own = np.zeros((D, U, A), np.float32)
    for p in range(U):
        np.add.at(ndk0, (z0[p], np.arange(D)), f[p])
        own[np.arange(D), p, z0[p]] = f[p]
    cv = own + rng.integers(0, 50, size=(D, U, A)).astype(np.float32)
    nkg = rng.integers(5000, 20000, size=(A, D)).astype(np.float32) + 89.69
    u = rng.random((M, U, D)).astype(np.float32)
    return tuple(torch.from_numpy(x).to(device) for x in (cv, f, u, z0, nkg, valid, ndk0))


def bucket_inputs(model, g: int, M: int, gen):
    """The kernel's arguments for bucket ``g`` of ``model``'s next block."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs_fused import gather_cv, slot_totals

    st = model.counts
    tv, tf = model._toks_v_t[g], model._toks_f_t[g]
    li = model.lab_ids_t[g]
    U, D = tv.shape
    cv = gather_cv(st.n_vk, tv, li)
    nkg = slot_totals(st.n_k, li, model.V * model.beta)
    u = torch.rand((M, U, D), generator=gen, device=tv.device)
    return (cv, tf, u, st.z[g], nkg, model._lab_valid_tt[g], st.n_dk[g])


def bound(args) -> tuple:
    """(seconds bound by bytes, seconds bound by operations) for one launch:
    each input read once and each output written once; operations for the
    positions whose f > 0 (the kernel skips the rest)."""
    cv, f, u, z0, nkg, valid, ndk0 = args
    D, U, A = cv.shape
    M = u.shape[0]
    n_bytes = 4 * (sum(t.numel() for t in args) + U * D + A * D)
    n_ops = OPS_PER_SLOT_DRAW * A * int((f > 0).sum()) * M
    return n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S


def kernel_phase(model, seed: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.ops.gibbs_fused import (
        FusedLDAState,
        _scatter_deltas,
        fused_train_block,
        gather_cv,
    )

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 1)
    a, b = model.alpha, model.beta
    M = 25
    rec = dict(ms=0.0, plain_ms=0.0, gather_ms=0.0, scatter_ms=0.0,
               bytes_s=0.0, ops_s=0.0, bound_ms=0.0, max_abs_err=0.0)
    for g in range(model.buckets.n_buckets):
        args = bucket_inputs(model, g, M, gen)
        got = fbc.fused_block(*args, a, b)
        want = fbc.fused_block_torch(*args, a, b)
        torch.cuda.synchronize()
        _check(_bitwise(got, want), f"kernel == plain version, bucket {g}")
        rec["max_abs_err"] = max(rec["max_abs_err"], _max_abs_err(got, want))
        k_ms = _median_ms(lambda: fbc.fused_block(*args, a, b), 20)
        p_ms = _median_ms(lambda: fbc.fused_block_torch(*args, a, b), 3)
        st = model.counts
        tv, tf, li = model._toks_v_t[g], model._toks_f_t[g], model.lab_ids_t[g]
        g_ms = _median_ms(lambda: gather_cv(st.n_vk, tv, li), 20)
        s_ms = _median_ms(lambda: _scatter_deltas(st.n_vk, tv, tf, li, st.z[g], got[0]), 20)
        by_bytes, by_ops = bound(args)
        D, U, A = args[0].shape
        print(f"bucket {g}: D={D} U={U} A={A} M={M}  kernel {k_ms:.4f} ms  "
              f"plain {p_ms:.2f} ms  bound {1e3 * max(by_bytes, by_ops):.5f} ms  "
              f"gather {g_ms:.4f} ms  scatter {s_ms:.4f} ms  bitwise equal")
        rec["ms"] += k_ms
        rec["plain_ms"] += p_ms
        rec["gather_ms"] += g_ms
        rec["scatter_ms"] += s_ms
        rec["bytes_s"] += by_bytes
        rec["ops_s"] += by_ops
        rec["bound_ms"] += 1e3 * max(by_bytes, by_ops)

    args = ragged_case(DEVICE, seed)
    got = fbc.fused_block(*args, a, b)
    want = fbc.fused_block_torch(*args, a, b)
    torch.cuda.synchronize()
    _check(_bitwise(got, want), "kernel == plain version, ragged case")
    rec["max_abs_err"] = max(rec["max_abs_err"], _max_abs_err(got, want))
    print("ragged case (D=37, U=20, A=13, M=3, 30% f=0): bitwise equal")

    # one whole merge block of the first bucket: card (kernel, gather and
    # scatter on CUDA) against CPU (plain version), the same uniforms
    st = model.counts
    tv, tf, li, lv = (model._toks_v_t[0], model._toks_f_t[0],
                      model.lab_ids_t[0], model._lab_valid_tt[0])
    U, D = tv.shape
    u = torch.rand((M, U, D), generator=gen, device=DEVICE)
    one = FusedLDAState(st.z[0], st.n_dk[0], st.n_vk, st.n_k)
    on_card = fused_train_block(one, tv, tf, li, lv, a, b, M, uniforms=u)
    on_cpu = fused_train_block(FusedLDAState(*(t.cpu() for t in one)),
                               tv.cpu(), tf.cpu(), li.cpu(), lv.cpu(), a, b, M,
                               uniforms=u.cpu())
    _check(_bitwise([x.cpu() for x in on_card], on_cpu),
           "merge block on the card == the same block on the CPU")
    print("merge block, bucket 0: card == CPU (z, n_dk, n_vk, n_k)")

    rec["bound_by"] = "operations" if rec["ops_s"] >= rec["bytes_s"] else "bytes"
    print(f"per merge block ({model.buckets.n_buckets} buckets): kernel "
          f"{rec['ms']:.4f} ms, plain {rec['plain_ms']:.2f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
          f"{rec['bytes_s'] * HBM_BYTES_PER_S / 1e6:.1f} MB, "
          f"{rec['ops_s'] * FP32_FLOP_PER_S / 1e9:.3f} GFLOP), gather "
          f"{rec['gather_ms']:.4f} ms, scatter {rec['scatter_ms']:.4f} ms")
    return rec


def main_path(corpus, dicti, seed: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    fbc.launches = 0
    t0 = time.perf_counter()
    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                       dicti, alpha=0.1, beta=0.01, seed=seed, n_buckets=4,
                       device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    th = model.run_test(corpus.test_docs, 50, 25)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = fbc.launches

    G = model.buckets.n_buckets
    st = model.counts
    total_f = float(model.n_tokens)
    _check(model._merge_M == 25, f"merge block M == 25 (got {model._merge_M})")
    _check(launches == (TRAIN_ITERS // 25) * G,
           f"kernel launches == blocks x buckets ({launches})")
    _check(float(st.n_vk.sum()) == total_f, "sum n_vk == sum f")
    _check(sum(float(x.sum()) for x in st.n_dk) == total_f, "sum n_dk == sum f")
    _check(float(st.n_vk.min()) >= 0 and min(float(x.min()) for x in st.n_dk) >= 0,
           "no negative count")
    _check(torch.equal(st.n_k, st.n_vk.sum(dim=0)), "n_k == n_vk.sum(0)")
    _check(th.shape == (len(corpus.test_docs), model.K) and bool(np.isfinite(th).all()),
           "fold-in θ finite, (n_test, K)")

    y_bin = binary_yreal(corpus.test_labs, model.labelmap)[:, 1:]
    th = th[:, 1:]
    nonzero = th.sum(axis=1) != 0
    metrics = evaluate_ranking(th[nonzero], y_bin[nonzero])
    _check(metrics["auc_roc"] > MIN_AUC, f"AUC {metrics['auc_roc']} > {MIN_AUC}")
    tokens_per_s = model.n_tokens * TRAIN_ITERS / (t2 - t1)
    print(f"main path: D={model.D} V={model.V} K={model.K} Kp={model.Kp} "
          f"A={model.A} buckets={[tuple(z.shape) for z in st.z]} M={model._merge_M}")
    print(f"  init {t1 - t0:.3f} s, train {TRAIN_ITERS} sweeps {t2 - t1:.3f} s "
          f"({tokens_per_s:.1f} tokens/s, {model.n_tokens} tokens/sweep), "
          f"fold-in test {t3 - t2:.3f} s")
    print(f"  kernel launches {launches}; perplexity {model.cur_perplx}; "
          f"test metrics {json.dumps(metrics)}")
    return dict(model=model, launches=launches, tokens_per_s=tokens_per_s,
                metrics=metrics)


def steady_training(model, perplexity: bool) -> dict:
    """More (50; 25) training calls on the trained model: ``STEADY_CALLS``
    timed on the host clock (median rate), one under torch.profiler for
    device time by kernel and the device's idle share of the wall time.  ``perplexity`` on is the
    CLI's default; off is bench.py's setting."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def train():
        model.run_training(TRAIN_ITERS, THINNING, perplexity=perplexity,
                           total_iters=TOTAL_ITERS)
        torch.cuda.synchronize()

    rates = []
    torch.cuda.synchronize()
    for _ in range(STEADY_CALLS):
        t0 = time.perf_counter()
        train()
        rates.append(model.n_tokens * TRAIN_ITERS / (time.perf_counter() - t0))
    tokens_per_s = float(np.median(rates))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    _check(busy_ms > 0, "the profiler recorded device time")
    top = [[e.key[:80], e.count, e.self_device_time_total / 1e3] for e in kernels[:6]]
    out = dict(tokens_per_s=tokens_per_s, profiled_wall_ms=wall_ms,
               device_busy_ms=busy_ms, device_idle_share=1.0 - busy_ms / wall_ms)
    print(f"steady training, perplexity {'on' if perplexity else 'off'}: "
          f"median {tokens_per_s:.1f} tokens/s over {len(rates)} calls "
          f"{[round(r) for r in rates]}; profiled call {wall_ms:.3f} ms wall, "
          f"device busy {busy_ms:.3f} ms (idle share {out['device_idle_share']:.4f})")
    for name, count, ms in top:
        print(f"  {ms:10.4f} ms  {count:6d} x  {name}")
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    # 1. environment
    card = _card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is off")

    # 2. kernel build
    _, secs, log = fbc.build()
    print(f"kernel build: {secs:.2f} s")
    for line in log.splitlines():
        if "registers" in line or "spill" in line:
            print("  " + line.strip())

    # 3. kernel against its plain version
    t0 = time.perf_counter()
    corpus = planted_corpus(args.seed)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    print(f"synthetic corpus: {time.perf_counter() - t0:.2f} s")
    probe = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                       dicti, alpha=0.1, beta=0.01, seed=args.seed, device=DEVICE)
    rec = kernel_phase(probe, args.seed)
    del probe

    # 4. main path
    run = main_path(corpus, dicti, args.seed)
    model = run.pop("model")
    steady = {p: steady_training(model, p) for p in (True, False)}

    # 5. records
    kernels = [{
        "name": "fused_block",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": run["launches"],
        "bitwise_equal": True,
        "max_abs_err": rec["max_abs_err"],
        "ms": rec["ms"],
        "plain_ms": rec["plain_ms"],
        "bound_ms": rec["bound_ms"],
        "bound_by": rec["bound_by"],
        "library_ms": None,
        "per": "merge block (4 bucket launches, M=25)",
        "gather_ms": rec["gather_ms"],
        "scatter_ms": rec["scatter_ms"],
        "train_tokens_per_s": run["tokens_per_s"],
        "steady_train_tokens_per_s": steady[True]["tokens_per_s"],
        "steady_train_tokens_per_s_no_perplexity": steady[False]["tokens_per_s"],
        "device_idle_share": steady[True]["device_idle_share"],
        "device_idle_share_no_perplexity": steady[False]["device_idle_share"],
        "auc_roc": run["metrics"]["auc_roc"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
