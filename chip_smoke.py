"""Smoke test of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py [--seed N]

Builds the port's CUDA kernels from the sources in this checkout, holds each
bitwise against its plain PyTorch version, then drives the port's paths at
the full width of the depth-3 abstracts split, on synthetic labelled corpora
made from ``--seed``.  Phases:

1. environment: torch, CUDA, the card's name and power limit;
2. kernel builds, one ``nvcc`` per source, all started together; the
   registers and spills ptxas reports for each of the warp route's
   instantiations and for the wide route's kernel, none of which may spill,
   and for each instantiation of the fold-in kernel (``foldin_ptxas``);
3. the merge-block kernel against ``fused_block_torch`` at every bucket of
   the fused path's first merge block (A = 24, M = 25) and at the edge
   cases (``edge_cases``: the staged, warp, wide and general routes' slot
   and position counts, each launched on the route ``route()`` names, by
   the counters), and one whole merge block on the card against the same
   block on the CPU; the kernel's device time, its chain steps (M × the
   most live positions of a document) and time per step, and the times of
   its call, its plain version and the block's gather and scatter; then the
   warp route and the general (CTA) route side by side at LocalLDA's K = 50
   and K = 100 shapes and at U = 1,024, A = 32, and the wide route and the
   general route at K = 300 and K = 1,000: device time per launch, ns per
   step, bound and plain version;
4. the fused Labeled-LDA path (``LabeledLDA`` → ``run_training`` →
   ``run_test`` → ranking metrics): 50 sweeps at (50; 25) within a
   2000-sweep budget, so the merge block is M = 25; count invariants, kernel
   launches, fold-in test of the held-out split and its AUC; then, with
   perplexity on (the CLI's default) and off (bench.py's setting), more
   timed training calls and one under torch.profiler (device time by
   kernel, idle share);
5. the exact sweep's draw and count-commit kernels against their plain
   versions (``draw_update`` and ``draw_rows`` against ``draw_update_torch``
   and ``draw_rows_torch``, ``commit_counts`` against
   ``commit_counts_torch``) at the first and last position of every bucket
   of the dense model (K = 512), at one CascadeLDA level-2 batch and at one
   ragged case, and one whole exact sweep of bucket 0 on the card against
   the same sweep on the CPU; times of the kernels and their plain
   versions; then one replayed CUDA-graph sweep over all buckets under
   torch.profiler: every draw and commit record and their mean device time,
   from the best of up to three padded sessions (``_most_records``);
6. the dense Labeled-LDA path at (50; 25): invariants, kernel launches
   (a draw per type position with a live row per sweep, and the commits),
   AUC, tokens/s; 3 graphed sweeps against 3 eager ones from one seed,
   bitwise, and the device time per position of replayed sweeps; and one
   (25; 25) call under torch.profiler, whose kernel records (the best of up
   to three padded sessions of more such calls) must reach the counted
   launches;
7. the compact Labeled-LDA path at (10; 5): invariants and AUC, no kernel;
8. CascadeLDA at the thesis config, ``go_down_tree(4, 2)`` (root level
   (16; 4)) on a JEL-shaped corpus, ``test_down_tree_batch`` of the test
   split and ``setup_theta``: macro AUC at each depth, kernel launches, rows
   and topics per level;
9. the product surface, as a user runs it: the CLIs on CSV files of the
   two corpora (``write_corpus_csv``), loaded, preprocessed and split again
   by the CLI.  The Labeled-LDA CLI at its defaults (fused, perplexity on)
   for 200 sweeps at thinning 25, so M = 25 and kernel 1 launches 32 times,
   with the wall time of each step and tokens/s; the same with ``--sweep
   dense`` and ``-p``, whose kernel-2 and commit launches must be as
   planned and whose pickled model must load back on the card; a run
   checkpointed every 25 sweeps against one killed by SIGKILL after its
   first checkpoint and resumed in a fresh process: every array of the two
   checkpoints and the four metric lines equal; the time of one checkpoint
   write; ``--progress --trace``; the CascadeLDA CLI at (4; 2); and
   ``lda_thesis_tpu_torch.entry``'s merge block;
10. LocalLDA as a user runs it: its CLI on a CSV of the planted corpus at
    the abstracts' vocabulary (V = 11,889), at its defaults (K = 20, fused,
    100 sweeps at thinning 10, one merge per sweep: 100 kernel-1 launches),
    with ``--sweep dense`` (its draw and commit launches as planned), with
    ``-k 50`` (A = 56: every kernel-1 launch on the warp route) and with
    ``-k 300`` (A = 304: every kernel-1 launch on the wide route, blocks ×
    buckets of them, and a replayed block's device time by step), each with
    the count invariants and a perplexity below V and followed by one block
    of its trained state on the card against the CPU; and a save/restore
    round trip of the LocalLDA checkpoint whose next call equals the
    uninterrupted one's;
11. the VI engine: the Labeled-LDA CLI with ``--engine vi -i 20`` on phase
    9's CSV, a non-falling ELBO, held-out AUC and seconds per CAVI step;
    then one ``fit_svi`` epoch of its model from a fresh start (2 batches
    of 2,048 documents and a CAVI pass), whose ELBO must rise;
12. HSLDA (no CUDA kernel of its own: its cycle is plain PyTorch, on the
    card one CUDA graph per cycle, ``models/hslda.CycleStep``, and one per
    save): one cycle of each coupling form (opt 1, opt 2 compact and
    blockwise, opt 3) at D = 64, L = 12, K = 8 on the card against the CPU
    from one state and one set of draws (count invariants exact, at least
    99% of the draws equal, η, a and β within 1e-4); two replayed
    ``run_training(6, 3)`` calls of each coupling at full width against
    ``eager_hslda_training``, bitwise, the second capturing no graph and
    running no body eagerly, with the cycle graph's node count, and a
    replayed z-sweep's device records against the eager sweep's; a replayed
    cycle's host ms to issue and device ms, and each block's host ms run
    eagerly and device ms as a graph of its own, at full width; the HSLDA
    CLI on a CSV of ``jel_corpus(seed,
    n_l3=371)`` (D = 4,171, N = 192, L = 512, K = 15) at ``-i 25 -s 5
    --opt 1`` with the default test (AUC > 0.6), a run of it killed by
    SIGKILL after its first checkpoint and resumed in a fresh process (every
    array and metric line equal), and ``--opt 2`` / ``--opt 3`` at ``-i 5``;
13. multi-device (``parallel/``): (a) four chains in one kernel-1 launch
    at full width against four single-chain launches with the same
    uniforms, bitwise, the counters reading 1 against 4, and the launch's
    own inputs through the plain version on the card, bitwise; (b)
    ``DistributedLabeledLDA`` over an explicit NCCL group of one rank, eight
    chains batched, ``run_training(50, 25, total_iters=2000)``: each chain's
    count invariants, kernel-1 launches equal to merge blocks × buckets (not
    × chains), the pooled fold-in's AUC and ``mc_error() > 0``; then
    chain-sweeps/s, tokens/s and the device's busy share at 1, 2, 4, 8 and
    16 chains, and at 8 chains with 4 buckets, each timed model's count
    invariants after its calls, and the 16-chain launch (66,736 documents)
    against single-chain launches and the plain version as in (a); (c)
    dense AD-LDA, two chains in the rank's one sweep graph, (10; 5):
    replayed sweeps equal eager ones bitwise, kernel-2 draws and commits
    as planned (iterations × a sweep's, not × chains), and one step on the
    card equals the same step on the CPU (kernel 2's plain version),
    bitwise; then kernel 2 over a chain axis at that shape
    (``md_dense_chains_case``): the batched draw and commit launches
    against their plain versions and single-chain launches at C = 3 and 8,
    a ragged live list and K = 1,100, bitwise; a 4-chain replayed sweep
    against 4 single-chain replayed sweeps, bitwise, and a sweep graph's
    node count at 1 and 16 chains; device ms per replayed sweep, batched
    against C single-chain graphs, its bound and peak memory at C = 1, 2,
    4, 8 and 16; (d) spawned ranks on the one card over gloo with
    CUDA tensors on the full corpus at (10; 5): (1, 2) fused and dense,
    (2, 2) replicated against (2, 2) vocab-sharded (z and tables bitwise
    equal), every merge leaving the data row's replicas identical, the
    global count invariants; (e) the CLI: ``--n-chains 8`` at (200; 25)
    with an AUC gate, fused and with ``--sweep dense`` (kernel-2 launches
    200 × a sweep's; wall by step), ``--n-data 2 --table-shard vocab`` under ``python -m
    torch.distributed.run --nproc-per-node 2`` with gloo, and a run at
    ``--n-chains 4 --save-every 25`` killed by SIGKILL after its first
    checkpoint and resumed in a fresh process (its shard's arrays and the
    metric lines equal the uninterrupted run's); one ``multi_device`` line;
14. multi-device HSLDA (``parallel/hslda_*``, no kernel of its own) at the
    JAX record's width (phase 12's corpus; only cycle and sweep counts are
    cut): (a) 4 chains in one replayed z-sweep graph against 4 single-chain
    graphs with the same generators, 3 sweeps: the share of equal draws (at
    least 99%) and whether they are bitwise, replay == eager bitwise, every
    chain's count invariants, device ms per replayed sweep both ways, the
    bound and the graph's node count; a 4-chain ``run_training(6, 3)``
    call through the loop's replayed cycle against the eager loop, bitwise,
    and against 4 single-chain cycle runners (the share of equal draws, at
    least 99%); (b) ``DistributedHSLDA`` on one rank
    at C = 1, 4, 16 and 64 chains: reckoned and peak device memory, four
    warm-up cycles and two saves (eager, capture), 3 timed cycles, cycles/s,
    chain-cycles/s, tokens/s, the device's busy share, each chain's
    invariants and finite η and β; (c) two gloo ranks on the card, mesh
    (1, 2), 2 chains, 3 cycles, replicated then vocab-sharded: every chain's
    replicas bitwise equal across the data row, the vocab-sharded counts
    equal to the replicated ones; (d) the HSLDA CLI with ``--n-chains 8 -i
    10 -s 5 --test-it 25 --test-s 5`` (chain-averaged AUC, wall by step, the
    fold-in against phase 12's single chain) and a run of it killed by
    SIGKILL after its first checkpoint and resumed in a fresh process, its
    shard (both kinds of generator state included) and marker equal to the
    uninterrupted run's; one ``multi_device_hslda`` line;
15. the test-time loops as replayed CUDA graphs, at full width: the
    Labeled-LDA fold-in on the planted corpus's test split, HSLDA's fold-in
    at phase 12's width at one chain and eight, CascadeLDA's
    ``test_down_tree_batch`` (4; 2), each loop's output (recorded from the
    model's own call) against its eager loop (``eager_fold_in``,
    ``eager_test_loop``, ``eager_cascade_loop``) from the same generator
    state, and 5 sweeps of each graphed sweep against the eager sweep
    function (``foldin_sweeps_case``, ``cascade_sweeps_case``), bitwise;
    ``LogLikelihood`` against ``log_likelihood`` on each bucket at three
    saves' estimates (``loglik_case``); a ``run_test`` after more training
    against an eager fold-in with the new φ̂; each graph's node count and
    the device ms per sweep of eager sweeps, graphed calls and replays;
    since the fold-in kernel (``ops/csrc/foldin.cu``) a fold-in sweep's
    graph is one node, and each fold-in's kernel time per sweep beside its
    bound and its plain body's, eager and replayed as a graph
    (``foldin_kernel_case``);
16. the training loops as replayed CUDA graphs, at full width, the saves
    (``ops/gibbs.SaveStep``) replayed too: three merge blocks of
    ``FusedBlocks`` on each route of kernel 1 (staged, warp, wide and
    general, at ``edge_cases`` shapes) against eager blocks; the divisor check (the
    thinned mean with its weights in device scalars against the division
    by a host number, bitwise, s = 1..50 on φ̂ and θ̂); then
    ``run_training`` calls of the Labeled-LDA fused path (50; 25) with
    perplexity off and on and with ``continue_avg``, of LocalLDA at K = 20
    and K = 50 (20; 10) and dense, of one rank of 8 chains with 4 buckets
    (50; 25) and of 8 dense AD-LDA chains (10; 5), of the Labeled-LDA
    dense (10; 5) and compact (10; 5) paths, each held to its eager loop of
    functional calls (``eager_training``, ``eager_chains_training``,
    ``eager_dense_chains_training``: ``fused_train_block_buckets``,
    ``exact_sweep`` or ``compact_sweep`` and the saves' functions in a loop,
    from the same state and generator state), bitwise in z, n_dk, n_vk,
    n_k, φ̂, θ̂, perplexities and the generators; kernel-1 launches per call
    equal to blocks × buckets, kernel-2 launches as planned; a model's
    later call of one setting captures no graph and runs no body eagerly
    (``replay_counts``); each block's (or compact sweep's) graph nodes,
    device ms per block eager, per runner call and per replay, a save's
    graph nodes, device and host ms eager and replayed (``save_timing``),
    a replayed merge block's device time by step (``merge_block_split``),
    tokens/s and the device's idle share of a profiled call, and peak
    device memory; then two ``run_training(6, 3)`` calls of ``HSLDA`` and
    of one rank of 8 HSLDA chains at full width against
    ``eager_hslda_training`` (``hslda_training_graphs``), the later call
    capturing nothing;
17. one JSON line of kernel records, the card's line, and the result line.

Every check raises; the script exits non-zero without a CUDA device.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import os
import re
import signal
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

SOURCE = "lda_thesis_tpu_torch/ops/csrc/fused_block.cu"
REPLACES = "lda_thesis_tpu/ops/gibbs_fused.py:246"
DRAW_SOURCE = "lda_thesis_tpu_torch/ops/csrc/draw_update.cu"
DRAW_REPLACES = "lda_thesis_tpu/ops/gibbs_pallas.py:38"
KERNEL2 = "draw_update_kernel"  # the CUDA kernels' names, as the profiler shows them
COMMIT = "count_commit_kernel"
# the commit kernel takes in the reference's table and topic-total scatters
COMMIT_REPLACES = "lda_thesis_tpu/ops/gibbs.py:178-187 (XLA scatter-adds, no TPU kernel)"
FOLDIN_SOURCE = "lda_thesis_tpu_torch/ops/csrc/foldin.cu"
FOLDIN_REPLACES = ("none: lda_thesis_tpu/ops/gibbs.py foldin_sweep is a lax.scan of XLA "
                   "ops; the kernel replaces the port's CUDA graph of them")
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_FLOP_PER_S = 67e12  # H100 SXM data sheet, fp32 outside the tensor cores
OPS_PER_SLOT_DRAW = 12  # fp32 operations per (slot, position, sweep)
# fused_block_cuda.max_positions(32) on an H100: the staged route's widest
# document at 32 slots, and fused_block_cuda.wide_max_slots(): the wide
# route's widest A (both checked against the card in kernel_phase)
STAGED_LIMIT_H100 = 563
WIDE_SLOTS_H100 = 9852
# fp32 operations per (row, topic) of one exact-sweep position: the
# decrement, +α, ·labs, +β, ·cv, ·recip, the cumsum add and the comparison
OPS_PER_TOPIC_DRAW = 8
TRAIN_ITERS, THINNING, TOTAL_ITERS = 50, 25, 2000
COMPACT_ITERS, COMPACT_THINNING = 10, 5
CASCADE_IT, CASCADE_S = 4, 2  # the thesis config; the root level runs (16; 4)
VI_ITERS = 20  # CAVI iterations of the --engine vi run
MIN_AUC = 0.6
STEADY_CALLS = 5
# launch records a profiler session may lose (PERF.md: sessions of a long
# process have lost one of 20 without a cause found); a time is then the
# mean of those kept
LOST_RECORDS = 2
# spin kernels launched ahead of a counted region to take a session's loss
# of its first records (_most_records)
PAD_LAUNCHES = 256
DEVICE = "cuda"
ROOT = Path(__file__).resolve().parent
KERNEL1 = "fused_block_kernel"
CLI_ITERS, CLI_THINNING = 200, 25  # M = 25: 8 merge blocks of 4 bucket launches
METRIC_LINES = re.compile(r"^(?:AUC ROC|one error|two error|F1 score).*$", re.M)


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


def _batch_ms(fn, reps: int) -> float:
    """Device time per call of ``fn`` from CUDA events around ``reps`` calls
    made back to back: where each call's kernel outlasts the host's time to
    make the next call, the device never waits on the host."""
    import torch

    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(fn, reps: int) -> float:
    """Device time per launch of ``fn``: ``reps`` calls captured as one CUDA
    graph, CUDA events around 10 replays.  A launch that takes less time on
    the card than its call takes on the host cannot be timed with events
    around the call, and profiler sessions in a long process have lost
    records (PERF.md); the replay's time includes the graph's gaps between
    launches (about 0.3 us or less against the profiler's kernel spans,
    tools/probe_draw_update.py)."""
    import torch

    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(reps):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(10):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (10 * reps)


def _profile(train) -> dict:
    """One call of ``train`` under torch.profiler: wall, device busy time,
    idle share and the top kernels by device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        train()
        torch.cuda.synchronize()
        wall_ms = 1e3 * (time.perf_counter() - t0)
    kernels = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernels.sort(key=lambda e: -e.self_device_time_total)
    busy_ms = sum(e.self_device_time_total for e in kernels) / 1e3
    _check(busy_ms > 0, "the profiler recorded device time")
    records = [[e.key, e.count, e.self_device_time_total / 1e3] for e in kernels]
    return dict(wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1.0 - busy_ms / wall_ms,
                top=[[k[:80], n, ms] for k, n, ms in records[:6]])


def _card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def route_ptxas(log: str) -> dict:
    """ptxas -v's report (``_nvcc.NVCC_FLAGS`` asks for it) on each
    instantiation of the warp route's kernel and on the wide route's:
    {"warp": {S: {"registers": n, "spill_stores": bytes}}, "wide": {...}}."""
    out, entry = {"warp": {}, "wide": {}}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"fused_block_(?:warp_kernelILi(\d+)E|(wide)_kernel)", line)
            entry = None
            if m:
                entry = dict(registers=None, spill_stores=None)
                if m.group(1):
                    out["warp"][int(m.group(1))] = entry
                else:
                    out["wide"] = entry
        elif entry is not None:
            spill = re.search(r"(\d+) bytes spill stores", line)
            regs = re.search(r"Used (\d+) registers", line)
            if spill:
                entry["spill_stores"] = int(spill.group(1))
            if regs:
                entry["registers"] = int(regs.group(1))
    return out


def foldin_ptxas(log: str) -> dict:
    """ptxas -v's report on each instantiation of the fold-in kernel:
    {"R<rows>/LS<ls>" or "wide/LS<ls>": {"registers": n, "spill_stores":
    bytes, "stack_frame": bytes}}."""
    out, entry = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            m = re.search(r"foldin_kernelILi(\d+)ELi(\d+)E|foldin_wide_kernelILi(\d+)E", line)
            entry = None
            if m:
                entry = dict(registers=None, spill_stores=None, stack_frame=None)
                key = f"R{m.group(1)}/LS{m.group(2)}" if m.group(1) else f"wide/LS{m.group(3)}"
                out[key] = entry
        elif entry is not None:
            for name, pat in (("spill_stores", r"(\d+) bytes spill stores"),
                              ("registers", r"Used (\d+) registers"),
                              ("stack_frame", r"(\d+) bytes stack frame")):
                m = re.search(pat, line)
                if m:
                    entry[name] = int(m.group(1))
    return out


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


CSV_LETTERS = "bcdfghjklmnpqrtvwxz"  # 19 consonants, no "s" or "y"


def csv_word(v: int) -> str:
    """Word ``v`` of a synthetic corpus as "q" and four base-19 digits over
    ``CSV_LETTERS``: no digit, stopword or suffix that the preprocessing
    pipeline would strip, so every such word comes through unchanged."""
    digits = []
    for _ in range(4):
        v, r = divmod(v, len(CSV_LETTERS))
        digits.append(CSV_LETTERS[r])
    return "q" + "".join(reversed(digits))


def csv_label(lab: str) -> str:
    """A synthetic corpus's label as a three-character JEL-shaped code:
    "L123" becomes "B23" (a letter for each hundred); JEL codes stay."""
    if len(lab) == 4 and lab.startswith("L"):
        n = int(lab[1:])
        return chr(65 + n // 100) + f"{n % 100:02d}"
    return lab


def write_corpus_csv(path: str, corpus) -> None:
    """Write a synthetic corpus's training and test documents, in that order,
    as the ``(id, text, labels)`` CSV that the CLIs load: words by
    ``csv_word``, labels by ``csv_label``, and of JEL-shaped label lists only
    the three-character leaves (``load_corpus(mode="prefix")`` rebuilds their
    ancestors)."""
    import csv

    docs = corpus.train_docs + corpus.test_docs
    labs = corpus.train_labs + corpus.test_labs
    with open(path, "w", newline="") as f:
        out = csv.writer(f)
        for i, (doc, lab) in enumerate(zip(docs, labs)):
            codes = [csv_label(x) for x in lab if len(x) not in (1, 2)]
            out.writerow([f"doc{i}", " ".join(csv_word(int(w[1:])) for w in doc),
                          " ".join(codes)])


def _auc(theta, labs, labelmap) -> dict:
    """Ranking metrics of a fold-in θ (root column dropped), as the CLI."""
    from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking

    y_bin = binary_yreal(labs, labelmap)[:, 1:]
    th = theta[:, 1:]
    nonzero = th.sum(axis=1) != 0
    return evaluate_ranking(th[nonzero], y_bin[nonzero])


def _check_counts(st, total_f: float, what: str) -> None:
    import torch

    _check(float(st.n_vk.sum()) == total_f, f"{what}: sum n_vk == sum f")
    _check(sum(float(x.sum()) for x in st.n_dk) == total_f, f"{what}: sum n_dk == sum f")
    _check(float(st.n_vk.min()) >= 0 and min(float(x.min()) for x in st.n_dk) >= 0,
           f"{what}: no negative count")
    _check(torch.equal(st.n_k, st.n_vk.sum(dim=0)), f"{what}: n_k == n_vk.sum(0)")


def block_case(device, seed: int, D: int, U: int, A: int, M: int,
               gaps: float = 0.3, zero_doc: bool = False):
    """Merge-block kernel inputs: documents of 1..U types with trailing
    padding, a share ``gaps`` of f = 0 positions inside them and, with
    ``zero_doc``, a first document whose f is all zero."""
    import torch

    rng = np.random.default_rng(seed)
    n_valid = rng.integers(1, A + 1, size=D)
    valid = (np.arange(A)[:, None] < n_valid[None, :]).astype(np.float32)
    length = rng.integers(1, U + 1, size=D)
    f = rng.integers(1, 4, size=(U, D)).astype(np.float32)
    f[np.arange(U)[:, None] >= length[None, :]] = 0
    f[rng.random((U, D)) < gaps] = 0
    if zero_doc:
        f[:, 0] = 0
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


def edge_cases() -> dict:
    """name -> (D, U, A, M, gaps, zero_doc): ragged shapes, one more
    document than an H100 holds at once (32 one-warp CTAs on each of 132
    SMs), one and 32 slots, a document with no live position, interior
    gaps, U = 512, and documents of one or two positions; then the warp
    route: 33, 56 (LocalLDA at K = 50), 64, 104 (K = 100), 136 and 32 ·
    S_MAX slots, one position past the staged route's limit at A = 32 (563
    on an H100), 1,024 positions at 32 and 104 slots, 600 positions at 13
    slots, one-position documents at 56 and 104 slots, and four sweeps at 56
    slots with interior gaps; then the wide route: the first multiple of 8
    past 32 · S_MAX, 301 slots (cv rows not 16-byte multiples: 4-byte
    copies), 304 (LocalLDA at K = 300), 512, 1,000 and 1,032 slots, the
    route's widest on an H100 (``WIDE_SLOTS_H100``), one-position documents,
    documents of at most a few live positions at interior gaps, interior
    gaps over four sweeps, 1,024 positions and one more document than an
    H100 holds at once, at 304 slots; then the general (CTA) route: one
    slot past the wide route's widest, and 16,000 slots, whose state
    overflows shared memory into a global scratch buffer."""
    from lda_thesis_tpu_torch.ops.fused_block_cuda import WARP_ROWS_MAX

    widest = 32 * WARP_ROWS_MAX
    return {
        "ragged D=37 U=20 A=13": (37, 20, 13, 3, 0.3, False),
        "two waves D=4225": (32 * 132 + 1, 8, 8, 2, 0.3, True),
        "A=1": (301, 40, 1, 4, 0.2, False),
        "A=32": (301, 40, 32, 4, 0.2, False),
        "all-zero document": (64, 24, 13, 3, 0.0, True),
        "interior gaps": (200, 64, 24, 5, 0.5, False),
        "U=512 A=32": (150, 512, 32, 3, 0.3, True),
        "U=1": (67, 1, 7, 3, 0.0, True),
        "U=1 A=1": (67, 1, 1, 3, 0.0, False),
        "U=2": (101, 2, 10, 4, 0.0, False),
        "A=33": (301, 40, 33, 4, 0.2, True),
        "A=56": (301, 40, 56, 3, 0.2, False),
        "A=64": (301, 40, 64, 3, 0.2, False),
        "A=104": (301, 40, 104, 3, 0.2, True),
        "A=136": (150, 40, 136, 3, 0.3, True),
        f"A={widest}": (150, 40, widest, 2, 0.3, False),
        f"A={widest + 8}": (60, 16, widest + 8, 2, 0.2, True),
        "A=1032": (60, 16, 1032, 2, 0.2, False),
        "U=564 A=32": (40, STAGED_LIMIT_H100 + 1, 32, 2, 0.3, True),
        "U=1024 A=32": (40, 1024, 32, 2, 0.3, False),
        "U=1024 A=104": (40, 1024, 104, 2, 0.3, False),
        "U=600 A=13": (40, 600, 13, 2, 0.3, True),
        "U=40 A=1032": (30, 40, 1032, 2, 0.3, True),
        "U=1 A=56": (67, 1, 56, 3, 0.0, False),
        "U=1 A=104": (67, 1, 104, 3, 0.0, False),
        "M=4 A=56 gaps": (200, 64, 56, 4, 0.5, False),
        "A=301": (150, 40, 301, 2, 0.3, True),
        "A=304": (301, 40, 304, 3, 0.2, False),
        "A=512": (150, 40, 512, 2, 0.3, False),
        "A=1000": (100, 40, 1000, 2, 0.3, True),
        f"A={WIDE_SLOTS_H100}": (3, 4, WIDE_SLOTS_H100, 2, 0.0, False),
        "U=1 A=304": (67, 1, 304, 3, 0.0, True),
        "U=1 A=1000": (67, 1, 1000, 3, 0.0, False),
        "few live A=304": (200, 64, 304, 4, 0.95, False),
        "M=4 A=304 gaps": (200, 64, 304, 4, 0.5, False),
        "U=1024 A=304": (40, 1024, 304, 2, 0.3, False),
        "two waves A=304": (32 * 132 + 1, 8, 304, 2, 0.3, True),
        f"A={WIDE_SLOTS_H100 + 1}": (3, 4, WIDE_SLOTS_H100 + 1, 2, 0.0, False),
        "A=16000": (3, 4, 16000, 2, 0.0, False),
    }


def _route_counts(fbc) -> tuple:
    """(launches, warp-route, wide-route and general-route launches) so far."""
    return fbc.launches, fbc.warp_launches, fbc.wide_launches, fbc.general_launches


def _set_route_counts(fbc, counts) -> None:
    fbc.launches, fbc.warp_launches, fbc.wide_launches, fbc.general_launches = counts


def _route_of(moved) -> str:
    """The route of launches whose counters moved by ``moved`` (all, warp,
    wide, general): the staged route where none of the three moved."""
    _, w, x, g = moved
    return "warp" if w else "wide" if x else "general" if g else "staged"


def _launched_on(fbc, before: tuple) -> str:
    """The route of the one launch made since ``_route_counts`` gave
    ``before``, checked against the counters: exactly one launch."""
    moved = tuple(x - y for x, y in zip(_route_counts(fbc), before))
    _check(moved[0] == 1 and sum(moved[1:]) <= 1,
           f"one kernel-1 launch (counters moved {moved})")
    return _route_of(moved)


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
    """(seconds bound by bytes, seconds bound by operations) for one launch,
    counting what this run's data needs: f, z and the per-slot inputs read
    once and z and n_dk written once, but the cv rows and the uniforms only
    of the positions whose f > 0, as the operations (the function draws
    nothing at the others, so it needs neither there)."""
    cv, f, u, z0, nkg, valid, ndk0 = args
    D, U, A = cv.shape
    M = u.shape[0]
    live = int((f > 0).sum())
    n_bytes = 4 * (live * (A + M) + 3 * U * D + 4 * A * D)
    n_ops = OPS_PER_SLOT_DRAW * A * live * M
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
    rec = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, gather_ms=0.0, scatter_ms=0.0,
               bytes_s=0.0, ops_s=0.0, bound_ms=0.0, chain_steps=0, max_abs_err=0.0,
               warp_ms=0.0,
               buckets=[], route_max_abs_err=dict.fromkeys(fbc.ROUTES, 0.0))
    for g in range(model.buckets.n_buckets):
        args = bucket_inputs(model, g, M, gen)
        got = fbc.fused_block(*args, a, b)
        want = fbc.fused_block_torch(*args, a, b)
        torch.cuda.synchronize()
        _check(_bitwise(got, want), f"kernel == plain version, bucket {g}")
        rec["max_abs_err"] = max(rec["max_abs_err"], _max_abs_err(got, want))
        k_ms = _batch_ms(lambda: fbc.fused_block(*args, a, b), 20)
        c_ms = _median_ms(lambda: fbc.fused_block(*args, a, b), 20)
        # the warp route on the same inputs, which it also takes: is the
        # staged route still the faster at the main path's shapes?
        w_got = fbc._launch("warp", *args, a, b)
        torch.cuda.synchronize()
        _check(_bitwise(w_got, want), f"warp route == plain version, bucket {g}")
        rec["route_max_abs_err"]["warp"] = max(rec["route_max_abs_err"]["warp"],
                                               _max_abs_err(w_got, want))
        w_ms = _batch_ms(lambda: fbc._launch("warp", *args, a, b), 20)
        p_ms = _median_ms(lambda: fbc.fused_block_torch(*args, a, b), 3)
        st = model.counts
        tv, tf, li = model._toks_v_t[g], model._toks_f_t[g], model.lab_ids_t[g]
        g_ms = _median_ms(lambda: gather_cv(st.n_vk, tv, li), 20)
        s_ms = _median_ms(lambda: _scatter_deltas(st.n_vk, tv, tf, li, st.z[g], got[0]), 20)
        by_bytes, by_ops = bound(args)
        D, U, A = args[0].shape
        # the longest dependent chain: M draws per live position of the
        # document with the most
        steps = M * int((args[1] > 0).sum(dim=0).max())
        print(f"bucket {g}: D={D} U={U} A={A} M={M}  kernel {k_ms:.4f} ms on the "
              f"card ({c_ms:.4f} ms per call), {steps} chain steps, "
              f"{1e6 * k_ms / steps:.1f} ns per step  warp route {w_ms:.4f} ms  plain "
              f"{p_ms:.2f} ms  bound {1e3 * max(by_bytes, by_ops):.5f} ms  gather "
              f"{g_ms:.4f} ms  scatter {s_ms:.4f} ms  bitwise equal")
        rec["ms"] += k_ms
        rec["warp_ms"] += w_ms
        rec["call_ms"] += c_ms
        rec["plain_ms"] += p_ms
        rec["gather_ms"] += g_ms
        rec["scatter_ms"] += s_ms
        rec["bytes_s"] += by_bytes
        rec["ops_s"] += by_ops
        rec["bound_ms"] += 1e3 * max(by_bytes, by_ops)
        rec["chain_steps"] += steps
        rec["buckets"].append(dict(D=D, U=U, A=A, steps=steps, ms=k_ms, warp_ms=w_ms,
                                   call_ms=c_ms,
                                   ns_per_step=1e6 * k_ms / steps,
                                   bound_ms=1e3 * max(by_bytes, by_ops)))
    rec["ns_per_step"] = 1e6 * rec["ms"] / rec["chain_steps"]

    limit = fbc.max_positions(32)
    _check(limit == STAGED_LIMIT_H100, f"max_positions(32) == {STAGED_LIMIT_H100} ({limit})")
    print(f"staged route: at most {limit} positions at A = 32 on this card")
    rec["wide_max_slots"] = wide = fbc.wide_max_slots()
    _check(wide == WIDE_SLOTS_H100, f"wide_max_slots() == {WIDE_SLOTS_H100} ({wide})")
    print(f"wide route: at most {wide} slots on this card")
    for i, (name, shape) in enumerate(edge_cases().items()):
        args = block_case(DEVICE, seed + i, *shape)
        D, U, A, M_e = shape[:4]
        before = _route_counts(fbc)
        got = fbc.fused_block(*args, a, b)
        ran = _launched_on(fbc, before)
        want = fbc.fused_block_torch(*args, a, b)
        torch.cuda.synchronize()
        _check(_bitwise(got, want), f"kernel == plain version, {name}")
        route = fbc.route(U, A)
        _check(ran == route, f"{name}: launched on the {ran} route, route() names {route}")
        rec["route_max_abs_err"][ran] = max(rec["route_max_abs_err"][ran],
                                            _max_abs_err(got, want))
        if shape[-1]:
            _check(torch.equal(got[0][:, 0], args[3][:, 0]) and _bitwise([got[1][:, 0]],
                   [args[6][:, 0]]), f"{name}: the all-zero document is unchanged")
        rec["max_abs_err"] = max(rec["max_abs_err"], _max_abs_err(got, want))
        print(f"{name} (D={D} U={U} A={A} M={M_e}, {route} route): bitwise equal")
    timed = route_timing(seed, a, b)
    for kernel in TIMED_ROUTES:
        rec["route_max_abs_err"][kernel] = max(rec["route_max_abs_err"][kernel],
                                               timed.pop(f"{kernel}_max_abs_err"))
    rec["timed"] = timed

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
          f"{rec['ms']:.4f} ms on the card ({rec['call_ms']:.4f} ms per call), "
          f"{rec['chain_steps']} chain steps, {rec['ns_per_step']:.1f} ns per step, "
          f"the warp route on the same inputs {rec['warp_ms']:.4f} ms "
          f"({rec['warp_ms'] / rec['ms']:.2f}x), plain {rec['plain_ms']:.2f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']}; "
          f"{rec['bytes_s'] * HBM_BYTES_PER_S / 1e6:.1f} MB, "
          f"{rec['ops_s'] * FP32_FLOP_PER_S / 1e9:.3f} GFLOP), gather "
          f"{rec['gather_ms']:.4f} ms, scatter {rec['scatter_ms']:.4f} ms")
    return rec


# (D, U, A, M) of the timed shapes, each on its own route beside the
# general (CTA) route: the warp route's at LocalLDA's K = 50 and K = 100 on
# the abstracts (one bucket, merge every sweep) and a 1,024-position bucket
# at 32 slots, past the staged route's limit; the wide route's at K = 300
# and K = 1,000
WIDE_SLOT_SHAPE = (4635, 128, 56, 1)
STREAMED_SHAPE = (4635, 1024, 32, 1)
K100_SHAPE = (4635, 128, 104, 1)
K300_SHAPE = (4635, 128, 304, 1)
K1000_SHAPE = (4635, 128, 1000, 1)
TIMED_SHAPES = {"wide_slot": WIDE_SLOT_SHAPE, "streamed": STREAMED_SHAPE, "k100": K100_SHAPE,
                "k300": K300_SHAPE, "k1000": K1000_SHAPE}
TIMED_ROUTES = ("warp", "wide", "general")


def route_timing(seed: int, alpha: float, beta: float) -> dict:
    """Device ms per launch of the route ``route()`` names and of the
    general (CTA) route, side by side, at each of ``TIMED_SHAPES``: each
    route bitwise against the plain version first, then CUDA events around
    10 back-to-back launches, in the order route, general, general, route
    (each route's time the mean of its two); beside them the chain steps,
    ns per step, ``bound`` and the plain version's time."""
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    out = {f"{kernel}_max_abs_err": 0.0 for kernel in TIMED_ROUTES}
    for key, (D, U, A, M) in TIMED_SHAPES.items():
        args = block_case(DEVICE, seed + A, D, U, A, M, gaps=0.0)
        own = fbc.route(U, A)
        _check(own == ("warp" if A <= 32 * fbc.WARP_ROWS_MAX else "wide"),
               f"{key}: the {own} route's shape")
        pair = (own, "general")
        t0 = time.perf_counter()
        want = fbc.fused_block_torch(*args, alpha, beta)
        torch.cuda.synchronize()
        plain_ms = 1e3 * (time.perf_counter() - t0)
        for kernel in pair:
            got = fbc._launch(kernel, *args, alpha, beta)
            torch.cuda.synchronize()
            _check(_bitwise(got, want), f"{kernel} route == plain version, {key} "
                                        f"(D={D} U={U} A={A})")
            out[f"{kernel}_max_abs_err"] = max(out[f"{kernel}_max_abs_err"],
                                               _max_abs_err(got, want))
        times = {kernel: [] for kernel in pair}
        for kernel in pair + pair[::-1]:
            times[kernel].append(
                _batch_ms(lambda: fbc._launch(kernel, *args, alpha, beta), 10))
        by_bytes, by_ops = bound(args)
        bound_ms = 1e3 * max(by_bytes, by_ops)
        steps = M * int((args[1] > 0).sum(dim=0).max())
        out[f"{key}_shape"] = [D, U, A, M]
        out[f"{key}_route"] = own
        out[f"{key}_steps"] = steps
        out[f"{key}_bound_ms"] = bound_ms
        out[f"{key}_bound_by"] = "operations" if by_ops >= by_bytes else "bytes"
        out[f"{key}_plain_ms"] = plain_ms
        for kernel in pair:
            ms = float(np.mean(times[kernel]))
            out[f"{key}_{kernel}_ms"] = ms
            out[f"{key}_{kernel}_runs_ms"] = times[kernel]
            out[f"{key}_{kernel}_ns_per_step"] = 1e6 * ms / steps
            print(f"{kernel} route, {key} (D={D} U={U} A={A} M={M}): {ms:.4f} ms per launch "
                  f"on the card ({' / '.join(f'{t:.4f}' for t in times[kernel])}), {steps} "
                  f"chain steps, {1e6 * ms / steps:.1f} ns per step, bound {bound_ms:.5f} ms "
                  f"({out[f'{key}_bound_by']}), {ms / bound_ms:.1f}x the bound; plain "
                  f"{plain_ms:.2f} ms; bitwise equal")
        print(f"{key}: the {own} route takes "
              f"{out[f'{key}_{own}_ms'] / out[f'{key}_general_ms']:.3f} of the general "
              f"route's time")
        del args, got, want
    return out


def main_path(corpus, dicti, seed: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    fbc.launches = duc.launches = duc.commit_launches = 0
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
    _check(duc.launches == duc.commit_launches == 0,
           "the fused path launches no draw or commit kernel")

    G = model.buckets.n_buckets
    st = model.counts
    _check(model._merge_M == 25, f"merge block M == 25 (got {model._merge_M})")
    _check(launches == (TRAIN_ITERS // 25) * G,
           f"kernel launches == blocks x buckets ({launches})")
    _check_counts(st, float(model.n_tokens), "fused")
    _check(th.shape == (len(corpus.test_docs), model.K) and bool(np.isfinite(th).all()),
           "fold-in θ finite, (n_test, K)")
    metrics = _auc(th, corpus.test_labs, model.labelmap)
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
    device time by kernel and the device's idle share of the wall time.
    ``perplexity`` on is the CLI's default; off is bench.py's setting."""
    import torch

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
    prof = _profile(train)
    out = dict(tokens_per_s=tokens_per_s, profiled_wall_ms=prof["wall_ms"],
               device_busy_ms=prof["busy_ms"], device_idle_share=prof["idle_share"])
    print(f"steady training, perplexity {'on' if perplexity else 'off'}: "
          f"median {tokens_per_s:.1f} tokens/s over {len(rates)} calls "
          f"{[round(r) for r in rates]}; profiled call {prof['wall_ms']:.3f} ms wall, "
          f"device busy {prof['busy_ms']:.3f} ms (idle share {prof['idle_share']:.4f})")
    for name, count, ms in prof["top"]:
        print(f"  {ms:10.4f} ms  {count:6d} x  {name}")
    return out


# ---------------------------------------------------------------- kernel 2


def draw_inputs(tok_v_t, tok_f_t, z_t, n_dk, n_vk, n_k, labs, p: int, vbeta: float, gen):
    """The draw-update kernel's arguments at position ``p`` of an exact
    sweep from the given state, formed as ``ops/gibbs.exact_sweep`` forms
    them (the table decrement lands on a copy)."""
    import torch

    K = n_vk.shape[1]
    z_old = z_t[p].contiguous()
    f = tok_f_t[p].contiguous()
    dec = torch.zeros((K,), dtype=torch.float32, device=n_k.device).index_add_(0, z_old, f)
    table = n_vk.clone()
    table.view(-1).index_add_(0, tok_v_t[p] * K + z_old, -f)
    cv = table.index_select(0, tok_v_t[p])
    recip = 1.0 / ((n_k - dec) + vbeta)
    u = torch.rand(tuple(f.shape), generator=gen, device=f.device)
    return [u, f, z_old, labs.contiguous(), n_dk.clone(), cv, recip]


def planned_sweep_launches(tok_f_t) -> tuple:
    """(draws, commits) of one exact sweep over positions ``tok_f_t (U, D)``:
    a draw per position with a live row (f > 0), a commit per position
    whose own or previous position has one, and a last commit after a live
    last position; positions with nothing to do launch nothing."""
    live = (tok_f_t > 0).any(dim=1).tolist()
    commits = sum(live[p] or (p > 0 and live[p - 1]) for p in range(len(live)))
    return sum(live), commits + bool(live and live[-1])


def sweep_inputs(tok_v_t, tok_f_t, z_t, n_dk, n_vk, n_k, labs, p: int, gen):
    """The sweep's commit and draw arguments at position ``p`` from the
    given state: ``commit`` (table, n_k, dec, inc) with the table and totals
    copied, and ``draw`` (draw_rows' arguments but α, β, V·β) on copies
    where the commit has landed."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops.gibbs import live_rows

    def slots(q):
        live, _ = live_rows(tok_v_t[q:q + 1], tok_f_t[q:q + 1])[0]
        return duc.Slots(tok_v_t[q], z_t[q], tok_f_t[q], live)

    dec, inc = slots(p), (slots(p - 1) if p > 0 else None)
    words = dec.rows[dec.live.long()]
    commit = [n_vk.clone(), n_k.clone(), dec, inc]
    table, nk = n_vk.clone(), n_k.clone()
    duc.commit_counts_torch(table, nk, dec, None)
    u = torch.rand(tuple(dec.f.shape), generator=gen, device=dec.f.device)
    draw = [u, dec.f, dec.z.clone(), labs.contiguous(), n_dk.clone(), table, words, nk,
            dec.live]
    return commit, draw


def _compare_sweep_steps(commit, draw, a, b, vbeta, what: str) -> float:
    """The commit and the draw kernels against their plain versions on
    copies of the state: bitwise equal; returns the largest difference."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    got, want = [t.clone() for t in commit[:2]], [t.clone() for t in commit[:2]]
    duc.commit_counts(*got, *commit[2:])
    duc.commit_counts_torch(*want, *commit[2:])
    outs = []
    for fn in (duc.draw_rows, duc.draw_rows_torch):
        z, nd = draw[2].clone(), draw[4].clone()
        fn(draw[0], draw[1], z, draw[3], nd, *draw[5:], a, b, vbeta)
        outs.append([z, nd])
    torch.cuda.synchronize()
    _check(_bitwise(got, want), f"commit kernel == plain version, {what}")
    _check(_bitwise(*outs), f"draw kernel (table in place) == plain version, {what}")
    return max(_max_abs_err(got, want), _max_abs_err(*outs))


def sweep_commit_bound_ms(tok_f_t, K: int, chains: int = 1) -> list:
    """Bound (ms) of each commit launch of one sweep of a bucket (the
    position's decrements and the previous position's increments, and a
    last commit of the final increments), by bytes: per live slot its row
    index, table row and frequency read (shared by the chains) and, per
    chain, its topic read and its table element read and written (28 bytes
    at one chain), and each chain's n_k read and written once; two adds a
    slot and chain."""
    live = (tok_f_t > 0).sum(dim=1).tolist() + [0]
    slots = [live[p] + (live[p - 1] if p else 0) for p in range(len(live))]
    return [1e3 * 4 * (4 * n + chains * (3 * n + 2 * K)) / HBM_BYTES_PER_S
            for n in slots if n]


def sweep_bound_ms(tok_f_t, K: int, chains: int = 1) -> list:
    """Bound (ms) of each draw launch of one sweep of a bucket for
    ``chains`` chains: per live row its labs row (shared) and each chain's
    n_dk and table rows, 12·K bytes at one chain, and the (D,) and (K,)
    vectors (``draw_bound``)."""
    U, D = tok_f_t.shape
    C = chains
    out = []
    for live in (tok_f_t > 0).sum(dim=1).tolist():
        if live:
            by_bytes = 4 * ((2 * C + 1) * live * K + 2 * C * live + (3 * C + 1) * D
                            + 2 * C * K) / HBM_BYTES_PER_S
            by_ops = OPS_PER_TOPIC_DRAW * K * live * C / FP32_FLOP_PER_S
            out.append(1e3 * max(by_bytes, by_ops))
    return out


def dense_state_copy(model):
    """A copy of ``model``'s dense state, z position-major."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import BucketLDAState

    st = model.counts
    return BucketLDAState(
        z=tuple(z.T.clone(memory_format=torch.contiguous_format) for z in st.z),
        n_dk=tuple(x.clone() for x in st.n_dk), n_vk=st.n_vk.clone(), n_k=st.n_k.clone())


def bucket_runners(model):
    """One ``ExactSweep`` per bucket over a copy of ``model``'s dense state;
    returns the runners and that state."""
    from lda_thesis_tpu_torch.ops.gibbs import ExactSweep

    state = dense_state_copy(model)
    runs = [ExactSweep(state.z[g], state.n_dk[g], state.n_vk, state.n_k, model._toks_v_t[g],
                       model._toks_f_t[g], model.labs_t[g], model.alpha, model.beta,
                       float(model.V * model.beta))
            for g in range(model.buckets.n_buckets)]
    return runs, state


def graphed_sweep_profile(model, seed: int) -> dict:
    """One replayed sweep over all buckets under torch.profiler, after an
    eager sweep and the capture: every draw and commit record
    (``_most_records``), their mean device time per launch, and the draws'
    mean bound."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    runs, _ = bucket_runners(model)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    for _ in range(2):  # eager, then capture and the first replay
        for run in runs:
            run(gen)
    torch.cuda.synchronize()
    plan = [planned_sweep_launches(tf) for tf in model._toks_f_t]
    draws, commits = sum(p[0] for p in plan), sum(p[1] for p in plan)

    def sweep():
        d0, c0 = duc.launches, duc.commit_launches
        for run in runs:
            run(gen)
        _check((duc.launches - d0, duc.commit_launches - c0) == (draws, commits),
               f"a replayed sweep counts its planned launches ({draws}, {commits})")

    rec = _most_records(sweep, draws + commits, names=(KERNEL2, COMMIT))
    (n_draw, draw_ms), (n_commit, commit_ms) = rec[KERNEL2], rec[COMMIT]
    _check(draws - LOST_RECORDS <= n_draw <= draws
           and commits - LOST_RECORDS <= n_commit <= commits,
           f"the profiler recorded the kernel nodes of the replayed sweep "
           f"({n_draw}/{draws} draws, {n_commit}/{commits} commits)")
    bounds = [b for tf in model._toks_f_t for b in sweep_bound_ms(tf, model.Kp)]
    c_bounds = [b for tf in model._toks_f_t for b in sweep_commit_bound_ms(tf, model.Kp)]
    _check(len(c_bounds) == commits, "one commit bound per planned commit")
    return dict(draws=draws, commits=commits, ms=draw_ms / n_draw, commit_ms=commit_ms / n_commit,
                bound_ms=float(np.mean(bounds)), commit_bound_ms=float(np.mean(c_bounds)),
                records=(n_draw, n_commit))


def draw_bound(args) -> tuple:
    """(seconds bound by bytes, seconds bound by operations) for one launch.
    A row with f = 0 only keeps its topic, so only the rows with f > 0 need
    their n_dk, cv and labs rows read, and each writes back two n_dk
    elements (at z_old and z_new); the (D,) vectors u, f, z_old and z_new
    and the (K,) vectors recip and Δn_k are read or written once."""
    u, f, z_old, labs, n_dk, cv, recip = args
    D, K = n_dk.shape
    live = int((f > 0).sum())
    n_bytes = 4 * (3 * live * K + 2 * live + 4 * D + 2 * K)
    n_ops = OPS_PER_TOPIC_DRAW * K * live
    return n_bytes / HBM_BYTES_PER_S, n_ops / FP32_FLOP_PER_S


def ragged_draw_case(device, seed: int):
    """D = 37, K = 40 (not multiples of the warp), a third of f = 0, and
    one all-zero label row with f = 0 (a padded row)."""
    import torch

    D, K = 37, 40
    rng = np.random.default_rng(seed)
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    f = rng.integers(1, 4, size=D).astype(np.float32)
    f[rng.random(D) < 0.33] = 0.0
    labs[5], f[5] = 0.0, 0.0
    z_old = (rng.random(D) * K).astype(np.int32)
    n_dk = rng.integers(0, 20, size=(D, K)).astype(np.float32)
    n_dk[np.arange(D), z_old] += f
    cv = rng.integers(0, 300, size=(D, K)).astype(np.float32)
    recip = (1.0 / (rng.integers(1000, 9000, size=K) + 89.69)).astype(np.float32)
    u = rng.random(D).astype(np.float32)
    return [torch.from_numpy(x).to(device) for x in (u, f, z_old, labs, n_dk, cv, recip)]


def _compare_draw(args, a, b, what: str) -> float:
    """Kernel and plain version on clones of ``args``: bitwise equal
    (n_dk, z_new, dnk); returns the largest absolute difference."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    got = duc.draw_update(*[t.clone() for t in args], a, b)
    want = duc.draw_update_torch(*[t.clone() for t in args], a, b)
    torch.cuda.synchronize()
    _check(_bitwise(got, want), f"draw-update kernel == plain version, {what}")
    _check(bool(torch.isfinite(got[0]).all()), f"finite n_dk, {what}")
    return _max_abs_err(got, want)


def chain_step_inputs(device, seed: int, C: int, D: int, K: int, V: int) -> dict:
    """One position of a C-chain exact sweep on synthetic state: shared
    frequencies ``f`` (a third zero), words, label mask and a ragged live
    list that also holds one row with f = 0; per chain, topics and uniforms
    (``z_all``, ``u_all`` ``(C, 2, D)``: the previous position and this
    one, strided across chains as a sweep's are), ``n_dk (C, D, K)``, a
    table ``(C, V, K)`` and its totals.  The previous position's slots
    (``inc_*``) are the same documents in reverse order."""
    import torch

    rng = np.random.default_rng(seed)
    f = rng.integers(1, 4, size=D).astype(np.float32)
    f[rng.random(D) < 0.33] = 0.0
    f[1] = 0.0
    live = np.sort(np.concatenate([np.nonzero(f > 0)[0], [1]])).astype(np.int32)
    rows = rng.integers(0, V, size=D)
    labs = (rng.random((D, K)) < 0.3).astype(np.float32)
    labs[:, 0] = 1.0
    z_all = rng.integers(0, K, size=(C, 2, D)).astype(np.int32)
    n_dk = rng.integers(0, 20, size=(C, D, K)).astype(np.float32)
    for c in range(C):
        n_dk[c, np.arange(D), z_all[c, 1]] += f
    table = rng.integers(0, 300, size=(C, V, K)).astype(np.float32)
    # the decrements leave every count >= 0
    np.add.at(table, (np.arange(C)[:, None], rows[None, :], z_all[:, 1]), f[None, :])
    t = dict(f=f, live=live, rows=rows, labs=labs, z_all=z_all, n_dk=n_dk, table=table,
             n_k=table.sum(axis=1), u_all=rng.random((C, 2, D)).astype(np.float32),
             inc_rows=rows[::-1].copy(), inc_f=f[::-1].copy(),
             inc_live=np.nonzero(f[::-1] > 0)[0].astype(np.int32))
    t = {k: torch.from_numpy(np.ascontiguousarray(x)).to(device) for k, x in t.items()}
    t["words"] = t["rows"][t["live"].long()]
    return t


def chain_position_inputs(tok_v_t, tok_f_t, z_t, n_dk, n_vk, n_k, labs, p: int, C: int,
                          gen) -> dict:
    """:func:`chain_step_inputs`' form at position ``p`` of a sweep of the
    first ``C`` chains of the state ``z_t (L, U, D)``, ``n_dk (L, D, K)``,
    ``n_vk (L, V, K)``, ``n_k (L, K)`` over ``tok_v_t``, ``tok_f_t (U, D)``,
    with fresh uniforms from ``gen``; at p = 0 nothing is incremented."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import live_rows

    def live(q):
        return live_rows(tok_v_t[q:q + 1], tok_f_t[q:q + 1])[0][0]

    q = max(p - 1, 0)
    cur = live(p)
    inc_live = live(q) if p else cur[:0]
    D = tok_v_t.shape[1]
    return dict(f=tok_f_t[p], live=cur, rows=tok_v_t[p], labs=labs,
                z_all=torch.stack([z_t[:C, q], z_t[:C, p]], dim=1), n_dk=n_dk[:C].clone(),
                table=n_vk[:C].clone(), n_k=n_k[:C].clone(),
                u_all=torch.rand((C, 2, D), generator=gen, device=tok_v_t.device),
                inc_rows=tok_v_t[q], inc_f=tok_f_t[q], inc_live=inc_live,
                words=tok_v_t[p][cur.long()])


def chain_step(t: dict, draw, commit, a: float, b: float, vbeta: float, c=None) -> list:
    """One sweep position as ``exact_sweep`` makes it, on copies of chain
    ``c``'s state (every chain, batched, when ``c`` is None): ``commit``
    lands the previous position's increments and this one's decrements,
    then ``draw`` draws the live rows against the committed table.
    Returns ``[z, n_dk, table, n_k]``."""
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    one = (lambda x: x.clone()) if c is None else (lambda x: x[c].clone())
    z_all, u_all, n_dk, table, n_k = (one(t[k]) for k in ("z_all", "u_all", "n_dk",
                                                         "table", "n_k"))
    z_prev, z, u = z_all[..., 0, :], z_all[..., 1, :], u_all[..., 1, :]
    commit(table, n_k, duc.Slots(t["rows"], z, t["f"], t["live"]),
           duc.Slots(t["inc_rows"], z_prev, t["inc_f"], t["inc_live"]))
    draw(u, t["f"], z, t["labs"], n_dk, table, t["words"], n_k, t["live"], a, b, vbeta)
    return [z, n_dk, table, n_k]


def chain_step_check(t: dict, a: float, b: float, vbeta: float, what: str) -> float:
    """The chain-batched commit and draw kernels (one launch each for every
    chain) against their plain versions on the same inputs and against one
    single-chain launch per chain, bitwise; the counters read 1 and 1 for
    the batch, and are restored (these launches are comparisons).  Returns
    the largest difference from the plain version."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    before = (duc.launches, duc.commit_launches)
    got = chain_step(t, duc.draw_rows, duc.commit_counts, a, b, vbeta)
    batch = (duc.launches - before[0], duc.commit_launches - before[1])
    plain = chain_step(t, duc.draw_rows_torch, duc.commit_counts_torch, a, b, vbeta)
    C = t["z_all"].shape[0]
    singles = [chain_step(t, duc.draw_rows, duc.commit_counts, a, b, vbeta, c)
               for c in range(C)]
    single = (duc.launches - before[0] - batch[0],
              duc.commit_launches - before[1] - batch[1])
    duc.launches, duc.commit_launches = before
    torch.cuda.synchronize()
    want = (int(t["live"].numel() > 0), int(t["live"].numel() + t["inc_live"].numel() > 0))
    _check(batch == want and single == (C * want[0], C * want[1]),
           f"{what}: launches {batch} for {C} chains batched, {single} single-chain")
    _check(_bitwise(got[2:], plain[2:]), f"batched commit kernel == plain version, {what}")
    _check(_bitwise(got[:2], plain[:2]), f"batched draw kernel == plain version, {what}")
    for c, one in enumerate(singles):
        _check(_bitwise([g[c] for g in got], one),
               f"chain {c} of the batched launches == its single-chain launches, {what}")
    return _max_abs_err(got, plain)


def draw_kernel_phase(corpus, dicti, jel, jel_dicti, seed: int) -> dict:
    import torch

    from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops.gibbs import (
        LDACounts,
        init_counts,
        train_sweep,
        train_sweep_buckets,
    )

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 2)
    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                       dicti, alpha=0.1, beta=0.01, seed=seed, sweep="dense",
                       device=DEVICE)
    a, b = model.alpha, model.beta
    vbeta = float(model.V * b)
    st = model.counts
    rec = dict(ms=0.0, call_ms=0.0, plain_ms=0.0, bytes_s=0.0, ops_s=0.0,
               bound_ms=0.0, max_abs_err=0.0, buckets=[])
    positions = 0
    for g in range(model.buckets.n_buckets):
        tv, tf = model._toks_v_t[g], model._toks_f_t[g]
        U, D = tv.shape
        z_t = st.z[g].T.contiguous()
        times = []
        for p in (0, U - 1):
            what = f"bucket {g} position {p}"
            args = draw_inputs(tv, tf, z_t, st.n_dk[g], st.n_vk, st.n_k,
                               model.labs_t[g], p, vbeta, gen)
            commit, draw = sweep_inputs(tv, tf, z_t, st.n_dk[g], st.n_vk, st.n_k,
                                        model.labs_t[g], p, gen)
            rec["max_abs_err"] = max(rec["max_abs_err"], _compare_draw(args, a, b, what),
                                     _compare_sweep_steps(commit, draw, a, b, vbeta, what))
            if not draw[-1].numel():
                print(f"bucket {g}: position {p}/{U} has no live row: no draw launched")
                continue
            # the draw as the sweep launches it: table rows in place, recip from n_k
            scratch = [t.clone() for t in draw]
            k_ms = _graph_ms(lambda: duc.draw_rows(*scratch, a, b, vbeta), 20)
            c_ms = _median_ms(lambda: duc.draw_rows(*scratch, a, b, vbeta), 20)
            p_ms = _median_ms(lambda: duc.draw_rows_torch(*scratch, a, b, vbeta), 3)
            by_bytes, by_ops = draw_bound(args)
            times.append((k_ms, c_ms, p_ms, by_bytes, by_ops))
            print(f"bucket {g}: D={D} K={model.Kp} position {p}/{U}  kernel "
                  f"{k_ms:.4f} ms on the card ({c_ms:.4f} ms per call)  plain "
                  f"{p_ms:.3f} ms  bound {1e3 * max(by_bytes, by_ops):.5f} ms "
                  f"({int((args[1] > 0).sum())} rows with f > 0)  bitwise equal "
                  f"(draw_update, draw_rows, commit_counts)")
            if g == 0 and p == 0:
                # a commit with a full decrement and a full increment: the
                # plain version, and two index_add_ calls on prepared indices
                sc, _ = sweep_inputs(tv, tf, z_t, st.n_dk[g], st.n_vk, st.n_k,
                                     model.labs_t[g], 1, gen)
                rec["commit_plain_ms"] = _median_ms(lambda: duc.commit_counts_torch(*sc), 20)
                idx = torch.cat([s_.rows[s_.live.long()] * model.Kp + s_.z[s_.live.long()]
                                 for s_ in sc[2:]])
                zs = torch.cat([s_.z[s_.live.long()].long() for s_ in sc[2:]])
                vals = torch.cat([-sc[2].f[sc[2].live.long()], sc[3].f[sc[3].live.long()]])
                flat = sc[0].view(-1)
                rec["commit_library_ms"] = _median_ms(
                    lambda: (flat.index_add_(0, idx, vals), sc[1].index_add_(0, zs, vals)), 20)
                print(f"commit at bucket 0 position 1 ({idx.numel()} slots): plain "
                      f"{rec['commit_plain_ms']:.4f} ms, two index_add_ calls "
                      f"{rec['commit_library_ms']:.4f} ms")
        k_ms, c_ms, p_ms, by_bytes, by_ops = (float(np.mean(x)) for x in zip(*times))
        # weight each bucket by its positions: the path launches once per position
        rec["ms"] += U * k_ms
        rec["call_ms"] += U * c_ms
        rec["plain_ms"] += U * p_ms
        rec["bytes_s"] += U * by_bytes
        rec["ops_s"] += U * by_ops
        rec["bound_ms"] += U * 1e3 * max(by_bytes, by_ops)
        rec["buckets"].append(dict(D=D, K=model.Kp, U=U, ms=k_ms, call_ms=c_ms,
                                   plain_ms=p_ms, bound_ms=1e3 * max(by_bytes, by_ops)))
        positions += U
    for key in ("ms", "call_ms", "plain_ms", "bytes_s", "ops_s", "bound_ms"):
        rec[key] /= positions
    rec["bound_by"] = "operations" if rec["ops_s"] >= rec["bytes_s"] else "bytes"

    # a CascadeLDA level-2 batch: (doc, two-char code) rows, its level topics
    cm = CascadeLDA(jel.train_docs, jel.train_labs, jel.labelset, jel_dicti,
                    seed=seed, device=DEVICE)
    row_doc, mask, _, _, _ = cm._level_rows(cm.lablist_l2)
    tok_v = torch.as_tensor(cm.tok_v[row_doc], device=DEVICE).long()
    tok_f = torch.as_tensor(cm.tok_f[row_doc], device=DEVICE).long()
    labs = torch.as_tensor(mask, device=DEVICE)
    c = init_counts(tok_v, tok_f, labs, cm.V, generator=gen)
    level = (tok_v.T.contiguous(), tok_f.T.float().contiguous(), c.z.T.contiguous(),
             c.n_dk, c.n_vk, c.n_k, labs, 0)
    cvbeta = float(cm.V * cm.beta)
    args = draw_inputs(*level, cvbeta, gen)
    commit, draw = sweep_inputs(*level, gen)
    rec["max_abs_err"] = max(rec["max_abs_err"], _compare_draw(args, a, b, "cascade level 2"),
                             _compare_sweep_steps(commit, draw, a, b, cvbeta,
                                                  "cascade level 2"))
    scratch = [t.clone() for t in draw]
    k_ms = _graph_ms(lambda: duc.draw_rows(*scratch, a, b, cvbeta), 20)
    by_bytes, by_ops = draw_bound(args)
    rec["cascade_level2"] = dict(R=int(mask.shape[0]), K=int(mask.shape[1]), ms=k_ms,
                                 bound_ms=1e3 * max(by_bytes, by_ops))
    print(f"cascade level 2: R={mask.shape[0]} K={mask.shape[1]}  kernel {k_ms:.4f} ms  "
          f"bound {1e3 * max(by_bytes, by_ops):.5f} ms  bitwise equal")

    args = ragged_draw_case(DEVICE, seed)
    rec["max_abs_err"] = max(rec["max_abs_err"], _compare_draw(args, a, b, "ragged case"))
    print("ragged case (D=37, K=40, a third f=0, one all-zero label row): bitwise equal")

    # one whole exact sweep of bucket 0: the card (kernel, index_add_, gather)
    # against the CPU (plain version), the same uniforms
    tv, tf, lb = model.toks_v[0], model.toks_f[0], model.labs_t[0]
    u = torch.rand(tuple(tv.T.shape), generator=gen, device=DEVICE)
    one = LDACounts(st.z[0], st.n_dk[0], st.n_vk, st.n_k)
    on_card = train_sweep(one, tv, tf, lb, a, b, uniforms=u)
    on_cpu = train_sweep(LDACounts(*(t.cpu() for t in one)), tv.cpu(), tf.cpu(),
                         lb.cpu(), a, b, uniforms=u.cpu())
    _check(_bitwise([x.cpu() for x in on_card], on_cpu),
           "exact sweep on the card == the same sweep on the CPU")
    _check(torch.equal(on_card.n_k, on_card.n_vk.sum(dim=0)), "sweep: n_k == n_vk.sum(0)")
    print("exact sweep, bucket 0: card == CPU (z, n_dk, n_vk, n_k)")
    # whole sweeps over all buckets: the count invariants after every sweep
    state = model.counts
    for i in range(5):
        state = train_sweep_buckets(state, model.toks_v, model.toks_f, model.labs_t, a, b,
                                    generator=gen)
        _check_counts(state, float(model.n_tokens), f"dense sweep {i + 1}")
    print("5 dense sweeps over all buckets: count invariants hold after each")
    print(f"per launch, averaged over the first and last positions of the dense path's "
          f"buckets ({positions} positions): kernel {rec['ms']:.4f} ms on the card "
          f"({rec['call_ms']:.4f} ms per call), plain {rec['plain_ms']:.3f} ms, bound "
          f"{rec['bound_ms']:.5f} ms ({rec['bound_by']})")

    # every position of one replayed sweep over all buckets
    sweep = graphed_sweep_profile(model, seed + 3)
    rec.update(ms_all_positions=sweep["ms"], bound_ms_all_positions=sweep["bound_ms"],
               commit_ms=sweep["commit_ms"], commit_bound_ms=sweep["commit_bound_ms"],
               draws_per_sweep=sweep["draws"], commits_per_sweep=sweep["commits"])
    print(f"one replayed sweep ({sweep['draws']} draw and {sweep['commits']} commit "
          f"launches; {sweep['records'][0]} and {sweep['records'][1]} records in the best "
          f"padded profiler session): draw kernel {sweep['ms']:.5f} ms per launch (bound "
          f"{sweep['bound_ms']:.5f} ms), commit kernel {sweep['commit_ms']:.5f} ms per "
          f"launch (bound {sweep['commit_bound_ms']:.5f} ms)")
    return rec


def exact_path(corpus, dicti, seed: int, sweep: str, iters: int, thinning: int) -> dict:
    """The exact Labeled-LDA path ``sweep`` at (iters; thinning): init,
    training, fold-in test of the held-out split, with the kernel counters
    set to 0 just before and read just after."""
    import torch

    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    fbc.launches = duc.launches = duc.commit_launches = 0
    t0 = time.perf_counter()
    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                       dicti, alpha=0.1, beta=0.01, seed=seed, sweep=sweep,
                       device=DEVICE)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    model.run_training(iters, thinning)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    th = model.run_test(corpus.test_docs, TRAIN_ITERS, THINNING)
    torch.cuda.synchronize()
    t3 = time.perf_counter()
    launches = dict(draw_update=duc.launches, count_commit=duc.commit_launches,
                    fused_block=fbc.launches)

    positions = sum(int(tv.shape[0]) for tv in model._toks_v_t)
    plan = [planned_sweep_launches(tf) for tf in model._toks_f_t]
    planned = dict(draw_update=iters * sum(p[0] for p in plan),
                   count_commit=iters * sum(p[1] for p in plan), fused_block=0)
    if sweep != "dense":
        planned.update(draw_update=0, count_commit=0)
    _check(launches == planned, f"{sweep}: kernel launches {launches}, planned {planned}")
    _check_counts(model.counts, float(model.n_tokens), sweep)
    _check(th.shape == (len(corpus.test_docs), model.K) and bool(np.isfinite(th).all()),
           f"{sweep}: fold-in θ finite, (n_test, K)")
    metrics = _auc(th, corpus.test_labs, model.labelmap)
    _check(metrics["auc_roc"] > MIN_AUC, f"{sweep}: AUC {metrics['auc_roc']} > {MIN_AUC}")
    tokens_per_s = model.n_tokens * iters / (t2 - t1)
    print(f"{sweep} path: D={model.D} V={model.V} K={model.K} Kp={model.Kp} "
          f"A={model.A} buckets={[tuple(z.shape) for z in model.counts.z]} "
          f"positions/sweep={positions}")
    print(f"  init {t1 - t0:.3f} s, train ({iters}; {thinning}) {t2 - t1:.3f} s "
          f"({tokens_per_s:.1f} tokens/s with perplexity), fold-in test "
          f"{t3 - t2:.3f} s")
    print(f"  kernel launches {launches}; perplexity {model.cur_perplx}; "
          f"test metrics {json.dumps(metrics)}")
    return dict(model=model, launches=launches["draw_update"],
                commit_launches=launches["count_commit"], positions=positions,
                tokens_per_s=tokens_per_s, metrics=metrics)


def graph_check(model, seed: int) -> dict:
    """Three sweeps over all buckets from replayed CUDA graphs (``ExactSweep``)
    against the same three sweeps launched eagerly (``exact_sweep``), from
    one seed: bitwise equal, with the count invariants after every sweep;
    then the device time per position of replayed sweeps (CUDA events
    around 5 sweeps over all buckets, uniforms drawn into the static buffers
    included)."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import exact_sweep

    runs, graphed = bucket_runners(model)
    eager = dense_state_copy(model)
    gens = []
    for _ in range(2):
        gens.append(torch.Generator(device=DEVICE))
        gens[-1].manual_seed(seed)
    vbeta = float(model.V * model.beta)
    for i in range(3):
        for g, run in enumerate(runs):
            run(gens[0])
            tv, tf = model._toks_v_t[g], model._toks_f_t[g]
            u = torch.rand(tuple(tv.shape), generator=gens[1], device=DEVICE)
            exact_sweep(eager.z[g], eager.n_dk[g], eager.n_vk, eager.n_k, tv, tf,
                        model.labs_t[g], model.alpha, model.beta, vbeta, u)
        for name, st in (("graphed", graphed), ("eager", eager)):
            _check_counts(st, float(model.n_tokens), f"{name} sweep {i + 1}")
    _check(all(run._graph is not None for run in runs), "the runners replay a captured graph")
    gen = gens[0]
    flat = [t for st in (graphed, eager) for t in (*st.z, *st.n_dk, st.n_vk, st.n_k)]
    half = len(flat) // 2
    _check(_bitwise(flat[:half], flat[half:]), "3 graphed sweeps == 3 eager sweeps, bitwise")
    reps = 5
    positions = sum(int(tv.shape[0]) for tv in model._toks_v_t)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for run in runs:
            run(gen)
    end.record()
    torch.cuda.synchronize()
    sweep_ms = start.elapsed_time(end) / reps
    print(f"3 dense sweeps over all buckets, graphed == eager bitwise (z, n_dk, n_vk, n_k); "
          f"count invariants hold after each; a replayed sweep takes {sweep_ms:.4f} ms, "
          f"{sweep_ms / positions:.6f} ms per position ({positions} positions)")
    return dict(sweep_ms=sweep_ms, step_ms_per_position=sweep_ms / positions)


def dense_profile(model) -> dict:
    """One (25; 25) call of the dense path, perplexity off, under
    torch.profiler (wall, busy time, idle share, top kernels); its draw and
    commit records, from the best of up to three more such calls in padded
    sessions (``_most_records``), must reach the counted launches."""
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    def train():
        model.run_training(THINNING, THINNING, perplexity=False)

    d0, c0 = duc.launches, duc.commit_launches
    prof = _profile(train)
    plan = [planned_sweep_launches(tf) for tf in model._toks_f_t]
    planned = (THINNING * sum(p[0] for p in plan), THINNING * sum(p[1] for p in plan))
    counted = (duc.launches - d0, duc.commit_launches - c0)
    _check(counted == planned, f"profiled call's launches {counted}, planned {planned}")
    rec = _most_records(train, sum(planned), names=(KERNEL2, COMMIT))
    recorded = (rec[KERNEL2][0], rec[COMMIT][0])
    _check(all(n - LOST_RECORDS <= r <= n for r, n in zip(recorded, planned)),
           f"the profiler's records {recorded} == launches {planned}")
    print(f"  launches (draw, commit): counted {counted}, recorded by the profiler "
          f"{recorded}")
    tokens_per_s = model.n_tokens * THINNING / (prof["wall_ms"] / 1e3)
    print(f"dense (25; 25) under the profiler, perplexity off: {prof['wall_ms']:.3f} ms "
          f"wall ({tokens_per_s:.1f} tokens/s), device busy {prof['busy_ms']:.3f} ms "
          f"(idle share {prof['idle_share']:.4f})")
    for name, count, ms in prof["top"]:
        print(f"  {ms:10.4f} ms  {count:6d} x  {name}")
    prof["tokens_per_s"] = tokens_per_s
    return prof


def cascade_path(jel, jel_dicti, seed: int) -> dict:
    """CascadeLDA at the thesis config on the JEL-shaped corpus, with the
    kernel counters set to 0 just before and read just after."""
    import torch

    from lda_thesis_tpu_torch.eval.cascade import setup_theta
    from lda_thesis_tpu_torch.eval.metrics import binary_yreal, evaluate_ranking
    from lda_thesis_tpu_torch.models.cascade_lda import CascadeLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    fbc.launches = duc.launches = duc.commit_launches = 0
    t0 = time.perf_counter()
    model = CascadeLDA(jel.train_docs, jel.train_labs, jel.labelset, jel_dicti,
                       alpha=0.001, beta=0.001, seed=seed, device=DEVICE)
    model.go_down_tree(it=CASCADE_IT, s=CASCADE_S)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    l1, l2, l3 = model.test_down_tree_batch(jel.test_docs, CASCADE_IT, CASCADE_S)
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    launches = dict(draw_update=duc.launches, count_commit=duc.commit_launches,
                    fused_block=fbc.launches)

    _check(len(model.level_stats) == 3, "cascade: three levels trained")
    level_f = [model.tok_f] + [model.tok_f[model._level_rows(parents)[0]]
                               for parents in (model.lablist_l1, model.lablist_l2)]
    per_sweep = [planned_sweep_launches(torch.from_numpy(tf.T)) for tf in level_f]
    planned = dict(draw_update=sum(st["sweeps"] * p[0]
                                   for st, p in zip(model.level_stats, per_sweep)),
                   count_commit=sum(st["sweeps"] * p[1]
                                    for st, p in zip(model.level_stats, per_sweep)),
                   fused_block=0)
    _check(launches == planned, f"cascade: kernel launches {launches}, planned {planned}")
    _check(bool(np.isfinite(model.ph).all()) and float(model.ph.min()) >= 0,
           "cascade: φ finite and non-negative")
    th_all = setup_theta(l1, l2, l3, model.labelmap)
    y_all = binary_yreal(jel.test_labs, model.labelmap)
    aucs = []
    for depth in (1, 2, 3):
        cols = np.array([len(x) == depth for x in model.labelmap])
        y, th = y_all[:, cols], th_all[:, cols]
        valid = (th.sum(axis=1) != 0) & (y.sum(axis=1) != 0)
        aucs.append(evaluate_ranking(th[valid], y[valid])["auc_roc"])
    _check(aucs[0] > MIN_AUC, f"cascade: depth-1 AUC {aucs[0]} > {MIN_AUC}")
    _check(all(np.isfinite(aucs)), f"cascade: finite AUCs {aucs}")
    print(f"cascade: D={model.D} V={model.V} K={model.K}; go_down_tree({CASCADE_IT}, "
          f"{CASCADE_S}) {t1 - t0:.3f} s, test_down_tree_batch of "
          f"{len(jel.test_docs)} docs {t2 - t1:.3f} s")
    for name, st, p in zip(("root", "level 1", "level 2"), model.level_stats, per_sweep):
        print(f"  {name}: R={st['rows']} U={st['positions']} K={st['topics']} "
              f"sweeps={st['sweeps']} launches: draw {st['sweeps'] * p[0]}, commit "
              f"{st['sweeps'] * p[1]} ({st['seconds']:.3f} s)")
    print(f"  macro AUC by depth {aucs}")
    return dict(launches=launches["draw_update"], commit_launches=launches["count_commit"],
                aucs=aucs, levels=model.level_stats, train_s=t1 - t0, test_s=t2 - t1,
                model=model)


# ---------------------------------------------------------- product surface


class _Tee(io.StringIO):
    """Keeps what is written and passes it on to ``out``."""

    def __init__(self, out):
        super().__init__()
        self.out = out

    def write(self, s):
        self.out.write(s)
        return super().write(s)


def _cli(main, argv) -> tuple:
    """Run a CLI's ``main`` in this process: (its result, what it printed)."""
    tee = _Tee(sys.stdout)
    with contextlib.redirect_stdout(tee):
        res = main(argv)
    return res, tee.getvalue()


def _cli_module(argv, cli: str = "evaluate_labeled_lda") -> list:
    """The command that runs a CLI (the Labeled-LDA one unless ``cli`` names
    another) with ``argv`` in a fresh process."""
    return [sys.executable, "-m", f"lda_thesis_tpu_torch.cli.{cli}", *argv]


def _steps(res) -> dict:
    """The Labeled-LDA CLI's wall seconds by step."""
    return {k[:-2]: res["stats"][k]
            for k in ("load_s", "prune_s", "model_s", "train_s", "test_s", "metrics_s")}


def _print_cli(name: str, res) -> None:
    m = res["model"]
    steps = ", ".join(f"{k} {v:.3f} s" for k, v in _steps(res).items())
    print(f"CLI {name}: D={m.D} V={m.V} K={m.K} Kp={m.Kp} A={m.A} "
          f"buckets={[tuple(z.shape) for z in m.counts.z]}; preprocessing: {res['pipeline']}")
    print(f"  wall by step: {steps}; training {res['tokens_per_s']:.1f} tokens/s "
          f"({res['stats']['train_iters']} sweeps); test metrics {json.dumps(res['metrics'])}")


def _kill_after_first_checkpoint(argv, path: str, log: str,
                                 cli: str = "evaluate_labeled_lda") -> tuple:
    """Start a CLI (the Labeled-LDA one unless ``cli`` names another) with
    ``argv`` in a fresh process and SIGKILL it once ``path.json`` records a
    checkpoint; returns (the iterations that checkpoint records, the
    process's return code).  Fails if the process ends first."""
    with open(log, "w") as out:
        proc = subprocess.Popen(_cli_module(argv, cli), cwd=ROOT, stdout=out,
                                stderr=subprocess.STDOUT)
        try:
            deadline = time.monotonic() + 600
            while time.monotonic() < deadline and proc.poll() is None:
                try:
                    with open(path + ".json") as f:
                        done = json.load(f)["iters_done"]
                except FileNotFoundError:
                    time.sleep(0.002)
                    continue
                os.kill(proc.pid, signal.SIGKILL)
                return done, proc.wait()
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    with open(log) as f:
        tail = f.read()[-2000:]
    raise RuntimeError(f"check failed: the CLI run to kill ended (rc {proc.returncode}) "
                       f"or timed out before its first checkpoint:\n{tail}")


def _trace_kernels(path, name: str) -> int:
    """Device-kernel records in a Chrome trace whose name holds ``name``."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sum(1 for e in events if e.get("cat") == "kernel" and name in e.get("name", ""))


def _same_arrays(a: dict, b: dict) -> bool:
    return sorted(a) == sorted(b) and all(
        a[k].dtype == b[k].dtype and a[k].shape == b[k].shape and np.array_equal(a[k], b[k])
        for k in a)


def product_phase(seed: int) -> dict:
    """The CLIs and ``entry()`` as a user runs them, on CSV files of the two
    synthetic corpora; the kernel counters are set to 0 just before each run
    and read just after."""
    import pickle

    import torch

    from lda_thesis_tpu_torch.cli import evaluate_cascade_lda, evaluate_labeled_lda
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus, planted_corpus
    from lda_thesis_tpu_torch.entry import entry
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, save_model

    lda = evaluate_labeled_lda.main
    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path, jel_path = os.path.join(tmp, "planted.csv"), os.path.join(tmp, "jel.csv")
        write_corpus_csv(csv_path, planted_corpus(seed))
        write_corpus_csv(jel_path, jel_corpus(seed))
        flags = ["-f", csv_path, "-d", "3", "-i", str(CLI_ITERS), "-s", str(CLI_THINNING),
                 "--seed", str(seed)]

        # the CLI's defaults: fused, perplexity on
        fbc.launches = duc.launches = duc.commit_launches = 0
        res, _ = _cli(lda, flags)
        launches = (fbc.launches, duc.launches, duc.commit_launches)
        m = res["model"]
        _check(m._merge_M == 25 and launches == (32, 0, 0),
               f"CLI fused: M == 25 and 32 kernel-1 launches, no other (M={m._merge_M}, "
               f"launches {launches})")
        _check_counts(m.counts, float(m.n_tokens), "CLI fused")
        _check(res["metrics"]["auc_roc"] > MIN_AUC,
               f"CLI fused: AUC {res['metrics']['auc_roc']} > {MIN_AUC}")
        _print_cli("fused (the defaults)", res)
        print(f"  kernel-1 launches {launches[0]} (M = {m._merge_M})")
        rec["fused"] = dict(launches=launches[0], tokens_per_s=res["tokens_per_s"],
                            wall_s=_steps(res), auc_roc=res["metrics"]["auc_roc"],
                            pipeline=res["pipeline"])
        del res, m

        # --sweep dense, and -p: the pickled model loads back on the card
        fbc.launches = duc.launches = duc.commit_launches = 0
        cwd = os.getcwd()
        os.chdir(tmp)
        try:
            res, _ = _cli(lda, flags + ["--sweep", "dense", "-p"])
        finally:
            os.chdir(cwd)
        launches = (duc.launches, duc.commit_launches, fbc.launches)
        m = res["model"]
        plan = [planned_sweep_launches(tf) for tf in m._toks_f_t]
        planned = (CLI_ITERS * sum(p[0] for p in plan), CLI_ITERS * sum(p[1] for p in plan), 0)
        _check(launches == planned,
               f"CLI dense: (draw, commit, kernel-1) launches {launches}, planned {planned}")
        _check_counts(m.counts, float(m.n_tokens), "CLI dense")
        _check(res["metrics"]["auc_roc"] > MIN_AUC,
               f"CLI dense: AUC {res['metrics']['auc_roc']} > {MIN_AUC}")
        with open(os.path.join(tmp, "LabeledLDA_model.pkl"), "rb") as f:
            back = pickle.load(f)
        _check(back.device.type == back.counts.n_vk.device.type == back._gen.device.type
               == DEVICE
               and torch.equal(back._gen.get_state(), m._gen.get_state())
               and torch.equal(back.counts.n_vk, m.counts.n_vk)
               and torch.equal(back.ph_hat, m.ph_hat),
               "CLI dense -p: the pickled model loads back on the card, generator included")
        _print_cli("--sweep dense -p", res)
        print(f"  launches (draw, commit) {launches[:2]}, planned {planned[:2]}; "
              f"the pickled model loads back on the card")
        rec["dense"] = dict(launches=launches[0], commit_launches=launches[1],
                            tokens_per_s=res["tokens_per_s"], wall_s=_steps(res),
                            auc_roc=res["metrics"]["auc_roc"])
        del res, m, back

        # kill and resume: A uninterrupted, B killed after its first
        # checkpoint and resumed in a fresh process
        ck_a, ck_b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        every = ["--save-every", str(CLI_THINNING)]
        fbc.launches = 0
        res, text = _cli(lda, flags + ["--checkpoint", ck_a] + every)
        _check(fbc.launches == 32, f"CLI checkpointed run: 32 kernel-1 launches ({fbc.launches})")
        want = METRIC_LINES.findall(text)
        writes = []
        for _ in range(3):
            t0 = time.perf_counter()
            save_model(os.path.join(tmp, "W"), res["model"], extra_meta={"iters_done": CLI_ITERS})
            writes.append(1e3 * (time.perf_counter() - t0))
        npz_mb = os.path.getsize(os.path.join(tmp, "W.npz")) / 1e6
        table_mb = res["model"].counts.n_vk.numel() * 4 / 1e6
        del res
        done, rc = _kill_after_first_checkpoint(flags + ["--checkpoint", ck_b] + every, ck_b,
                                                os.path.join(tmp, "B.log"))
        _check(done == CLI_THINNING and rc == -signal.SIGKILL,
               f"the CLI run was killed by SIGKILL at its first checkpoint (iteration "
               f"{done}, rc {rc})")
        t0 = time.perf_counter()
        resumed = subprocess.run(_cli_module(flags + ["--checkpoint", ck_b, "--resume"] + every),
                                 cwd=ROOT, capture_output=True, text=True, timeout=900)
        resume_s = time.perf_counter() - t0
        _check(resumed.returncode == 0,
               f"the resumed CLI run succeeded: {resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
        _check(f"resumed from {ck_b} at iteration {CLI_THINNING}" in resumed.stdout,
               "the fresh process resumed from the checkpoint of iteration 25")
        got = METRIC_LINES.findall(resumed.stdout)
        _check(len(want) == 4 and got == want,
               f"the resumed run prints the uninterrupted run's metric lines: {got} != {want}")
        (a, _), (b, meta_b) = load_checkpoint(ck_a), load_checkpoint(ck_b)
        _check(meta_b["iters_done"] == CLI_ITERS and _same_arrays(a, b),
               "A.npz and B.npz are equal array for array, bitwise")
        print(f"kill and resume: B killed by SIGKILL at its checkpoint of iteration {done}, "
              f"resumed in a fresh process ({resume_s:.3f} s); all {len(a)} arrays of A.npz "
              f"and B.npz bitwise equal ({', '.join(sorted(a))}); the four metric lines equal")
        print(f"checkpoint write: {[round(w, 3) for w in writes]} ms ({npz_mb:.1f} MB npz; "
              f"n_vk and ph_hat {table_mb:.1f} MB each)")
        rec["checkpoint"] = dict(write_ms=float(np.median(writes)), writes_ms=writes,
                                 npz_mb=npz_mb, arrays=len(a), killed_at=done,
                                 resumed_run_s=resume_s)

        # --progress and --trace
        trace_dir = os.path.join(tmp, "trace")
        fbc.launches = 0
        _, text = _cli(lda, ["-f", csv_path, "-d", "3", "-i", "16", "-s", "8", "--seed",
                             str(seed), "--checkpoint", os.path.join(tmp, "C"),
                             "--save-every", "8", "--progress", "--trace", trace_dir])
        counted = fbc.launches
        lines = [x for x in text.splitlines() if "tokens/s" in x and x.startswith("[")]
        files = list(Path(trace_dir).glob("*.pt.trace.json"))
        _check(bool(lines) and len(files) == 1, "--progress prints tokens/s, --trace a trace file")
        recorded = _trace_kernels(files[0], KERNEL1)
        _check(recorded > 0, f"the trace holds kernel-1 records ({recorded} of {counted})")
        print(f"--progress: {lines[-1]!r}; --trace: {files[0].name}, "
              f"{os.path.getsize(files[0]) / 1e6:.1f} MB, {recorded} kernel-1 records of "
              f"{counted} launches")
        rec["trace"] = dict(kernel1_records=recorded, kernel1_launches=counted)

        # the CascadeLDA CLI at the thesis config
        fbc.launches = duc.launches = duc.commit_launches = 0
        t0 = time.perf_counter()
        res, _ = _cli(evaluate_cascade_lda.main,
                      ["-f", jel_path, "-d", "3", "-i", str(CASCADE_IT), "-s", str(CASCADE_S),
                       "--seed", str(seed)])
        cascade_s = time.perf_counter() - t0
        aucs = [x["auc_roc"] for x in res["metrics"]]
        _check(duc.launches > 0 and duc.commit_launches > 0 and fbc.launches == 0,
               "the CascadeLDA CLI trains through kernel 2")
        _check(len(aucs) == 3 and aucs[0] > MIN_AUC,
               f"CascadeLDA CLI: depth-1 AUC {aucs[0]} > {MIN_AUC}")
        print(f"CLI CascadeLDA ({CASCADE_IT}; {CASCADE_S}): {cascade_s:.3f} s, macro AUC by "
              f"depth {aucs}, launches (draw, commit) ({duc.launches}, {duc.commit_launches})")
        rec["cascade"] = dict(aucs=aucs, seconds=cascade_s, launches=duc.launches)
        del res

    # entry(): one fused merge block of the toy problem
    fbc.launches = 0
    fn, args = entry()
    st = fn(*args)
    torch.cuda.synchronize()
    _check(fbc.launches == 1 and float(st.n_vk.sum()) == float(args[2].sum()),
           f"entry(): one kernel-1 launch ({fbc.launches}), sum n_vk == sum f")
    print(f"entry(): one merge block (M = 2), {fbc.launches} kernel-1 launch, "
          f"sum n_vk == sum f == {float(args[2].sum())}")
    return rec


LOCAL_V = 11_889  # the abstracts' vocabulary in LocalLDA's lemma mode
LOCAL_ITERS, LOCAL_THINNING = 100, 10  # the JAX package's LocalLDA record
LOCAL_SHORT = 20  # sweeps of the dense and K = 50 runs


def _local_steps(res) -> dict:
    return {k[:-2]: v for k, v in res["stats"].items()}


def _local_card_equals_cpu(m, seed: int, what: str) -> None:
    """One merge block (fused) or one exact sweep (dense) of every bucket of
    ``m`` from its trained state, on the card (the kernels at the shapes
    this path gives them) and on the CPU (their plain versions), from the
    same uniforms, held bit for bit."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import ExactSweep
    from lda_thesis_tpu_torch.ops.gibbs_fused import fused_train_block_buckets

    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed)
    us = [torch.rand(tuple(tv.shape), generator=gen, device=DEVICE) for tv in m._toks_v_t]
    ends = []
    for dev in (DEVICE, "cpu"):
        st = type(m.counts)(*(tuple(t.to(dev, copy=True) for t in part)
                              if isinstance(part, tuple) else part.to(dev, copy=True)
                              for part in m.counts))
        tv, tf = [t.to(dev) for t in m._toks_v_t], [t.to(dev) for t in m._toks_f_t]
        if m.sweep == "fused":
            st = fused_train_block_buckets(
                st, tv, tf, [t.to(dev) for t in m.lab_ids_t],
                [t.to(dev) for t in m._lab_valid_tt], m.a, m.b, 1,
                uniforms=[u[None].to(dev) for u in us])
            state = [*st.z, *st.n_dk, st.n_vk, st.n_k]
        else:
            z_t = [z.T.clone(memory_format=torch.contiguous_format) for z in st.z]
            for g, u in enumerate(us):
                ExactSweep(z_t[g], st.n_dk[g], st.n_vk, st.n_k, tv[g], tf[g],
                           m.labs_t[g].to(dev), m.a, m.b, m.V * m.b)(uniforms=u.to(dev))
            state = [*z_t, *st.n_dk, st.n_vk, st.n_k]
        ends.append([t.cpu() for t in state])
    _check(_bitwise(*ends), f"{what}: one {'merge block' if m.sweep == 'fused' else 'sweep'} "
                            f"on the card == the same on the CPU")
    print(f"{what}: one {'merge block' if m.sweep == 'fused' else 'exact sweep'} of the "
          f"trained state on the card == the same on the CPU (z, n_dk, n_vk, n_k)")


def local_lda_phase(seed: int) -> dict:
    """LocalLDA as a user runs it: its CLI on a CSV of the planted corpus at
    the abstracts' vocabulary (each abstract one sentence document, one
    bucket of U = 128), at its defaults (K = 20, fused, M = 1), with
    ``--sweep dense``, with ``-k 50`` (the warp route) and with ``-k 300``
    (the wide route, and a replayed block's device time by step); the
    kernel counters are set to 0 just before each run and read just after.
    After each run, one block of its trained state on the card against the
    CPU; and a save/restore round trip of the LocalLDA checkpoint."""
    import torch

    from lda_thesis_tpu_torch.cli import evaluate_local_lda
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.utils.checkpoint import restore_model, save_model

    def counters_zero():
        _set_route_counts(fbc, (0, 0, 0, 0))
        duc.launches = duc.commit_launches = 0

    def check_model(m, what):
        _check_counts(m.counts, float(m.n_tokens), what)
        perp = m.perplexity()
        _check(np.isfinite(perp) and 1.0 < perp < m.V,
               f"{what}: perplexity {perp} below V = {m.V}, the uniform model's")
        return perp

    rec = {}
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "local.csv")
        write_corpus_csv(csv_path, planted_corpus(seed, V=LOCAL_V))
        flags = ["-f", csv_path, "--seed", str(seed)]

        counters_zero()
        res, _ = _cli(evaluate_local_lda.main,
                      flags + ["-i", str(LOCAL_ITERS), "-s", str(LOCAL_THINNING)])
        m = res["model"]
        n_buckets = m.buckets.n_buckets
        launches = (*_route_counts(fbc), duc.launches, duc.commit_launches)
        _check(m.K == 20 and m.A == 24 and m._merge_M == 1 and n_buckets == 1,
               f"LocalLDA CLI defaults: K 20, A 24, M 1, one bucket ({m.K}, {m.A}, "
               f"{m._merge_M}, {n_buckets})")
        _check(launches == (LOCAL_ITERS, 0, 0, 0, 0, 0)
               and res["launches"]["fused_block"] == LOCAL_ITERS,
               f"LocalLDA CLI: {LOCAL_ITERS} kernel-1 launches on the staged route, no "
               f"other (kernel 1, warp, wide, general, draw, commit: {launches})")
        perp = check_model(m, "LocalLDA CLI fused")
        _check(perp == res["perplexity"], "LocalLDA CLI: its perplexity")
        shape = (m.D, m.V, tuple(m.counts.z[0].shape))
        print(f"LocalLDA CLI, defaults (K = 20, ({LOCAL_ITERS}; {LOCAL_THINNING}), fused, "
              f"M = 1): D={m.D} V={m.V} A={m.A} z {shape[2]}; {launches[0]} kernel-1 launches; "
              f"perplexity {perp:.2f}; wall by step "
              f"{json.dumps({k: round(v, 4) for k, v in _local_steps(res).items()})}; "
              f"{res['tokens_per_s']:.1f} tokens/s")
        rec["fused"] = dict(launches=launches[0], perplexity=perp, wall_s=_local_steps(res),
                            tokens_per_s=res["tokens_per_s"], D=m.D, V=m.V)
        _local_card_equals_cpu(m, seed + 2, "LocalLDA K = 20 (staged route)")

        # the checkpoint round trip: a model restored from a save of the
        # trained one takes the same next call, bit for bit
        ck = os.path.join(tmp, "ck")
        t0 = time.perf_counter()
        save_model(ck, m, extra_meta={"iters_done": LOCAL_ITERS})
        write_ms = 1e3 * (time.perf_counter() - t0)
        back = LocalLDA(evaluate_local_lda._read_texts(csv_path), alpha=m.a, beta=m.b,
                        K=m.K, seed=seed + 1, device=DEVICE)
        restore_model(ck, back)
        m.run_training(LOCAL_THINNING, LOCAL_THINNING, total_iters=LOCAL_ITERS)
        back.run_training(LOCAL_THINNING, LOCAL_THINNING, total_iters=LOCAL_ITERS)
        same = (all(torch.equal(x, y) for x, y in zip(m.counts.z, back.counts.z))
                and _bitwise(list(m.counts.n_dk) + [m.counts.n_vk, m.counts.n_k],
                             list(back.counts.n_dk) + [back.counts.n_vk, back.counts.n_k])
                and torch.equal(m._gen.get_state(), back._gen.get_state())
                and np.array_equal(m.ph_hat, back.ph_hat)
                and np.array_equal(m.th_hat, back.th_hat))
        _check(same, "LocalLDA checkpoint: the restored model's next call equals the "
                     "uninterrupted model's")
        print(f"LocalLDA checkpoint: write {write_ms:.1f} ms; restored into a fresh model, "
              f"its next ({LOCAL_THINNING}; {LOCAL_THINNING}) call equals the "
              f"uninterrupted model's (z, n_dk, n_vk, n_k, generator, means)")
        rec["checkpoint_write_ms"] = write_ms
        del m, back, res

        short = ["-i", str(LOCAL_SHORT), "-s", str(LOCAL_THINNING)]
        counters_zero()
        res, _ = _cli(evaluate_local_lda.main, flags + short + ["--sweep", "dense"])
        m = res["model"]
        plan = [planned_sweep_launches(tf) for tf in m._toks_f_t]
        planned = (LOCAL_SHORT * sum(p[0] for p in plan), LOCAL_SHORT * sum(p[1] for p in plan))
        launches = (duc.launches, duc.commit_launches, fbc.launches)
        _check(launches == planned + (0,),
               f"LocalLDA CLI dense: (draw, commit, kernel-1) launches {launches}, "
               f"planned {planned}")
        perp_dense = check_model(m, "LocalLDA CLI dense")
        print(f"LocalLDA CLI --sweep dense ({LOCAL_SHORT}; {LOCAL_THINNING}): launches (draw, "
              f"commit) {launches[:2]} as planned; perplexity {perp_dense:.2f} (fused at "
              f"({LOCAL_ITERS}; {LOCAL_THINNING}): {perp:.2f}); wall by step "
              f"{json.dumps({k: round(v, 4) for k, v in _local_steps(res).items()})}")
        rec["dense"] = dict(launches=launches[0], commit_launches=launches[1],
                            perplexity=perp_dense, wall_s=_local_steps(res))
        _local_card_equals_cpu(m, seed + 3, "LocalLDA --sweep dense")
        del m, res

        counters_zero()
        res, _ = _cli(evaluate_local_lda.main, flags + short + ["-k", "50"])
        m = res["model"]
        launches = _route_counts(fbc)
        _check(m.A == 56 and launches == (LOCAL_SHORT, LOCAL_SHORT, 0, 0),
               f"LocalLDA CLI -k 50: A 56, every kernel-1 launch on the warp route "
               f"(A {m.A}; launches, warp, wide, general {launches})")
        perp50 = check_model(m, "LocalLDA CLI -k 50")
        print(f"LocalLDA CLI -k 50 ({LOCAL_SHORT}; {LOCAL_THINNING}): A = {m.A}, "
              f"{launches[1]} kernel-1 launches on the warp route; perplexity "
              f"{perp50:.2f}; wall by step "
              f"{json.dumps({k: round(v, 4) for k, v in _local_steps(res).items()})}")
        rec["k50"] = dict(launches=launches[1], perplexity=perp50, wall_s=_local_steps(res))
        _local_card_equals_cpu(m, seed + 4, "LocalLDA K = 50 (warp route)")
        del m, res

        counters_zero()
        res, _ = _cli(evaluate_local_lda.main, flags + short + ["-k", "300"])
        m = res["model"]
        blocks = LOCAL_SHORT * m.buckets.n_buckets
        launches = _route_counts(fbc)
        _check(m.A == 304 and launches == (blocks, 0, blocks, 0)
               and res["launches"]["fused_block"] == blocks,
               f"LocalLDA CLI -k 300: A 304, every kernel-1 launch on the wide route, "
               f"blocks x buckets = {blocks} (A {m.A}; launches, warp, wide, general "
               f"{launches})")
        perp300 = check_model(m, "LocalLDA CLI -k 300")
        print(f"LocalLDA CLI -k 300 ({LOCAL_SHORT}; {LOCAL_THINNING}): A = {m.A}, "
              f"{launches[2]} kernel-1 launches on the wide route; perplexity "
              f"{perp300:.2f}; wall by step "
              f"{json.dumps({k: round(v, 4) for k, v in _local_steps(res).items()})}")
        split = merge_block_split(m._fused, 1)
        rec["k300"] = dict(launches=launches[2], perplexity=perp300, wall_s=_local_steps(res),
                           tokens_per_s=res["tokens_per_s"], block_split=split)
        _local_card_equals_cpu(m, seed + 5, "LocalLDA K = 300 (wide route)")
    return rec


def vi_phase(seed: int) -> dict:
    """The Labeled-LDA CLI with ``--engine vi -i 20`` on phase 9's CSV: the
    ELBO must not fall (within tests/test_vi.py's float32 slack) and the
    held-out AUC must pass; the seconds per CAVI step at full width."""
    from lda_thesis_tpu_torch.cli import evaluate_labeled_lda
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus

    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "planted.csv")
        write_corpus_csv(csv_path, planted_corpus(seed))
        res, _ = _cli(evaluate_labeled_lda.main,
                      ["-f", csv_path, "-d", "3", "-i", str(VI_ITERS), "--seed", str(seed),
                       "--engine", "vi"])
    m = res["model"]
    e = np.asarray(m.elbo_history)
    _check(len(e) >= 2 and bool(np.all(np.diff(e) >= -1e-3 * np.abs(e[:-1]))),
           f"VI: the ELBO does not fall ({e.tolist()})")
    auc = res["metrics"]["auc_roc"]
    _check(auc > MIN_AUC, f"VI: held-out AUC {auc} > {MIN_AUC}")
    step_s = res["stats"]["train_s"] / len(e)
    print(f"CLI --engine vi (-i {VI_ITERS}): D={m.D} Kp={m.Kp} V={m.V}, {len(e)} CAVI "
          f"steps, {step_s:.4f} s per step, ELBO {e[0]:.6g} -> {e[-1]:.6g}, AUC {auc}; "
          f"wall by step {json.dumps({k: round(v, 4) for k, v in _steps(res).items()})}")
    return dict(cavi_step_s=step_s, steps=len(e), auc_roc=auc, elbo_first=float(e[0]),
                elbo_last=float(e[-1]), D=m.D, Kp=m.Kp, V=m.V, wall_s=_steps(res),
                svi=svi_epoch_case(m, seed))


def svi_epoch_case(m, seed: int) -> dict:
    """One ``fit_svi`` epoch (its defaults: batches of 2,048 documents,
    then one CAVI pass) of the CLI's VI model from a fresh start at full
    width: the ELBO must rise from the start's, within tests/test_vi.py's
    float32 slack."""
    import torch

    from lda_thesis_tpu_torch.ops.vi import elbo, vi_init

    m._gen = torch.Generator(device=m.device)
    m._gen.manual_seed(seed)
    m.state = vi_init(m.labs, m.V, m.alpha, m.beta, generator=m._gen)
    m.elbo_history = []
    e0 = float(elbo(m.state, m.tok_v, m.tok_f, m.labs, m.alpha, m.beta))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    m.fit_svi(epochs=1)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    e1 = m.elbo_history[-1]
    batches = max(m.D // min(2048, m.D), 1)
    _check(np.isfinite(e1) and e1 - e0 >= -1e-3 * abs(e0),
           f"SVI: one epoch does not lower the ELBO past the float32 slack ({e0} -> {e1})")
    print(f"fit_svi, one epoch of {batches} batches of 2048 documents and a CAVI pass at "
          f"full width (D={m.D} Kp={m.Kp} V={m.V}): ELBO {e0:.6g} -> {e1:.6g} (a rise of "
          f"{e1 - e0:.6g}), {secs:.4f} s")
    return dict(batches=batches, elbo_start=e0, elbo_after=e1, elbo_rise=e1 - e0, seconds=secs)


# ---------------------------------------------------------------- HSLDA

HSLDA_K, HSLDA_IT, HSLDA_S = 15, 25, 5  # the JAX package's real-corpus record
HSLDA_N_L3 = 371  # jel_corpus(seed, n_l3=371): 1 + 20 + 120 + 371 = 512 labels
HSLDA_SHORT_IT, HSLDA_SHORT_TEST_IT = 5, 25  # the --opt 2 and --opt 3 runs
HSLDA_SMALL_K = 8
# the z-sweep's coupling forms: (opt, compact positive labels)
HSLDA_FORMS = {"opt1": (1, False), "opt2-sparse": (2, True), "opt2-blockwise": (2, False),
               "opt3": (3, False)}
HSLDA_TOL = 1e-4  # η, a and β, card against the CPU
HSLDA_REPLAYED = (6, 3)  # (iters; thinning) of each call held to the eager loop (12b)


def hslda_small_problem(seed: int) -> tuple:
    """64 documents of 8–32 tokens over 120 words, labels from a two-letter
    tree of 11 codes (L = 12 with the root): (docs, labs, labelset)."""
    rng = np.random.default_rng(seed)
    labelset = ["A", "A1", "A11", "A12", "A2", "A21", "B", "B1", "B11", "B2", "B21"]
    leaves = [x for x in labelset if len(x) == 3]
    docs, labs = [], []
    for d in range(64):
        mine = list(rng.choice(len(leaves), size=1 + int(rng.random() < 0.3), replace=False))
        n = 32 if d == 0 else int(rng.integers(8, 33))
        own = rng.random(n) < 0.6
        words = np.where(own, 20 * np.array(mine)[rng.integers(0, len(mine), n)]
                         + rng.integers(0, 20, n), rng.integers(0, 120, n))
        docs.append([f"w{w}" for w in words])
        labs.append(list(dict.fromkeys(p for i in mine
                                       for p in (leaves[i][0], leaves[i][:2], leaves[i]))))
    return docs, labs, labelset


def _hslda_counts_ok(n_dk, n_vk, n_k, total: int, what: str) -> None:
    import torch

    _check(int(n_dk.sum()) == int(n_vk.sum()) == int(n_k.sum()) == total,
           f"{what}: sum n_dk == sum n_vk == sum n_k == sum mask ({total})")
    _check(int(n_dk.min()) >= 0 and int(n_vk.min()) >= 0 and int(n_k.min()) >= 0,
           f"{what}: no negative count")
    _check(torch.equal(n_vk.sum(dim=0, dtype=torch.int32), n_k), f"{what}: n_k == n_vk.sum(0)")


def hslda_cycle_case(device, seed: int, form: str) -> dict:
    """One HSLDA cycle (``_train_cycle``) of the small problem on ``device``
    and on the CPU, from one state and one set of draws (made on the CPU):
    {device type: (z, n_dk, n_vk, n_k, η, a, β)}, with the total count."""
    import torch

    from lda_thesis_tpu_torch.models.hslda import HSLDA, CycleNoise, _train_cycle
    from lda_thesis_tpu_torch.ops.sampling import gumbel

    opt, sparse = HSLDA_FORMS[form]
    docs, labs, labelset = hslda_small_problem(seed)
    m = HSLDA(docs, labs, labelset, k=HSLDA_SMALL_K, seed=seed, device="cpu")
    D, N = m.tok_v.shape
    K, L, S = m.K, m.L, m._stirling_logs.shape[0]
    g = torch.Generator().manual_seed(seed + 1)
    noise = dict(z=gumbel((N, D, K), "cpu", g), eta=torch.randn((K, L), generator=g),
                 a=torch.rand((D, L), generator=g) * float(np.float32(1.0) - np.float32(1e-7))
                 + float(np.float32(1e-7)),
                 m=gumbel((D, K, S), "cpu", g))

    def beta_draws(conc):
        return torch._standard_gamma(conc.cpu(), generator=torch.Generator().manual_seed(seed + 2))

    out = {}
    for dev in (torch.device(device), torch.device("cpu")):
        def on(x):
            return x.to(dev)

        res = _train_cycle(
            type(m.counts)(*(on(t) for t in m.counts)), on(m.tok_v), on(m.mask), on(m.labs),
            on(m.eta), on(m.a), on(m.beta), on(m._stirling_logs), m.mu, m.sigma, m.aprime,
            m.alpha, m.gamma, m.xi, opt,
            lab_pos_ids=on(m._lab_pos_ids) if sparse else None,
            lab_pos_valid=on(m._lab_pos_valid) if sparse else None,
            noise=CycleNoise(**{k: on(v) for k, v in noise.items()}, beta=beta_draws))
        counts, eta, a, beta = res[:4]
        out[dev.type] = [t.cpu() for t in (*counts, eta, a, beta)]
    out["total"] = int(m.mask.sum())
    return out


def eager_hslda_training(model, iters: int, thinning: int, opt: int = 1,
                         continue_avg: bool = False) -> dict:
    """``run_training`` of an ``HSLDA``, or of a one-rank ``DistributedHSLDA``
    on a mesh whose data axis is 1 with the replicated table, from the
    model's current state as eager calls of the functional blocks: per cycle
    ``hslda_z_sweep``, ``eta_draw`` of ``eta_gram``, ``a_block``,
    ``antoniak_draw`` and ``beta_block`` (``_train_cycle`` for one chain),
    drawing from copies of the model's generators; each save's estimates
    and ``running_average``.  The reference of the replayed HSLDA training
    loop; the model is left as it was.  Returns the state (z, n_dk, n_vk,
    n_k, η, a, β), the means, the save count and the generators' states."""
    import torch

    from lda_thesis_tpu_torch.models.hslda import (
        _train_cycle,
        a_block,
        antoniak_draw,
        beta_block,
        eta_draw,
        eta_gram,
    )
    from lda_thesis_tpu_torch.models.state import running_average
    from lda_thesis_tpu_torch.ops.hslda_gibbs import HSLDACounts, hslda_z_sweep
    from lda_thesis_tpu_torch.parallel.hslda_sharded import chain_ph

    f32 = torch.float32
    chains = hasattr(model, "_gens")
    if chains:
        st = model.state
        local = [_copy_generator(g) for g in model._gens.local]
        chain = [_copy_generator(g) for g in model._gens.chain]
        gens = local + chain
        counts = HSLDACounts(*(t.clone() for t in st[:4]))
        eta, a, beta = (t.clone() for t in st[4:])
        tok_v, mask, labs = model.corpus
        kept = model._ph_hat if continue_avg else None
        ph = (torch.zeros((counts.n_k.shape[0], model.K, model.V), dtype=f32,
                          device=model.device) if kept is None else kept.clone())
        means, s = [ph], model._n_saves if continue_avg else 0
    else:
        gens = [_copy_generator(model._gen)]
        counts = HSLDACounts(*(t.clone() for t in model.counts))
        eta, a, beta = model.eta.clone(), model.a.clone(), model.beta.clone()
        tok_v, mask, labs = model.tok_v, model.mask, model.labs
        s = model._avg_s if continue_avg and model.ph is not None else 0
        means = ([torch.as_tensor(x, device=model.device) for x in (model.ph, model.th)]
                 if s else [torch.zeros((model.K, model.V), dtype=f32, device=model.device),
                            torch.zeros((model.D, model.K), dtype=f32, device=model.device)])
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(f32)
    pos = (model._lab_pos_ids, model._lab_pos_valid) if opt == 2 and not chains \
        else (None, None)
    for i in range(int(iters)):
        if chains:
            counts, _ = hslda_z_sweep(counts, tok_v, mask, labs, eta, a, model.alpha * beta,
                                      model.gamma, model.xi, opt=opt, V=model.V,
                                      generator=local)
            zbar = counts.n_dk.to(f32) / n_d[:, None]
            eta = eta_draw(*eta_gram(zbar, a), model.mu, model.sigma, generator=chain)
            a, _ = a_block(zbar, eta, labs, generator=local)
            m = antoniak_draw(counts.n_dk, model.alpha, beta, model._stirling_logs,
                              generator=local)
            beta = beta_block(m.sum(dim=1).to(f32) / model.D, model.aprime, generator=chain)
        else:
            counts, eta, a, beta, _, _ = _train_cycle(
                counts, tok_v, mask, labs, eta, a, beta, model._stirling_logs, model.mu,
                model.sigma, model.aprime, model.alpha, model.gamma, model.xi, opt,
                lab_pos_ids=pos[0], lab_pos_valid=pos[1], generator=gens[0])
        if (i + 1) % int(thinning) == 0:
            s += 1
            if chains:
                means = [running_average(means[0], chain_ph(counts.n_vk, counts.n_k), s)]
            else:
                n_kv = counts.n_vk.to(f32).T
                cur = [n_kv / torch.clamp(n_kv.sum(dim=1, keepdim=True), min=1.0),
                       counts.n_dk.to(f32) / n_d[:, None]]
                means = [running_average(x, c, s) for x, c in zip(means, cur)]
    return dict(state=[*counts, eta, a, beta], means=means, s=s,
                generators=[g.get_state() for g in gens])


def hslda_training_equal(model, want: dict) -> bool:
    """Whether ``model`` after a ``run_training`` call holds ``want``
    (``eager_hslda_training`` from the state before it) bit for bit: z,
    n_dk, n_vk, n_k, η, a, β, the thinned means, the save count and the
    generators' states."""
    import torch

    if hasattr(model, "_gens"):
        got = [*model.state]
        means = [] if model._ph_hat is None else [model._ph_hat]
        s, gens = model._n_saves, model._gens.local + model._gens.chain
    else:
        got = [*model.counts, model.eta, model.a, model.beta]
        means = [] if model.ph is None else [torch.from_numpy(model.ph),
                                             torch.from_numpy(model.th)]
        s, gens = model._avg_s, [model._gen]
    want_means = want["means"] if want["s"] else []
    return (s == want["s"]
            and _bitwise([t.cpu() for t in got + means],
                         [t.cpu() for t in want["state"] + want_means])
            and all(torch.equal(g.get_state(), w) for g, w in zip(gens, want["generators"],
                                                                 strict=True)))


def hslda_replay_case(device, docs, labs, labelset, seed: int, opt: int, iters: int,
                      thinning: int, k: int, calls: int = 2) -> dict:
    """``calls`` HSLDA ``run_training(iters, thinning)`` calls of one model
    on ``device`` (the later ones with ``continue_avg``), each held to
    ``eager_hslda_training`` from the state before it; on a card the first
    call's first cycle and first save run eagerly, their second calls
    capture the graphs and the rest replay.  Returns the model, each call's
    (captures, eager bodies) added (``replay_counts``) and whether every
    call was equal."""
    from lda_thesis_tpu_torch.models.hslda import HSLDA

    m = HSLDA(docs, labs, labelset, k=k, seed=seed, device=device)
    added, same = [], []
    for n in range(calls):
        want = eager_hslda_training(m, iters, thinning, opt, continue_avg=n > 0)
        before = replay_counts(m)
        m.run_training(iters, thinning, opt=opt, continue_avg=n > 0)
        added.append([a - b for a, b in zip(replay_counts(m), before)])
        same.append(hslda_training_equal(m, want))
    return dict(model=m, added=added, equal=all(same))


def hslda_sweep_bound_ms(model, rows=None) -> tuple:
    """(bytes bound, operations bound) in ms of one opt-1 z-sweep: each live
    token instance reads its document's rows of M, a and labs and writes
    its row of M ((D, L) passes), and reads n_dk, its noise and its word's
    n_vk row and writes n_dk ((D, K) passes); its coupling matmul is
    2·L·K operations.  ``rows`` counts other (document, position) rows
    than the live instances (every row of every position: N·D)."""
    n, L, K = model.n_tokens if rows is None else rows, model.L, model.K
    return (n * (4 * L + 4 * K) * 4 / HBM_BYTES_PER_S * 1e3,
            n * 2 * L * K / FP32_FLOP_PER_S * 1e3)


def hslda_block_timing(model, cycles: int) -> dict:
    """Times of a fresh full-width model's opt-1 cycles through its cycle
    runner: host seconds of ``cycles`` cycles one by one, each ending in a
    synchronize (the first eager, the second captured, then replayed); the
    host ms to issue a replayed cycle (``_host_ms``: fills, a replay, β's
    draw) and its device ms (CUDA events around 5 cycles, and around 5
    replays of the graph alone); the cycle graph's nodes; the host ms to
    issue the same cycle eagerly (its body run outside the graph).  Then
    each block on copies of the state and noise: host seconds run eagerly
    (a synchronize around each, as the loop ran them before its cycle
    replayed) and device ms as a graph of its own (CUDA events around 5
    replays): the z-sweep, η, a and m (with mdot); the fills and β's draw,
    which stay outside the graph, by CUDA events around 5 calls."""
    import torch

    from lda_thesis_tpu_torch.models.hslda import a_block, antoniak_draw, beta_block, eta_block
    from lda_thesis_tpu_torch.ops.gibbs import capture_graph
    from lda_thesis_tpu_torch.ops.hslda_gibbs import _sweep_

    run, gen = model.cycle_step(), model._gen
    walls = []
    for _ in range(cycles):
        _sync()
        t0 = time.perf_counter()
        run(1, gen)
        _sync()
        walls.append(time.perf_counter() - t0)
    _check(1 in run._graphs and run._key_calls[1] == cycles,
           "the full-width cycle replays its captured graph")
    rec = dict(cycle_eager_s=walls[0], cycle_capture_s=walls[1],
               cycle_replayed_s=float(np.mean(walls[2:])),
               cycle_host_ms=_host_ms(lambda: run(1, gen), 5),
               cycle_device_ms=_batch_ms(lambda: run(1, gen), 5),
               graph_host_ms=_host_ms(run._graphs[1][0].replay, 5),
               graph_device_ms=_batch_ms(run._graphs[1][0].replay, 5),
               graph_nodes=_captured_nodes(lambda: run._body(1)))
    g2 = torch.Generator(device=DEVICE)
    g2.manual_seed(7)

    def eager_cycle():
        run.fill(g2)
        run._body(1)
        run.params[2].copy_(beta_block(run.mdot[0], run.aprime, generator=g2))

    rec["cycle_eager_host_ms"] = _host_ms(eager_cycle, 2)

    st = [t.clone() for t in run.state]
    M, eta, a, beta = (t.clone() for t in (run._M[1], run.eta, run.a, run.beta))
    n_dk = st[1][0]
    zbar = n_dk.to(torch.float32) / run._n_d[:, None]
    blocks = {
        "z": lambda: _sweep_(run._st, *st, M, eta, a, run.alpha * beta, run.g_z, run.gamma,
                             run.xi, 1, *run._pos),
        "eta": lambda: eta_block(zbar, a[0], run.mu, run.sigma, run.g_eta[0]),
        "a": lambda: a_block(zbar, eta[0], run._st.labs, run.u_a[0]),
        "m": lambda: antoniak_draw(n_dk, run.alpha, beta[0], run._logs, run.g_m[0])
        .sum(dim=0).to(torch.float32) / model.D,
    }
    eager = {"fills": lambda: run.fill(g2),
             "beta": lambda: beta_block(run.mdot[0], run.aprime, generator=g2)}
    host_s, device_ms = {}, {}
    for name, fn in {**blocks, **eager}.items():
        reps = 1 if name == "z" else 3
        _sync()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
            _sync()
        host_s[name] = (time.perf_counter() - t0) / reps
        if name in blocks:
            graph = capture_graph(fn, torch.device(DEVICE))
            device_ms[name] = _batch_ms(graph.replay, 5)
            del graph
        else:
            device_ms[name] = _batch_ms(fn, 5)
    bytes_ms, ops_ms = hslda_sweep_bound_ms(model)
    rec.update(block_host_s=host_s, block_device_ms=device_ms,
               sweep_bound_ms=max(bytes_ms, ops_ms),
               sweep_bound_by="bytes" if bytes_ms >= ops_ms else "operations",
               sweep_every_row_bound_ms=hslda_sweep_bound_ms(model, model.tok_v.numel())[0])
    return rec


def _graph_nodes(graph) -> int:
    """Nodes of a captured graph (``keep_graph=True``), by CUDA's
    ``cuGraphGetNodes``: the device operations that each replay runs."""
    import ctypes

    cu = ctypes.CDLL("libcuda.so.1")
    n = ctypes.c_size_t(0)
    rc = cu.cuGraphGetNodes(ctypes.c_void_p(graph.raw_cuda_graph()), None, ctypes.byref(n))
    _check(rc == 0, f"cuGraphGetNodes returned {rc}")
    return n.value


def _most_records(fn, want: int, sessions: int = 3, names=("",)) -> dict:
    """Device records of one call of ``fn`` under torch.profiler: for each
    of ``names``, ``(records, device ms)`` of the kernels whose name holds
    it ("" holds every kernel), from the session of up to ``sessions``
    that kept the most of them (stopping at ``want``).
    A session late in this process drops the first records it would keep
    (a dozen or more by phase 12 on the H100; PERF.md),
    so ``PAD_LAUNCHES`` spin kernels run first and take that loss; a session
    counts only if a spin record survived, so none of ``fn``'s was lost."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    best, out = -1, {name: (0, 0.0) for name in names}
    for _ in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            time.sleep(0.002)
            for _ in range(PAD_LAUNCHES):
                torch.cuda._sleep(0)
            fn()
            torch.cuda.synchronize()
            time.sleep(0.002)
        records = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
        pad = sum(e.count for e in records if "spin_kernel" in e.key)
        _check(pad <= PAD_LAUNCHES, f"{pad} spin records of {PAD_LAUNCHES} launches")
        if pad:
            kept = [e for e in records if "spin_kernel" not in e.key]
            got = {name: (sum(e.count for e in kept if name in e.key),
                          sum(e.self_device_time_total for e in kept if name in e.key) / 1e3)
                   for name in names}
            total = sum(n for n, _ in got.values())
            if total > best:
                best, out = total, got
        if best >= want:
            break
    return out


def _captured_nodes(fn) -> int:
    """Nodes of a CUDA graph of ``fn()`` (``_graph_nodes``), captured only
    to be counted: never replayed."""
    import torch

    twin = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        twin.capture_begin()
        fn()
        twin.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    return _graph_nodes(twin)


def hslda_launch_check(model) -> dict:
    """Device operations of one opt-1 sweep over a copy of the model's
    state: the nodes of a graph of the sweep (counted by CUDA), and
    the profiler's records of the eager sweep and of one replay of the
    sweep's own graph; both records must reach the node count, less what a
    session may lose."""
    import torch

    from lda_thesis_tpu_torch.ops.hslda_gibbs import HSLDASweep

    c = model.counts
    run = HSLDASweep(c.z.T.contiguous(), c.n_dk.clone(), c.n_vk.clone(), c.n_k.clone(),
                     model.tok_v, model.mask, model.labs, model.gamma, model.xi, 1, model.V)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(7)
    ab = model.alpha * model.beta
    run(model.eta, model.a, ab, generator=gen)  # eager: loads what the sweep needs
    nodes = _captured_nodes(run._sweep)

    eager = _most_records(run._sweep, nodes)[""][0]
    run(model.eta, model.a, ab, generator=gen)  # captures, then replays
    _check(run._graph is not None, "the sweep was captured")
    replayed = _most_records(run._graph.replay, nodes)[""][0]
    _check(nodes - LOST_RECORDS <= eager <= nodes and nodes - LOST_RECORDS <= replayed <= nodes,
           f"a replayed sweep runs the eager sweep's device operations ({nodes} nodes in "
           f"the sweep's graph; {replayed} recorded in a replay, {eager} in the eager sweep)")
    return dict(graph_nodes=nodes, eager_records=eager, replay_records=replayed,
                per_position=nodes / model.tok_v.shape[1])


def hslda_phase(seed: int) -> dict:
    """HSLDA on the card (phase 12): (a) one cycle of each coupling form on
    the card against the CPU; (b) two replayed training calls of each form
    at full width against the eager loop, bitwise, the second capturing
    nothing, and the z-sweep's device records against the eager sweep's;
    (c) the HSLDA CLI at full width (L = 512, K = 15, D = 4,171), a
    SIGKILL-and-resume run, and --opt 2 / --opt 3; (d) timings."""
    import torch

    from lda_thesis_tpu_torch.cli import evaluate_hslda
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.models.hslda import HSLDA
    from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint, save_model

    card = _card_line()
    rec = {"card": card, "forms": {}}
    # a. the card against the CPU, one cycle of each form
    for form in HSLDA_FORMS:
        out = hslda_cycle_case(DEVICE, seed, form)
        for dev in (DEVICE, "cpu"):
            _hslda_counts_ok(*out[dev][1:4], out["total"], f"12a {form} on {dev}")
        share = float((out[DEVICE][0] == out["cpu"][0]).to(torch.float32).mean())
        errs = [_max_abs_err([g], [w]) for g, w in zip(out[DEVICE][4:], out["cpu"][4:])]
        _check(share >= 0.99, f"12a {form}: {share:.4f} of the draws equal (>= 0.99)")
        _check(max(errs) <= HSLDA_TOL,
               f"12a {form}: η, a, β within {HSLDA_TOL} of the CPU ({errs})")
        print(f"HSLDA 12a {form}: one cycle on the card against the CPU: {share:.6f} of the "
              f"draws equal, max |Δ| η {errs[0]:.3g}, a {errs[1]:.3g}, β {errs[2]:.3g}; "
              f"count invariants exact on both")
        rec["forms"][form] = dict(equal_draws=share, eta_err=errs[0], a_err=errs[1],
                                  beta_err=errs[2])

    # b. the training loop replayed against the eager loop at full width,
    # for each coupling form of the model: two calls of HSLDA_REPLAYED cycles
    jel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    rec["replay"] = {}
    for form, (opt, _) in HSLDA_FORMS.items():
        if form == "opt2-blockwise":
            continue  # the model's opt 2 is the compact form
        r = hslda_replay_case(DEVICE, jel.train_docs, jel.train_labs, jel.labelset, seed, opt,
                              *HSLDA_REPLAYED, HSLDA_K)
        m = r["model"]
        _check(r["equal"], f"12b {form}: two run_training{HSLDA_REPLAYED} calls == the eager "
                           f"loop, bitwise (z, n_dk, n_vk, n_k, η, a, β, φ̂, z̄, generator)")
        _check(r["added"] == [[2, 2], [0, 0]],
               f"12b {form}: the first call captured the cycle and save graphs, the second "
               f"captured none and ran no body eagerly ({r['added']})")
        nodes = _captured_nodes(lambda: m._cycle._body(opt))
        rec["replay"][form] = dict(added=r["added"], cycle_graph_nodes=nodes)
        print(f"HSLDA 12b {form}: two run_training{HSLDA_REPLAYED} calls at full width == "
              f"the eager loop, bitwise (z, n_dk, n_vk, n_k, η, a, β, φ̂, z̄, generator); "
              f"(captures, eager bodies) by call {r['added']}; the cycle graph has {nodes} "
              f"nodes")
        if opt == 1:
            full = m
        else:
            del m
        del r
    launches = hslda_launch_check(full)
    print(f"HSLDA 12b: at full width (D = {full.D}, N = {full.tok_v.shape[1]}, L = {full.L}, "
          f"K = {full.K}) the opt-1 sweep's graph has {launches['graph_nodes']} nodes "
          f"({launches['per_position']:.1f} per position), the profiler recorded "
          f"{launches['replay_records']} in one replay and {launches['eager_records']} in the "
          f"eager sweep")
    rec["launches"] = launches
    del full

    # d. timings at full width (a fresh model: its first cycle is eager)
    timing = hslda_block_timing(HSLDA(jel.train_docs, jel.train_labs, jel.labelset,
                                      k=HSLDA_K, seed=seed, device=DEVICE), 6)
    hs, dm = timing["block_host_s"], timing["block_device_ms"]
    print(f"HSLDA 12d ({card}), opt-1 cycles at full width through the cycle runner: eager "
          f"{timing['cycle_eager_s']:.4f} s, captured and replayed "
          f"{timing['cycle_capture_s']:.4f} s, replayed {timing['cycle_replayed_s']:.4f} s "
          f"(host clock, synchronized); a replayed cycle issued in "
          f"{timing['cycle_host_ms']:.4f} ms of host time (eagerly "
          f"{timing['cycle_eager_host_ms']:.4f} ms), {timing['cycle_device_ms']:.4f} ms "
          f"of device time (the graph alone, {timing['graph_nodes']} nodes: issued in "
          f"{timing['graph_host_ms']:.4f} ms, {timing['graph_device_ms']:.4f} ms of device "
          f"time)")
    print(f"  by block, host ms run eagerly (synchronized) / device ms as a graph of its own: "
          + ", ".join(f"{k} {1e3 * hs[k]:.4f} / {dm[k]:.4f}" for k in hs)
          + f" (fills and β: device ms by events around 5 calls); the sweep's bound "
          f"{timing['sweep_bound_ms']:.4f} ms by {timing['sweep_bound_by']} over the live "
          f"instances, {timing['sweep_every_row_bound_ms']:.4f} ms over every row of every "
          f"position")
    rec["timing"] = timing

    # c. the CLI at full width
    with tempfile.TemporaryDirectory() as tmp:
        csv_path = os.path.join(tmp, "jel.csv")
        write_corpus_csv(csv_path, jel)
        base = ["-f", csv_path, "-d", "3", "-k", str(HSLDA_K), "--seed", str(seed)]
        long = base + ["-i", str(HSLDA_IT), "-s", str(HSLDA_S)]
        every = ["--save-every", str(HSLDA_S)]
        ck_a, ck_b = os.path.join(tmp, "A"), os.path.join(tmp, "B")
        res, text = _cli(evaluate_hslda.main, long + ["--opt", "1", "--checkpoint", ck_a]
                         + every)
        m = res["model"]
        dims = (m.D, m.tok_v.shape[1], m.L, m.K, m.V)
        _check(dims[:4] == (4171, 192, 512, HSLDA_K),
               f"CLI HSLDA at full width: (D, N, L, K) == (4171, 192, 512, 15) ({dims[:4]})")
        _hslda_counts_ok(*m.counts[1:], m.n_tokens, "CLI HSLDA --opt 1")
        auc = res["metrics"]["auc_roc"]
        _check(auc > MIN_AUC, f"CLI HSLDA --opt 1: AUC {auc} > {MIN_AUC}")
        want = METRIC_LINES.findall(text)
        writes = []
        for _ in range(3):
            t0 = time.perf_counter()
            save_model(os.path.join(tmp, "W"), m, extra_meta={"iters_done": HSLDA_IT})
            writes.append(1e3 * (time.perf_counter() - t0))
        npz_mb = os.path.getsize(os.path.join(tmp, "W.npz")) / 1e6
        steps = {k[:-2]: v for k, v in res["stats"].items() if k.endswith("_s")}
        print(f"CLI HSLDA --opt 1 (-i {HSLDA_IT} -s {HSLDA_S}, test 250; 25): (D, N, L, K, V) = "
              f"{dims}, {m.n_tokens} tokens; AUC {auc}; wall by step "
              f"{json.dumps({k: round(v, 4) for k, v in steps.items()})} ({card})")
        print(f"  checkpoint write: {[round(w, 3) for w in writes]} ms ({npz_mb:.1f} MB npz)")
        rec["cli"] = dict(dims=dims, n_tokens=m.n_tokens, auc_roc=auc, wall_s=steps,
                          metrics=res["metrics"], checkpoint_write_ms=float(np.median(writes)),
                          checkpoint_npz_mb=npz_mb)
        del res, m

        done, rc = _kill_after_first_checkpoint(long + ["--opt", "1", "--checkpoint", ck_b]
                                                + every, ck_b, os.path.join(tmp, "B.log"),
                                                cli="evaluate_hslda")
        _check(done == HSLDA_S and rc == -signal.SIGKILL,
               f"the HSLDA CLI run was killed by SIGKILL at its first checkpoint (iteration "
               f"{done}, rc {rc})")
        t0 = time.perf_counter()
        resumed = subprocess.run(_cli_module(long + ["--opt", "1", "--checkpoint", ck_b,
                                                     "--resume"] + every, "evaluate_hslda"),
                                 cwd=ROOT, capture_output=True, text=True, timeout=900)
        resume_s = time.perf_counter() - t0
        _check(resumed.returncode == 0,
               f"the resumed HSLDA CLI run succeeded: {resumed.stdout[-2000:]}"
               f"{resumed.stderr[-2000:]}")
        _check(f"resumed from {ck_b} at iteration {HSLDA_S}" in resumed.stdout,
               "the fresh process resumed from the checkpoint of iteration 5")
        got = METRIC_LINES.findall(resumed.stdout)
        _check(len(want) == 4 and got == want,
               f"the resumed HSLDA run prints the uninterrupted run's metric lines: "
               f"{got} != {want}")
        (a, _), (b, meta_b) = load_checkpoint(ck_a), load_checkpoint(ck_b)
        _check(meta_b["iters_done"] == HSLDA_IT and _same_arrays(a, b),
               "HSLDA A.npz and B.npz are equal array for array, bitwise")
        print(f"  kill and resume: killed by SIGKILL at its checkpoint of cycle {done}, resumed "
              f"in a fresh process ({resume_s:.3f} s); all {len(a)} arrays bitwise equal "
              f"({', '.join(sorted(a))}); the four metric lines equal")
        rec["kill_resume"] = dict(killed_at=done, arrays=len(a), resumed_run_s=resume_s)

        for opt in (2, 3):
            res, _ = _cli(evaluate_hslda.main,
                          base + ["-i", str(HSLDA_SHORT_IT), "-s", str(HSLDA_S), "--test-it",
                                  str(HSLDA_SHORT_TEST_IT), "--opt", str(opt)])
            m = res["model"]
            _hslda_counts_ok(*m.counts[1:], m.n_tokens, f"CLI HSLDA --opt {opt}")
            _check(opt in m._cycle._graphs, f"CLI HSLDA --opt {opt} replays its cycle")
            steps = {k[:-2]: v for k, v in res["stats"].items() if k.endswith("_s")}
            print(f"CLI HSLDA --opt {opt} (-i {HSLDA_SHORT_IT} -s {HSLDA_S}, test "
                  f"{HSLDA_SHORT_TEST_IT}): AUC {res['metrics']['auc_roc']}; wall by step "
                  f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}")
            rec[f"cli_opt{opt}"] = dict(auc_roc=res["metrics"]["auc_roc"], wall_s=steps)
            del res, m
    return rec


# ---------------------------------------------------------------- multi-device

MD_CHAINS = (1, 2, 4, 8, 16)  # chains batched on the card, timed
MD_SHORT = (10, 5)  # (iters, thinning) of the dense and spawned-rank runs
MD_CLI = (200, 25)
MD_CLI_SHORT = (50, 25)  # the torchrun and kill-and-resume CLI runs
MD_TIMED_CALLS = 3
MD_DENSE_CHAINS = (1, 2, 4, 8, 16)  # chains in one dense sweep graph, timed
MD_DENSE_REPLAYS = 5


def _recorded(fn):
    """``fn()`` with every merge-block kernel call of ``ops.gibbs_fused``
    recorded: returns ``fn``'s result and the ``(inputs, outputs)`` of each
    call."""
    from lda_thesis_tpu_torch.ops import gibbs_fused

    calls, real = [], gibbs_fused.fused_block

    def record(*args):
        out = real(*args)
        calls.append((args, out))
        return out

    gibbs_fused.fused_block = record
    try:
        return fn(), calls
    finally:
        gibbs_fused.fused_block = real


def chains_batch_case(model, M: int) -> dict:
    """The distributed trainer's merge block for ``model``'s C local chains
    (``fused_train_block`` over the chain axis: one kernel-1 launch, the
    chains side by side on the document axis) against C single-chain calls
    with the same uniforms: z, n_dk, the tables and their totals bitwise
    equal; the counters read 1 and C.  The batched launch's own inputs
    (C·D documents) go through the plain version on the card, which must
    give the kernel's z and n_dk bitwise.  Also the device time of each
    (CUDA events)."""
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.ops.gibbs_fused import (
        FusedLDAState,
        block_uniforms,
        fused_train_block,
    )

    st, c = model.state, model.corpus
    U, D_s = c.tok_v_t.shape
    C = st.z.shape[0]
    vbeta = float(model.V * model.beta)
    u = block_uniforms((C, M, U, D_s), c.tok_v_t, generator=model._gens)
    args = (c.tok_v_t, c.tok_f_t, c.lab_ids, c.lab_valid_t, model.alpha, model.beta, M)

    def batched():
        return fused_train_block(FusedLDAState(st.z, st.n_dk, st.n_vk, st.n_k), *args,
                                 uniforms=u, vbeta=vbeta)

    def singles():
        return [fused_train_block(FusedLDAState(st.z[j], st.n_dk[j], st.n_vk[j], st.n_k[j]),
                                  *args, uniforms=u[j], vbeta=vbeta)
                for j in range(C)]

    before = fbc.launches
    out, calls = _recorded(batched)
    torch.cuda.synchronize()
    n_batched = fbc.launches - before
    one = singles()
    n_single = fbc.launches - before - n_batched
    fbc.launches = before  # comparison launches do not count
    for j, s1 in enumerate(one):
        _check(_bitwise([out.z[j], out.n_dk[j], out.n_vk[j], out.n_k[j]],
                        [s1.z, s1.n_dk, s1.n_vk, s1.n_k]),
               f"chain {j} of the batched launch equals its single-chain launch bitwise")
    _check(n_batched == 1 and n_single == C and len(calls) == 1,
           f"kernel-1 launches: {n_batched} batched against {n_single} single-chain")
    (inputs, got), = calls
    _check(inputs[0].shape[0] == C * D_s, f"the batched launch holds {C} x {D_s} documents")
    t0 = time.perf_counter()
    want = fbc.fused_block_torch(*inputs)
    torch.cuda.synchronize()
    plain_s = time.perf_counter() - t0
    _check(_bitwise(list(got), list(want)),
           f"the batched launch ({C * D_s} documents, M = {M}) equals the plain version on "
           f"its inputs, bitwise")
    del calls, inputs, got, want
    before = fbc.launches
    batched_ms = _median_ms(batched, 3)
    single_ms = _median_ms(singles, 3)
    fbc.launches = before
    return dict(chains=C, docs_per_launch=C * D_s, U=U, A=c.lab_ids.shape[1], M=M,
                launches_batched=n_batched, launches_single=n_single,
                batched_ms=batched_ms, single_ms=single_ms, plain_s=plain_s)


def _md_model(corpus, dicti, seed: int, mesh, n_chains: int, **kw):
    from lda_thesis_tpu_torch.parallel import DistributedLabeledLDA

    return DistributedLabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                                 dicti, alpha=0.1, beta=0.01, mesh=mesh, n_chains=n_chains,
                                 seed=seed, **kw)


def md_timing(model, card: str) -> dict:
    """(50; 25) calls of a distributed model: ``MD_TIMED_CALLS`` on the host
    clock (each ending in a synchronize; median), one under torch.profiler
    for the device's busy time and idle share."""
    import torch

    def train():
        model.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS)
        torch.cuda.synchronize()

    train()  # warm
    walls = []
    for _ in range(MD_TIMED_CALLS):
        t0 = time.perf_counter()
        train()
        walls.append(time.perf_counter() - t0)
    wall = float(np.median(walls))
    prof = _profile(train)
    C = model.n_chains
    return dict(card=card, chains=C, n_buckets=model.n_buckets, wall_s=wall, walls_s=walls,
                chain_sweeps_per_s=C * TRAIN_ITERS / wall,
                tokens_per_s=C * model.n_tokens * TRAIN_ITERS / wall,
                profiled_wall_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
                device_busy_share=prof["busy_ms"] / prof["wall_ms"],
                device_idle_share=prof["idle_share"],
                peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)


def md_dense_case(corpus, dicti, seed: int, mesh) -> dict:
    """Dense AD-LDA, two chains, (10; 5): a run whose sweeps replay the
    rank's one CUDA graph (both chains in each launch) against one whose
    sweeps all run eagerly, bitwise; kernel-2 draws and commits as planned,
    ``iters`` × a sweep's, whatever the chains."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    iters, thinning = MD_SHORT
    graphed = _md_model(corpus, dicti, seed, mesh, 2, sweep="dense")
    eager = _md_model(corpus, dicti, seed, mesh, 2, sweep="dense")
    eager._loop = eager._make_loop()
    eager._loop._bind(eager.state, eager.corpus)
    eager._loop._sweep._graphed = False
    duc.launches = duc.commit_launches = 0
    t0 = time.perf_counter()
    graphed.run_training(iters, thinning)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = (duc.launches, duc.commit_launches)
    eager.run_training(iters, thinning)
    duc.launches, duc.commit_launches = launches
    _check(graphed._loop._sweep._graph is not None
           and graphed._loop._sweep.z_t.shape[0] == 2,
           "dense: the rank's sweep of both chains was captured as one CUDA graph")
    _check(_bitwise([getattr(graphed.state, f) for f in ("z", "n_dk", "n_vk", "n_k",
                                                          "ph_hat", "th_hat")],
                    [getattr(eager.state, f) for f in ("z", "n_dk", "n_vk", "n_k",
                                                        "ph_hat", "th_hat")]),
           "dense AD-LDA: replayed sweeps equal eager ones bitwise")
    draws, commits = planned_sweep_launches(graphed.corpus.tok_f.T.to(torch.float32))
    planned = (iters * draws, iters * commits)
    _check(launches == planned, f"dense AD-LDA launches {launches} == planned {planned}")

    # one step of both chains on the card (kernel 2) against the same step on
    # the CPU (its plain version), from the trained state with the same uniforms
    from lda_thesis_tpu_torch.parallel import make_mesh
    from lda_thesis_tpu_torch.parallel.sharded import make_sharded_train_step

    st, c = graphed.state, graphed.corpus
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 13)
    u = torch.rand((2,) + tuple(c.tok_v.T.shape), generator=gen, device=DEVICE)
    on_card = make_sharded_train_step(mesh, 2, graphed.alpha, graphed.beta)(
        st, c, False, uniforms=list(u))
    t0 = time.perf_counter()
    on_cpu = make_sharded_train_step(make_mesh(device="cpu"), 2, graphed.alpha, graphed.beta)(
        st._replace(**{f: getattr(st, f).cpu() for f in ("z", "n_dk", "n_vk", "n_k",
                                                         "ph_hat", "th_hat")}),
        type(c)(*(t.cpu() for t in c)), False, uniforms=list(u.cpu()))
    cpu_s = time.perf_counter() - t0
    duc.launches, duc.commit_launches = launches  # comparison launches do not count
    fields = ("z", "n_dk", "n_vk", "n_k")
    _check(_bitwise([getattr(on_card, f).cpu() for f in fields],
                    [getattr(on_cpu, f) for f in fields]),
           "dense AD-LDA: a step on the card equals the same step on the CPU, bitwise")
    return dict(launches=launches[0], commit_launches=launches[1], planned=list(planned),
                wall_s=wall, tokens_per_s=2 * graphed.n_tokens * iters / wall,
                cpu_step_s=cpu_s)


def md_dense_chains_case(corpus, dicti, seed: int, mesh, card: str) -> dict:
    """Kernel 2 over a chain axis at the dense AD-LDA shape of the first
    cell (the planted corpus unbucketed: D = 4,171, U = 128, Kp = 512, V =
    8,969; one rank, ``MD_DENSE_CHAINS[-1]`` chains from the trainer's
    init).  (kernel) the batched commit and draw launches against their
    plain versions and C single-chain launches at C = 3 and 8 at the first
    and last positions, a ragged live list with an f = 0 row and K = 1,100
    (the two-pass draw); (sweep) 4 chains in one ``ExactSweep``, an eager
    sweep and 5 replays, against 4 single-chain ``ExactSweep``s from the
    same generators, bitwise, and the node count of a sweep's graph at one
    chain and at ``MD_DENSE_CHAINS[-1]``; (timing) device ms per replayed
    sweep at each C of ``MD_DENSE_CHAINS``, one batched graph against C
    single-chain graphs (CUDA events around ``MD_DENSE_REPLAYS`` replays),
    the bound of the sweep's launches and peak memory.  Every launch here
    is a comparison: the counters are restored."""
    import torch

    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops.gibbs import ExactSweep

    before = (duc.launches, duc.commit_launches)
    L = MD_DENSE_CHAINS[-1]
    model = _md_model(corpus, dicti, seed, mesh, L, sweep="dense")
    st, c = model.state, model.corpus
    tv_t = c.tok_v.T.contiguous()
    tf_t = c.tok_f.T.to(torch.float32).contiguous()
    labs = c.labs.contiguous()
    z_t = st.z.transpose(1, 2).contiguous()
    U, D = tv_t.shape
    K, a, b = model.Kp, model.alpha, model.beta
    vbeta = float(model.V * b)
    args = (tv_t, tf_t, labs, a, b, vbeta)
    draws, commits = planned_sweep_launches(tf_t)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 21)

    err = 0.0
    for C in (3, 8):
        for p in (0, U - 1):
            t = chain_position_inputs(tv_t, tf_t, z_t, st.n_dk, st.n_vk, st.n_k, labs, p, C,
                                      gen)
            err = max(err, chain_step_check(t, a, b, vbeta, f"C = {C}, position {p} of {U} "
                                                            f"({t['live'].numel()} live rows)"))
    err = max(err, chain_step_check(chain_step_inputs(DEVICE, seed, 8, 37, 40, 60), a, b,
                                    0.6, "C = 8, D = 37, K = 40, ragged, a live row f = 0"))
    err = max(err, chain_step_check(chain_step_inputs(DEVICE, seed + 1, 3, 300, 1100, 60), a,
                                    b, 0.6, "C = 3, K = 1,100 (the two-pass draw)"))
    print(f"13c: kernel 2 over chains (D={D}, U={U}, K={K}): the batched commit and draw "
          f"launches equal their plain versions and single-chain launches bitwise at C = 3 "
          f"and 8, positions 0 and {U - 1}, ragged (C = 8, K = 40) and K = 1,100 (C = 3)")

    def work(c0: int, n: int, chained: bool = True):
        w = tuple(x[c0:c0 + n].clone() for x in (z_t, st.n_dk, st.n_vk, st.n_k))
        return w if chained else tuple(x[0] for x in w)

    def gens(n: int, base: int = 0):
        out = []
        for j in range(n):
            g = torch.Generator(device=DEVICE)
            g.manual_seed(seed * 1000 + 700 + base + j)
            out.append(g)
        return out

    wb, ws = work(0, 4), [work(j, 1, False) for j in range(4)]
    batched = ExactSweep(*wb, *args)
    singles = [ExactSweep(*w, *args) for w in ws]
    g_b, g_s = gens(4), gens(4)
    for _ in range(1 + MD_DENSE_REPLAYS):  # eager, then capture and replays
        batched(g_b)
        for run, g in zip(singles, g_s):
            run(g)
    torch.cuda.synchronize()
    _check(batched._graph is not None and all(r._graph is not None for r in singles),
           "the batched and single-chain sweeps replay CUDA graphs")
    for j, w in enumerate(ws):
        _check(_bitwise([x[j] for x in wb], list(w)),
               f"chain {j} of the 4-chain replayed sweep equals its single-chain replayed "
               f"sweep bitwise (z, n_dk, n_vk, n_k), {MD_DENSE_REPLAYS} replays")
    wide = ExactSweep(*work(0, L), *args)
    wide(gens(L))
    nodes = (_captured_nodes(singles[0]._sweep), _captured_nodes(wide._sweep))
    _check(nodes[0] == nodes[1] == draws + commits,
           f"a sweep's graph holds {nodes} nodes at 1 and {L} chains, its planned "
           f"{draws} + {commits} launches")
    del batched, singles, wide, wb, ws
    print(f"13c: 4 chains in one replayed sweep == 4 single-chain replayed sweeps bitwise "
          f"({MD_DENSE_REPLAYS} replays); {nodes[0]} graph nodes at 1 chain and at {L}")

    timing = []
    for C in MD_DENSE_CHAINS:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        run = ExactSweep(*work(0, C), *args)
        g = gens(C, 100)
        run(g)
        run(g)  # eager, then the capture and a first replay
        batched_ms = _batch_ms(run._graph.replay, MD_DENSE_REPLAYS)
        peak = torch.cuda.max_memory_allocated() / 1e9
        runs = [ExactSweep(*work(j, 1, False), *args) for j in range(C)]
        for r, gj in zip(runs, gens(C, 100)):
            r(gj)
            r(gj)
        single_ms = _batch_ms(lambda: [r._graph.replay() for r in runs], MD_DENSE_REPLAYS)
        bound = sum(sweep_bound_ms(tf_t, K, C)) + sum(sweep_commit_bound_ms(tf_t, K, C))
        timing.append(dict(chains=C, batched_ms=batched_ms, single_ms=single_ms,
                           batched_ms_per_chain=batched_ms / C,
                           single_ms_per_chain=single_ms / C,
                           speedup=single_ms / batched_ms, bound_ms=bound,
                           bound_ms_per_chain=bound / C, peak_gb=peak))
        t = timing[-1]
        print(f"  C={C:2d}: a replayed sweep {batched_ms:.4f} ms batched "
              f"({t['batched_ms_per_chain']:.4f} per chain) against {single_ms:.4f} ms for {C} single-chain graphs "
              f"({t['speedup']:.2f}x); bound {bound:.4f} ms ({t['bound_ms_per_chain']:.4f} per "
              f"chain, bytes); peak {peak:.2f} GB ({card})")
        del run, runs
    V = int(st.n_vk.shape[1])
    del model, st, c, z_t
    torch.cuda.empty_cache()
    duc.launches, duc.commit_launches = before
    return dict(card=card, D=D, U=U, K=K, V=V, kernel_max_abs_err=err, sweep_bitwise=True, graph_nodes=list(nodes),
                draws_per_sweep=draws, commits_per_sweep=commits, timing=timing)


def md_ranks(corpus, dicti, seed: int) -> dict:
    """Spawned ranks on the one card over gloo with CUDA tensors, the full
    corpus at (10; 5): (1, 2) fused and dense; (2, 2) replicated against
    (2, 2) vocab-sharded, four chains."""
    from lda_thesis_tpu_torch.parallel.launch import spawn

    base = dict(docs=corpus.train_docs, labs=corpus.train_labs, labelset=corpus.labelset,
                steps=[MD_SHORT + (None,)], estimators=False)
    kw = dict(alpha=0.1, beta=0.01, seed=seed)
    jobs = "lda_thesis_tpu_torch.parallel.jobs:multi_job"
    t0 = time.perf_counter()
    two = spawn(jobs, 2, {"jobs": [
        ("train_job", dict(base, mesh=(1, 2), kw=dict(kw, n_chains=1))),
        ("train_job", dict(base, mesh=(1, 2), kw=dict(kw, n_chains=1, sweep="dense")))]},
        backend="gloo", device=DEVICE, timeout=400)
    two_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    four = spawn(jobs, 4, {"jobs": [
        ("train_job", dict(base, mesh=(2, 2), kw=dict(kw, n_chains=4))),
        ("train_job", dict(base, mesh=(2, 2), kw=dict(kw, n_chains=4, table_shard="vocab")))]},
        backend="gloo", device=DEVICE, timeout=400)
    four_s = time.perf_counter() - t0
    runs = {"fused_1x2": [r[0] for r in two], "dense_1x2": [r[1] for r in two],
            "replicated_2x2": [r[0] for r in four], "vocab_2x2": [r[1] for r in four]}
    for name, res in runs.items():
        for r in res:
            _check(r["backend"] == "gloo" and r["device"].startswith(DEVICE),
                   f"{name}: rank {r['rank']} ran gloo with CUDA tensors ({r['backend']}, "
                   f"{r['device']})")
            _check(r["merges_checked"] == MD_SHORT[0] and r["invariants"]["ok"],
                   f"{name}: rank {r['rank']}: every merge left identical replicas "
                   f"({r['merges_checked']}) and the global counts hold {r['invariants']}")
    rep, voc = runs["replicated_2x2"], runs["vocab_2x2"]
    for a, b in zip(rep, voc):
        for f in ("z", "n_dk", "n_k"):
            _check(np.array_equal(a["state"][f], b["state"][f]),
                   f"vocab-sharded {f} equals replicated, rank {a['rank']}")
    V = rep[0]["state"]["n_vk"].shape[1]
    for ci in range(2):
        table = np.concatenate([voc[ci * 2 + di]["state"]["n_vk"] for di in range(2)], axis=1)
        _check(np.array_equal(table[:, :V], rep[ci * 2]["state"]["n_vk"]),
               f"chain row {ci}: the vocab-sharded tables equal the replicated ones")
    out = {name: dict(seconds=[r["seconds"] for r in res], launches=res[0]["launches"],
                      draw_launches=res[0]["draw_launches"],
                      merges_checked=res[0]["merges_checked"])
           for name, res in runs.items()}
    out.update(spawn_2_ranks_s=two_s, spawn_4_ranks_s=four_s)
    return out


def md_cli(corpus, tmp: str) -> dict:
    """The CLI's multi-device flags: ``--n-chains 8`` in this process, fused
    and with ``--sweep dense`` (the rank's eight chains in one dense sweep
    graph), ``--n-data 2 --table-shard vocab`` under
    ``torch.distributed.run`` with gloo, and a ``--n-chains 4`` run killed
    after its first checkpoint and resumed in a fresh process."""
    import torch

    from lda_thesis_tpu_torch.cli import evaluate_labeled_lda
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.parallel.launch import free_port
    from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint

    csv_path = os.path.join(tmp, "planted.csv")
    write_corpus_csv(csv_path, corpus)
    flags = ["-f", csv_path, "-d", "3", "--seed", "0", "--device", DEVICE]
    it, s = MD_CLI
    fbc.launches = 0
    res, text = _cli(evaluate_labeled_lda.main,
                     flags + ["-i", str(it), "-s", str(s), "--n-chains", "8"])
    launches = fbc.launches
    m = res["model"]
    _check(m.n_chains == 8 and tuple(m.state.z.shape[:1]) == (8,),
           "CLI --n-chains 8: eight chains batched on the card")
    _check(launches == it // 25, f"CLI --n-chains 8: {it // 25} kernel-1 launches ({launches})")
    _check(res["metrics"]["auc_roc"] > MIN_AUC,
           f"CLI --n-chains 8 AUC {res['metrics']['auc_roc']} > {MIN_AUC}")
    out = dict(n_chains_launches=launches, n_chains_auc=res["metrics"]["auc_roc"],
               n_chains_wall_s=_steps(res), n_chains_tokens_per_s=res["tokens_per_s"])
    del res, m

    duc.launches = duc.commit_launches = 0
    res, text = _cli(evaluate_labeled_lda.main,
                     flags + ["-i", str(it), "-s", str(s), "--n-chains", "8", "--sweep",
                              "dense"])
    got = (duc.launches, duc.commit_launches)
    m = res["model"]
    draws, commits = planned_sweep_launches(m.corpus.tok_f.T.to(torch.float32))
    _check(m.n_chains == 8 and m._loop._sweep.z_t.shape[0] == 8
           and m._loop._sweep._graph is not None,
           "CLI --sweep dense --n-chains 8: the eight chains sweep in one graph")
    _check(got == (it * draws, it * commits),
           f"CLI --sweep dense --n-chains 8: kernel-2 launches {got} == {it} x a sweep's "
           f"({draws}, {commits}), not x 8 chains")
    _check(res["metrics"]["auc_roc"] > MIN_AUC,
           f"CLI --sweep dense --n-chains 8 AUC {res['metrics']['auc_roc']} > {MIN_AUC}")
    out.update(dense_n_chains_launches=got[0], dense_n_chains_commit_launches=got[1],
               dense_n_chains_auc=res["metrics"]["auc_roc"],
               dense_n_chains_wall_s=_steps(res),
               dense_n_chains_tokens_per_s=res["tokens_per_s"])
    print(f"  CLI: --sweep dense --n-chains 8 ({it}; {s}): {got[0]} draws and {got[1]} "
          f"commits, AUC {out['dense_n_chains_auc']:.4f}, wall by step "
          f"{json.dumps(out['dense_n_chains_wall_s'])}")
    del res, m

    it, s = MD_CLI_SHORT
    short = flags + ["-i", str(it), "-s", str(s)]
    t0 = time.perf_counter()
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--nproc-per-node", "2",
         "--master-port", str(free_port()), "-m", "lda_thesis_tpu_torch.cli.evaluate_labeled_lda",
         *short, "--n-data", "2", "--table-shard", "vocab", "--dist-backend", "gloo"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    out["torchrun_s"] = time.perf_counter() - t0
    _check(run.returncode == 0, f"torchrun --n-data 2 --table-shard vocab succeeded: "
           f"{run.stdout[-2000:]}{run.stderr[-2000:]}")
    both = run.stdout + run.stderr
    _check(both.count("torch.distributed: gloo backend") == 2,
           "torchrun: both ranks printed the gloo backend they ran")
    aucs = [float(x) for x in re.findall(r"AUC ROC:\s+([0-9.]+)", run.stdout)]
    _check(len(aucs) == 1 and aucs[0] > MIN_AUC,
           f"torchrun: rank 0 alone printed metrics, AUC {aucs} > {MIN_AUC}")
    out["torchrun_auc"] = aucs[0]

    ck_a, ck_b = os.path.join(tmp, "MA"), os.path.join(tmp, "MB")
    every = ["--n-chains", "4", "--save-every", str(s)]
    _, text = _cli(evaluate_labeled_lda.main, short + ["--checkpoint", ck_a] + every)
    want = METRIC_LINES.findall(text)
    done, rc = _kill_after_first_checkpoint(short + ["--checkpoint", ck_b] + every, ck_b,
                                            os.path.join(tmp, "MB.log"))
    _check(done == s and rc == -signal.SIGKILL,
           f"the --n-chains 4 run was killed by SIGKILL at its first checkpoint ({done}, rc {rc})")
    resumed = subprocess.run(_cli_module(short + ["--checkpoint", ck_b, "--resume"] + every),
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
    _check(resumed.returncode == 0 and f"resumed from {ck_b} at iteration {s}" in resumed.stdout,
           f"the --n-chains 4 run resumed: {resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
    got = METRIC_LINES.findall(resumed.stdout)
    _check(len(want) == 4 and got == want,
           f"the resumed --n-chains 4 run prints the uninterrupted run's metrics: {got} != {want}")
    (a, _), (b, _) = (load_checkpoint(f"{ck}.it{it}.rank0") for ck in (ck_a, ck_b))
    (ma, _), (mb, meta_b) = load_checkpoint(ck_a), load_checkpoint(ck_b)
    _check(meta_b["iters_done"] == it and _same_arrays(a, b) and _same_arrays(ma, mb),
           "the killed-and-resumed run's shard and marker equal the uninterrupted run's")
    out.update(kill_resume_arrays=len(a) + len(ma), killed_at=done)
    print(f"  CLI: --n-chains 8 (200; 25) {launches} launches, AUC {out['n_chains_auc']:.4f}; "
          f"torchrun --n-data 2 --table-shard vocab AUC {aucs[0]:.4f} "
          f"({out['torchrun_s']:.1f} s); --n-chains 4 killed at {done} and resumed: "
          f"{len(a)} shard arrays, {len(ma)} marker arrays and 4 metric lines equal")
    return out


def multi_device_phase(seed: int, card: str) -> dict:
    """Phase 13; the kernel counters are set to 0 just before the trainer's
    main run (13b) and read just after."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.parallel import initialize_distributed, make_mesh
    from lda_thesis_tpu_torch.parallel.bootstrap import shutdown
    from lda_thesis_tpu_torch.parallel.jobs import count_invariants
    from lda_thesis_tpu_torch.parallel.launch import free_port

    corpus = planted_corpus(seed)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    rec = {"card": card}

    # (a) chains in kernel 1
    mesh1 = make_mesh(device=DEVICE)
    probe = _md_model(corpus, dicti, seed, mesh1, 4)
    rec["batch"] = chains_batch_case(probe, 25)
    del probe
    b = rec["batch"]
    print(f"13a: {b['chains']} chains x {b['docs_per_launch'] // b['chains']} documents in "
          f"one launch (U={b['U']}, A={b['A']}, M={b['M']}) bitwise equal to "
          f"{b['launches_single']} single-chain launches and to the plain version; block {b['batched_ms']:.3f} ms "
          f"batched against {b['single_ms']:.3f} ms single-chain ({card})")

    # (b) the trainer over an explicit NCCL group of one rank
    initialize_distributed(init_method=f"tcp://localhost:{free_port()}", world_size=1,
                           rank=0, backend="nccl", device=DEVICE)
    _check(torch.distributed.get_backend() == "nccl", "13b runs over an NCCL group")
    mesh = make_mesh(n_data=1, n_chains=1, device=DEVICE)
    model = _md_model(corpus, dicti, seed, mesh, 8)
    fbc.launches = duc.launches = duc.commit_launches = 0
    t0 = time.perf_counter()
    model.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = fbc.launches
    _check(duc.launches == duc.commit_launches == 0, "the fused trainer launches no kernel 2")
    blocks = TRAIN_ITERS // model._merge_M
    _check(launches == blocks * model.n_buckets,
           f"kernel-1 launches {launches} == merge blocks {blocks} x buckets "
           f"{model.n_buckets}, not x {model.n_chains} chains")
    inv = count_invariants(model)
    _check(inv["ok"], f"every chain's count invariants hold: {inv}")
    th = model.run_test(corpus.test_docs, 25, 25)
    metrics = _auc(th, corpus.test_labs, model.labelmap)
    _check(metrics["auc_roc"] > MIN_AUC, f"pooled AUC {metrics['auc_roc']} > {MIN_AUC}")
    mc = model.mc_error()
    _check(mc > 0, f"mc_error() {mc} > 0")
    rec["trainer"] = dict(chains=8, launches=launches, merge_M=model._merge_M,
                          train_s=train_s, auc_roc=metrics["auc_roc"], mc_error=mc)
    print(f"13b: 8 chains over NCCL, (50; 25): {launches} kernel-1 launches, {train_s:.3f} s, "
          f"pooled AUC {metrics['auc_roc']:.4f}, mc_error {mc:.3e}")
    timing = []
    for C in MD_CHAINS:
        m = model if C == 8 else _md_model(corpus, dicti, seed, mesh, C)
        torch.cuda.reset_peak_memory_stats()
        timing.append(md_timing(m, card))
        inv = count_invariants(m)
        _check(inv["ok"], f"C = {C}: every chain's count invariants hold after the timed "
                          f"calls: {inv}")
        if C == MD_CHAINS[-1]:
            # the widest launch of the path, from its trained state
            rec["batch_widest"] = chains_batch_case(m, 25)
        del m
        torch.cuda.empty_cache()
    del model
    buckets = _md_model(corpus, dicti, seed, mesh, 8, n_buckets=4)
    timing.append(md_timing(buckets, card))
    inv = count_invariants(buckets)
    _check(inv["ok"], f"C = 8, 4 buckets: the count invariants hold after the timed calls: "
                      f"{inv}")
    del buckets
    torch.cuda.empty_cache()
    for t in timing:
        print(f"  C={t['chains']:2d} buckets={t['n_buckets']}: {t['chain_sweeps_per_s']:9.1f} "
              f"chain-sweeps/s, {t['tokens_per_s']:.4g} tokens/s, busy "
              f"{t['device_busy_share']:.4f} of {t['profiled_wall_ms']:.2f} ms, peak "
              f"{t['peak_mem_gb']:.2f} GB")
    rec["timing"] = timing
    w = rec["batch_widest"]
    print(f"13b: {w['chains']} chains x {w['docs_per_launch'] // w['chains']} documents in one "
          f"launch (M={w['M']}) bitwise equal to {w['launches_single']} single-chain launches "
          f"and to the plain version ({w['plain_s']:.2f} s); every timed model's count "
          f"invariants hold")

    # (c) dense AD-LDA, replayed against eager; kernel 2 over chains
    rec["dense"] = md_dense_case(corpus, dicti, seed, mesh)
    print(f"13c: dense AD-LDA, 2 chains in one graph, (10; 5): replay == eager bitwise; "
          f"{rec['dense']['launches']} draws, {rec['dense']['commit_launches']} commits; "
          f"one step on the card == on the CPU bitwise")
    rec["dense_chains"] = md_dense_chains_case(corpus, dicti, seed, mesh, card)
    shutdown()

    # (d) several ranks on the one card over gloo; (e) the CLI
    rec["ranks"] = md_ranks(corpus, dicti, seed)
    print(f"13d: ranks over gloo on the card: {json.dumps(rec['ranks'])}")
    with tempfile.TemporaryDirectory() as tmp:
        rec["cli"] = md_cli(corpus, tmp)
    return rec


# ---------------------------------------------------------------- multi-device HSLDA

HMD_CHAINS = (1, 4, 16, 64)  # DistributedHSLDA on one rank, timed
HMD_BATCH = 4  # chains of 14a's batched sweep
HMD_SWEEPS = 3  # 14a: eager, capture, replay
HMD_TIMED = 3  # 14b: timed cycles after two warm-up cycles (eager, capture)
HMD_RANK_CYCLES = 3  # 14c
HMD_CLI = (10, 5, 25, 5)  # 14d: -i, -s, --test-it, --test-s
MIN_EQUAL_DRAWS = 0.99  # 12a's card-against-CPU standard


def _hslda_model(docs, labs, labelset, seed: int, n_chains: int, device, k: int, **kw):
    from lda_thesis_tpu_torch.parallel import DistributedHSLDA, make_mesh

    return DistributedHSLDA(docs, labs, labelset, mesh=make_mesh(device=device),
                            n_chains=n_chains, k=k, seed=seed, **kw)


def _chain_counts_ok(state, total: int, what: str) -> None:
    """Every chain's count invariants of a one-rank ``HSLDAShardedState``."""
    for c in range(state.n_k.shape[0]):
        _hslda_counts_ok(state.n_dk[c], state.n_vk[c], state.n_k[c], total,
                         f"{what}, chain {c}")


def hslda_chains_case(device, docs, labs, labelset, seed: int, C: int, sweeps: int,
                      k: int) -> dict:
    """``sweeps`` opt-1 z-sweeps of C chains (a ``DistributedHSLDA``'s
    initial state) three ways on ``device``, each chain's Gumbel noise from
    the generator seeded ``seed + c``: one batched ``HSLDASweep`` (eager,
    then a captured graph replayed), the same batched sweep run eagerly
    every time, and C single-chain ``HSLDASweep`` s.  Returns the three
    end states, the share of the single-chain draws that the batched sweep
    drew alike, the sweeps and the model."""
    import torch

    from lda_thesis_tpu_torch.ops.hslda_gibbs import HSLDASweep

    m = _hslda_model(docs, labs, labelset, seed, C, device, k)
    st, cp = m.state, m.corpus
    N = st.z.shape[2]

    def gens(c0=0, n=C):
        out = []
        for c in range(c0, c0 + n):
            g = torch.Generator(device=device)
            g.manual_seed(seed + c)
            out.append(g)
        return out

    def batched(graphed: bool):
        bufs = (st.z.permute(2, 0, 1).reshape(N, -1).contiguous(), st.n_dk.clone(),
                st.n_vk.clone(), st.n_k.clone())
        sweep = HSLDASweep(*bufs, cp.tok_v, cp.mask, cp.labs, m.gamma, m.xi, 1, m.V)
        sweep._graphed = sweep._graphed and graphed
        return sweep, bufs

    ab = m.alpha * st.beta
    runs = {}
    for name, graphed in (("graphed", True), ("eager", False)):
        sweep, bufs = batched(graphed)
        g = gens()
        for _ in range(sweeps):
            sweep(st.eta, st.a, ab, generator=g)
        runs[name] = (sweep, bufs)
    singles = []
    for c in range(C):
        bufs = (st.z[c].T.contiguous(), st.n_dk[c].clone(), st.n_vk[c].clone(),
                st.n_k[c].clone())
        sweep = HSLDASweep(*bufs, cp.tok_v, cp.mask, cp.labs, m.gamma, m.xi, 1, m.V)
        g = gens(c, 1)[0]
        for _ in range(sweeps):
            sweep(st.eta[c], st.a[c], ab[c], generator=g)
        singles.append((sweep, bufs))
    z_batched = runs["graphed"][1][0].view(N, C, -1)
    equal = sum(int((z_batched[:, c] == s[1][0]).sum()) for c, s in enumerate(singles))
    return dict(model=m, graphed=runs["graphed"], eager=runs["eager"], singles=singles,
                equal_draws=equal / z_batched.numel(), N=N)


def hslda_chain_runners_case(device, docs, labs, labelset, seed: int, C: int, iters: int,
                             thinning: int, k: int) -> dict:
    """A one-rank ``DistributedHSLDA`` of C chains: one ``run_training(iters,
    thinning)`` call (its loop's cycle runner over the chain axis, the
    saves) held to ``eager_hslda_training``, and its chains against C
    single-chain ``CycleStep`` runners from the same initial state, each
    drawing from copies of its chain's two generators.  Returns the model,
    whether the call equals the eager loop, whether every single-chain
    runner's state equals its chain's bit for bit, the share of the
    single-chain runners' draws of z that the batched runner drew alike and
    the largest difference of η, a and β between them."""
    import torch

    from lda_thesis_tpu_torch.models.hslda import CycleStep

    m = _hslda_model(docs, labs, labelset, seed, C, device, k)
    st0 = [t.clone() for t in m.state]
    gens = [(_copy_generator(a), _copy_generator(b))
            for a, b in zip(m._gens.local, m._gens.chain)]
    want = eager_hslda_training(m, iters, thinning)
    m.run_training(iters, thinning)
    equal = hslda_training_equal(m, want)
    cp, got = m.corpus, m.state
    bitwise, same_z, err = True, 0, 0.0
    for c, (local, chain) in enumerate(gens):
        z, n_dk, n_vk, n_k, eta, a, beta = (t[c].clone() for t in st0)
        z_t = z.T.contiguous()
        run = CycleStep(z_t, n_dk, n_vk, n_k, cp.tok_v, cp.mask, cp.labs, eta, a, beta,
                        m._stirling_logs, m.mu, m.sigma, m.aprime, m.alpha, m.gamma, m.xi, m.V,
                        D_total=m.D)
        for _ in range(iters):
            run(1, local, chain)
        mine = [z_t.T, n_dk, n_vk, n_k, *run.params]
        bitwise = bitwise and _bitwise([t.cpu() for t in mine], [t[c].cpu() for t in got])
        same_z += int((z_t.T == got.z[c]).sum())
        err = max(err, _max_abs_err(mine[4:], [t[c] for t in got[4:]]))
    return dict(model=m, equal=equal, singles_bitwise=bitwise,
                equal_draws=same_z / got.z.numel(), max_abs_err=err)


def hslda_chains_phase(seed: int, card: str) -> dict:
    """14a: 4 chains in one replayed z-sweep graph against 4 single-chain
    graphs at full width."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import jel_corpus

    jel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    r = hslda_chains_case(DEVICE, jel.train_docs, jel.train_labs, jel.labelset, seed,
                          HMD_BATCH, HMD_SWEEPS, HSLDA_K)
    m, (sweep, bufs) = r["model"], r["graphed"]
    _check(sweep._graph is not None and sweep.sweeps == HMD_SWEEPS,
           "14a: the batched sweep replays its captured graph")
    _check(_bitwise(list(bufs), list(r["eager"][1])),
           f"14a: {HMD_SWEEPS} batched sweeps replayed == eager, bitwise (z, n_dk, n_vk, n_k)")
    z_t, n_dk, n_vk, n_k = bufs
    for c in range(HMD_BATCH):
        _hslda_counts_ok(n_dk[c], n_vk[c], n_k[c], m.n_tokens, f"14a batched chain {c}")
        _hslda_counts_ok(*r["singles"][c][1][1:], m.n_tokens, f"14a single chain {c}")
    share = r["equal_draws"]
    bitwise = all(torch.equal(z_t.view(r["N"], HMD_BATCH, -1)[:, c], s[1][0])
                  and torch.equal(n_vk[c], s[1][2]) for c, s in enumerate(r["singles"]))
    _check(share >= MIN_EQUAL_DRAWS,
           f"14a: {share:.6f} of the batched draws equal the single-chain ones "
           f"(>= {MIN_EQUAL_DRAWS})")
    cyc = hslda_chain_runners_case(DEVICE, jel.train_docs, jel.train_labs, jel.labelset, seed,
                                   HMD_BATCH, *HSLDA_REPLAYED, HSLDA_K)
    _check(cyc["equal"], f"14a: a {HMD_BATCH}-chain run_training{HSLDA_REPLAYED} call == the "
                         f"eager loop, bitwise (every chain's z, counts, η, a, β, φ̂, "
                         f"generators)")
    _check(cyc["equal_draws"] >= MIN_EQUAL_DRAWS,
           f"14a: {cyc['equal_draws']:.6f} of the batched cycles' draws equal the single-chain "
           f"runners' (>= {MIN_EQUAL_DRAWS})")
    print(f"14a ({card}): {HMD_BATCH} chains, one run_training{HSLDA_REPLAYED} call through "
          f"the loop's cycle runner == the eager loop, bitwise; against {HMD_BATCH} "
          f"single-chain cycle runners {cyc['equal_draws']:.6f} of the draws equal, "
          f"{'bitwise' if cyc['singles_bitwise'] else 'not bitwise'} (max |Δ| of η, a, β "
          f"{cyc['max_abs_err']:.3g})")
    cyc_share, cyc_bitwise, cyc_err = (cyc["equal_draws"], cyc["singles_bitwise"],
                                       cyc["max_abs_err"])
    del cyc
    batched_ms = _batch_ms(sweep._graph.replay, 5)
    singles_ms = _batch_ms(lambda: [s[0]._graph.replay() for s in r["singles"]], 5)
    twin = torch.cuda.CUDAGraph(keep_graph=True)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        twin.capture_begin()
        sweep._sweep()
        twin.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    nodes = _graph_nodes(twin)
    del twin  # captured only to be counted: never replayed
    live_b, live_o = hslda_sweep_bound_ms(m)
    rows_b, _ = hslda_sweep_bound_ms(m, m.tok_v.numel())
    rec = dict(card=card, chains=HMD_BATCH, equal_draws=share, bitwise=bitwise,
               cycles_equal_draws=cyc_share, cycles_bitwise=cyc_bitwise,
               cycles_max_abs_err=cyc_err,
               batched_ms=batched_ms, singles_ms=singles_ms, graph_nodes=nodes,
               bound_ms=HMD_BATCH * max(live_b, live_o),
               bound_by="bytes" if live_b >= live_o else "operations",
               every_row_bound_ms=HMD_BATCH * rows_b)
    print(f"14a ({card}): {HMD_BATCH} chains in one z-sweep graph ({nodes} nodes) against "
          f"{HMD_BATCH} single-chain graphs, {HMD_SWEEPS} sweeps each: {share:.6f} of the "
          f"draws equal ({'bitwise' if bitwise else 'not bitwise'}); replayed == eager "
          f"bitwise; count invariants exact per chain; a replayed sweep {batched_ms:.4f} ms "
          f"batched against {singles_ms:.4f} ms for the {HMD_BATCH} single-chain graphs "
          f"(bound {rec['bound_ms']:.4f} ms by {rec['bound_by']} over the live instances, "
          f"{rec['every_row_bound_ms']:.4f} ms over every row)")
    return rec


def hslda_reckoned_bytes(D: int, N: int, L: int, K: int, V: int, S: int, C: int) -> int:
    """The device bytes a one-rank ``DistributedHSLDA`` of C chains holds at
    its peak (the big terms): per chain the sweep's work state and noise
    (z twice, n_dk, two tables, M, a, η·a temporaries, the Gumbels), the
    cycle's m noise and a block of its logits, and the sweep's per-row
    index tables (int64 rows and flat indices, int32 masks, for C·D rows)."""
    from lda_thesis_tpu_torch.models.hslda import D_BLOCK

    per_chain = (4 * N * D * 2 + 4 * D * K * 2 + 4 * V * K * 3 + 4 * D * L * 5
                 + 4 * N * D * K + 4 * D * K * S + 2 * 4 * D_BLOCK * K * S)
    static = N * D * (8 + 8 + 4 + 4)
    return C * (per_chain + static)


def hslda_chain_timing(seed: int, card: str) -> list:
    """14b: ``DistributedHSLDA`` on one rank at C = 1, 4, 16, 64 at full
    width: four warm-up cycles and two saves (the first cycle and save
    eager, the second captured), ``HMD_TIMED`` cycles on the host clock ending in a synchronize, one
    under torch.profiler; the peak memory against the reckoned bytes."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.parallel.jobs import hslda_invariants

    jel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    out = []
    for C in HMD_CHAINS:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        m = _hslda_model(jel.train_docs, jel.train_labs, jel.labelset, seed, C, DEVICE,
                         HSLDA_K)
        D, N = m.tok_v.shape
        reckoned = hslda_reckoned_bytes(D, N, m.L, m.K, m.V, m._stirling_logs.shape[0], C)
        print(f"14b C={C}: reckoned device bytes {reckoned / 1e9:.3f} GB")
        m.run_training(4, 2)  # eager cycle and save, then their captures
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        m.run_training(HMD_TIMED, HMD_TIMED)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        prof = _profile(lambda: m.run_training(1, 1))
        st = m.state
        inv = hslda_invariants(m.mesh, st, m.n_tokens, "replicated")
        _check(inv["ok"], f"14b C={C}: every chain's count invariants hold: {inv}")
        _check(bool(torch.isfinite(st.eta).all()) and bool(torch.isfinite(st.beta).all()),
               f"14b C={C}: η and β are finite")
        loop = m._loops[1]
        _check(1 in loop._run._graphs and loop._saves._graphs,
               f"14b C={C}: the chains' cycle and save replay graphs")
        rec = dict(card=card, chains=C, cycles=HMD_TIMED, wall_s=wall,
                   cycles_per_s=HMD_TIMED / wall, chain_cycles_per_s=C * HMD_TIMED / wall,
                   tokens_per_s=C * m.n_tokens * HMD_TIMED / wall,
                   profiled_cycle_ms=prof["wall_ms"], device_busy_ms=prof["busy_ms"],
                   device_busy_share=prof["busy_ms"] / prof["wall_ms"],
                   reckoned_gb=reckoned / 1e9,
                   peak_mem_gb=torch.cuda.max_memory_allocated() / 1e9)
        print(f"14b C={C:2d} ({card}): {rec['cycles_per_s']:.3f} cycles/s, "
              f"{rec['chain_cycles_per_s']:.2f} chain-cycles/s, {rec['tokens_per_s']:.4g} "
              f"tokens/s; a profiled cycle {prof['wall_ms']:.1f} ms, device busy "
              f"{rec['device_busy_share']:.4f}; peak {rec['peak_mem_gb']:.3f} GB (reckoned "
              f"{rec['reckoned_gb']:.3f})")
        out.append(rec)
        del m, loop, st
    torch.cuda.empty_cache()
    return out


def hslda_ranks_case(seed: int) -> dict:
    """14c: two gloo ranks on the card, mesh (1, 2), C = 2, at full width,
    ``HMD_RANK_CYCLES`` cycles, replicated then vocab-sharded, in one spawn."""
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.parallel.launch import spawn

    jel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    base = dict(docs=jel.train_docs, labs=jel.train_labs, labelset=jel.labelset, mesh=(1, 2),
                steps=[(HMD_RANK_CYCLES, HMD_RANK_CYCLES, 1, False)])
    kw = dict(n_chains=2, k=HSLDA_K, seed=seed)
    t0 = time.perf_counter()
    res = spawn("lda_thesis_tpu_torch.parallel.jobs:multi_job", 2, {"jobs": [
        ("hslda_job", dict(base, kw=kw)),
        ("hslda_job", dict(base, kw=dict(kw, table_shard="vocab")))]},
        backend="gloo", device=DEVICE, timeout=400)
    spawn_s = time.perf_counter() - t0
    rep, voc = [r[0] for r in res], [r[1] for r in res]
    for name, runs in (("replicated", rep), ("vocab", voc)):
        for r in runs:
            _check(r["backend"] == "gloo" and r["device"].startswith(DEVICE),
                   f"14c {name}: rank {r['rank']} ran gloo with CUDA tensors")
            _check(all(r["replicas_equal"]) and r["invariants"]["ok"],
                   f"14c {name}: rank {r['rank']}: each chain's table, n_k, η and β are "
                   f"bitwise equal across the data row, and the counts hold "
                   f"{r['invariants']}")
    for a, b in zip(rep, voc):
        for f in ("z", "n_dk", "n_k", "eta", "a", "beta"):
            _check(np.array_equal(a["state"][f], b["state"][f]),
                   f"14c: vocab-sharded {f} equals replicated, rank {a['rank']}")
    V = rep[0]["state"]["n_vk"].shape[1]
    table = np.concatenate([r["state"]["n_vk"] for r in voc], axis=1)
    _check(np.array_equal(table[:, :V], rep[0]["state"]["n_vk"]),
           "14c: the vocab-sharded tables equal the replicated ones")
    rec = dict(spawn_s=spawn_s, seconds=[[r["seconds"] for r in runs] for runs in (rep, voc)])
    print(f"14c: two gloo ranks on the card, mesh (1, 2), 2 chains, {HMD_RANK_CYCLES} cycles: "
          f"replicas bitwise equal across the data row, vocab-sharded == replicated bitwise; "
          f"spawn {spawn_s:.2f} s, training {rec['seconds']} s")
    return rec


def hslda_cli_case(seed: int, card: str, tmp: str, single_test_s: float) -> dict:
    """14d: the HSLDA CLI with ``--n-chains 8`` on phase 12's CSV, and a run
    of it killed by SIGKILL after its first checkpoint and resumed in a
    fresh process: every array and generator state of the final checkpoint
    equal to the uninterrupted run's."""
    from lda_thesis_tpu_torch.cli import evaluate_hslda
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.utils.checkpoint import load_checkpoint

    it, s, test_it, test_s = HMD_CLI
    csv_path = os.path.join(tmp, "jel.csv")
    write_corpus_csv(csv_path, jel_corpus(seed, n_l3=HSLDA_N_L3))
    argv = ["-f", csv_path, "-d", "3", "-k", str(HSLDA_K), "--seed", str(seed), "-i", str(it),
            "-s", str(s), "--test-it", str(test_it), "--test-s", str(test_s),
            "--n-chains", "8", "--save-every", str(s)]
    ck_a, ck_b = os.path.join(tmp, "HA"), os.path.join(tmp, "HB")
    res, text = _cli(evaluate_hslda.main, argv + ["--checkpoint", ck_a])
    m = res["model"]
    _check(m.n_chains == 8 and tuple(m.state.z.shape[:1]) == (8,),
           "14d: --n-chains 8 runs eight chains batched on the card")
    _chain_counts_ok(m.state, m.n_tokens, "14d --n-chains 8")
    auc = res["metrics"]["auc_roc"]
    _check(auc > MIN_AUC, f"14d: chain-averaged AUC {auc} > {MIN_AUC}")
    _check("8 chains, mesh {'chains': 1, 'data': 1}" in text,
           "14d: the wall-by-step line names the chains and the mesh")
    want = METRIC_LINES.findall(text)
    steps = {k[:-2]: v for k, v in res["stats"].items() if k.endswith("_s")}
    del res, m
    done, rc = _kill_after_first_checkpoint(argv + ["--checkpoint", ck_b], ck_b,
                                            os.path.join(tmp, "HB.log"), cli="evaluate_hslda")
    _check(done == s and rc == -signal.SIGKILL,
           f"14d: the --n-chains 8 run was killed by SIGKILL at its first checkpoint ({done}, "
           f"rc {rc})")
    resumed = subprocess.run(_cli_module(argv + ["--checkpoint", ck_b, "--resume"],
                                         "evaluate_hslda"),
                             cwd=ROOT, capture_output=True, text=True, timeout=600)
    _check(resumed.returncode == 0 and f"resumed from {ck_b} at iteration {s}" in resumed.stdout,
           f"14d: the run resumed: {resumed.stdout[-2000:]}{resumed.stderr[-2000:]}")
    got = METRIC_LINES.findall(resumed.stdout)
    _check(len(want) == 4 and got == want,
           f"14d: the resumed run prints the uninterrupted run's metrics: {got} != {want}")
    (a, _), (b, _) = (load_checkpoint(f"{ck}.it{it}.rank0") for ck in (ck_a, ck_b))
    (ma, _), (mb, meta_b) = load_checkpoint(ck_a), load_checkpoint(ck_b)
    _check(meta_b["iters_done"] == it and _same_arrays(a, b) and _same_arrays(ma, mb),
           "14d: the killed-and-resumed run's shard (every array, both generators' states) "
           "and marker equal the uninterrupted run's")
    rec = dict(card=card, chains=8, auc_roc=auc, wall_s=steps, killed_at=done,
               kill_resume_arrays=sorted(a) + sorted(ma), test_s=steps["test"],
               single_chain_test_s=single_test_s,
               test_ratio=steps["test"] / single_test_s if single_test_s else None)
    print(f"14d ({card}): the HSLDA CLI --n-chains 8 (-i {it} -s {s}, test {test_it}; "
          f"{test_s}): chain-averaged AUC {auc}; wall by step "
          f"{json.dumps({k: round(v, 4) for k, v in steps.items()})}; the fold-in "
          f"{steps['test']:.3f} s against {single_test_s:.3f} s for one chain at test "
          f"{test_it} (phase 12); killed at {done} and resumed: {len(a)} shard arrays, "
          f"{len(ma)} marker arrays and the metric lines equal")
    return rec


def hslda_multi_phase(seed: int, card: str, single_test_s: float) -> dict:
    """Phase 14: multi-device HSLDA (14a-d)."""
    rec = {"card": card, "chains": hslda_chains_phase(seed, card),
           "timing": hslda_chain_timing(seed, card), "ranks": hslda_ranks_case(seed)}
    with tempfile.TemporaryDirectory() as tmp:
        rec["cli"] = hslda_cli_case(seed, card, tmp, single_test_s)
    return rec


# ---------------------------------------------------------------- compiled loops
LOOP_SWEEPS = 5  # sweeps of each graphed loop held to the eager one, and timed
LOOP_TEST = (10, 5)  # (it, thinning) of the recorded fold-in calls
LOOP_CYCLES = 2  # HSLDA cycles trained before its fold-ins


@contextlib.contextmanager
def _recording(module, name: str):
    """Inside, every call of ``module.name`` runs as before and is recorded
    as ``(args, kwargs, its generator's states before and after the call,
    its output, its seconds)``.  Tensor arguments are recorded as copies
    taken at the call: a model's means are its save runner's buffers, which
    its next training call overwrites."""
    import torch

    calls, real = [], getattr(module, name)

    def snap(x):
        return x.clone() if torch.is_tensor(x) else x

    def record(*args, **kw):
        gen = _generator_of(args, kw)
        before = gen.get_state()
        inputs = (tuple(snap(a) for a in args), {k: snap(v) for k, v in kw.items()})
        _sync()
        t0 = time.perf_counter()
        out = real(*args, **kw)
        _sync()
        calls.append((*inputs, (before, gen.get_state()), out, time.perf_counter() - t0))
        return out

    setattr(module, name, record)
    try:
        yield calls
    finally:
        setattr(module, name, real)


def _same_as_eager(eager, call, what: str) -> tuple:
    """A recorded loop's output equals ``eager`` run on the same inputs from
    the same generator state, bit for bit; returns the seconds of the
    recorded call and of the eager loop (host clock, synchronized)."""
    import torch

    args, kw, (before, after), out, secs = call
    gen = _generator_of(args, kw)
    now = gen.get_state()
    gen.set_state(before)
    _sync()
    t0 = time.perf_counter()
    want = eager(*args, **kw)
    _sync()
    eager_s = time.perf_counter() - t0
    drawn = torch.equal(gen.get_state(), after)
    gen.set_state(now)
    _check(drawn, f"{what}: the eager loop draws as many numbers")
    _check(_bitwise([out], [want]), f"{what}: the graphed loop == the eager loop, bitwise")
    return secs, eager_s


def _sync() -> None:
    import torch

    if torch.device(DEVICE).type == "cuda":
        torch.cuda.synchronize()


def _generator_of(args, kw):
    import torch

    return next(x for x in (*args, *kw.values()) if isinstance(x, torch.Generator))


def eager_fold_in(phi, tok_v, tok_f, topic_mask, alpha, it: int, thinning: int, generator):
    """``models/labeled_lda.fold_in_test`` with eager ``foldin_sweep`` calls
    in place of ``FoldinSweep``: the reference of its replays."""
    import torch

    from lda_thesis_tpu_torch.models.labeled_lda import _fold_in_init
    from lda_thesis_tpu_torch.models.state import running_average
    from lda_thesis_tpu_torch.ops.gibbs import foldin_sweep

    D, U = tok_v.shape
    u = torch.rand((U, D), generator=generator, device=phi.device)
    z, n_dk = _fold_in_init(phi, tok_v, tok_f, topic_mask, u)
    avg, s = torch.zeros_like(n_dk), 0
    for i in range(int(it)):
        z, n_dk = foldin_sweep(z, n_dk, tok_v, tok_f, phi, alpha, generator=generator)
        if (i + 1) % int(thinning) == 0:
            s += 1
            cur = n_dk / torch.clamp(n_dk.sum(dim=1, keepdim=True), min=1.0)
            avg = running_average(avg, cur, s)
    return avg


def eager_test_loop(tok_v, mask, init_phi, sweep_phi, alpha_beta, it: int, thinning: int,
                    init_uniforms=None, sweep_uniforms=None, generator=None):
    """``models/hslda._test_loop`` with eager ``foldin_sweep`` calls in
    place of ``FoldinSweep``: the reference of its replays."""
    import torch

    from lda_thesis_tpu_torch.models.hslda import _test_init
    from lda_thesis_tpu_torch.models.state import running_average
    from lda_thesis_tpu_torch.ops.gibbs import foldin_sweep

    D, N = tok_v.shape
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    if init_uniforms is None:
        init_uniforms = torch.rand((N, D), generator=generator, device=tok_v.device)
    z, n_dk = _test_init(tok_v.long(), mask.to(torch.float32), init_phi, init_uniforms)
    avg, s = torch.zeros_like(n_dk), 0
    for i in range(int(it)):
        u = None if sweep_uniforms is None else sweep_uniforms[i]
        z, n_dk = foldin_sweep(z, n_dk, tok_v, mask, sweep_phi, alpha_beta, uniforms=u,
                               generator=generator)
        if (i + 1) % int(thinning) == 0:
            s += 1
            avg = running_average(avg, n_dk / n_d[:, None], s)
    return avg


def eager_cascade_loop(tok_v, tok_f, phi_vk, lab_ids, lab_mask, it: int, thinning: int,
                       alpha: float, beta: float, init_gumbels=None, sweep_gumbels=None,
                       generator=None):
    """``ops/gibbs.cascade_test_loop`` with eager ``cascade_sweep`` calls,
    each position's noise drawn where its draw is made, in place of
    ``CascadeSweep``: the reference of its replays."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import _cascade_init, cascade_sweep
    from lda_thesis_tpu_torch.ops.sampling import mask_to_logits

    z, n_dk = _cascade_init(tok_v.long(), tok_f.to(torch.float32), phi_vk, lab_ids.long(),
                            lab_mask, mask_to_logits(lab_mask), beta, init_gumbels, generator)
    avg, s = torch.zeros_like(n_dk), 0
    for i in range(int(it)):
        cascade_sweep(z, n_dk, tok_v, tok_f, phi_vk, lab_ids, lab_mask, alpha, beta,
                      gumbels=None if sweep_gumbels is None else sweep_gumbels[i],
                      generator=generator)
        if (i + 1) % int(thinning) == 0:
            s += 1
            cur = n_dk / torch.clamp(n_dk.sum(dim=1, keepdim=True), min=1.0)
            if s == 1:
                avg = cur
            else:
                s32 = np.float32(s)
                avg = float((s32 - np.float32(1.0)) / s32) * avg + cur / float(s32)
    return avg


def foldin_sweeps_case(z, n_dk, tok_v, tok_f, phi, alpha, seed: int, norm,
                       sweeps: int = LOOP_SWEEPS):
    """``sweeps`` fold-in sweeps from the state ``(z, n_dk)`` and one seed,
    through ``FoldinSweep`` (on a card replayed from its second call) and
    through eager ``foldin_sweep`` calls: z, n_dk and the running average of
    ``norm(n_dk)`` equal bit for bit after every sweep.  Returns the
    ``FoldinSweep`` and a function that makes one eager sweep."""
    import torch

    from lda_thesis_tpu_torch.models.state import running_average
    from lda_thesis_tpu_torch.ops.gibbs import FoldinSweep, foldin_sweep

    gens = [torch.Generator(device=z.device) for _ in range(2)]
    for g in gens:
        g.manual_seed(seed)
    run = FoldinSweep(z.clone(), n_dk.clone(), tok_v, tok_f, phi, alpha)
    avgs = [torch.zeros_like(n_dk)] * 2
    for i in range(sweeps):
        run(gens[0])
        z, n_dk = foldin_sweep(z, n_dk, tok_v, tok_f, phi, alpha, generator=gens[1])
        avgs = [running_average(a, norm(x), i + 1) for a, x in zip(avgs, (run.n_dk, n_dk))]
        _check(_bitwise([run.z, run.n_dk, avgs[0]], [z, n_dk, avgs[1]]),
               f"fold-in sweep {i + 1}: FoldinSweep == foldin_sweep (z, n_dk, average), "
               f"bitwise")
    return run, lambda: foldin_sweep(z, n_dk, tok_v, tok_f, phi, alpha, generator=gens[1])


FOLDIN_TIMED = 20  # fold-in sweeps per graph timed by _graph_ms


def foldin_bound(tv, tf, K: int) -> tuple:
    """The least time one fold-in sweep could take on an H100 (3.35 TB/s,
    67 TFLOP/s float32): bytes are each input read once and each output
    written once (z and n_dk read and written; the words, frequencies and
    uniforms; the φ rows of the distinct words at live positions), and
    operations 4·K + 1 a live position (n + α, the product, the scan's add
    and the comparison a topic; the threshold).  Returns (ms, "bytes" or
    "operations", live positions, most live positions of a document)."""
    import torch

    live = tf > 0
    D, U = tv.shape
    words = int(torch.unique(tv[live]).numel())
    nbytes = D * U * (4 + 4 + 8 + 4 + 4) + D * K * 4 * 2 + words * K * 4
    n_live = int(live.sum())
    ops = n_live * (4 * K + 1)
    by_bytes, by_ops = nbytes / 3.35e12, ops / 67e12
    return (max(by_bytes, by_ops) * 1e3, "bytes" if by_bytes >= by_ops else "operations",
            n_live, int(live.sum(dim=1).max()))


def foldin_kernel_case(z, n_dk, tok_v, tok_f, phi, alpha, seed: int) -> dict:
    """The fold-in kernel at one fold-in's inputs: device ms per sweep
    (``_graph_ms`` over ``FOLDIN_TIMED`` launches, the state advancing) and
    ns per live position of the longest document (the warp's serial chain);
    its bound (``foldin_bound``); the plain body's device ms per sweep,
    eager and replayed as one CUDA graph (the port's fold-in before the
    kernel); one kernel sweep against one plain sweep from the same state
    and uniforms, bitwise."""
    import torch

    from lda_thesis_tpu_torch.ops import foldin_cuda as fic
    from lda_thesis_tpu_torch.ops.gibbs import _foldin_positions

    D, U = tok_v.shape
    K = n_dk.shape[1]
    tv, ff = tok_v.long().contiguous(), tok_f.to(torch.float32).contiguous()
    phi = phi.contiguous()
    g = torch.Generator(device=z.device)
    g.manual_seed(seed)
    u = torch.rand((U, D), generator=g, device=z.device)
    got, want = [(z.clone(), n_dk.clone()) for _ in range(2)]
    fic.foldin_positions(*got, tv, ff, phi, alpha, u)
    _foldin_positions(*want, tv, ff, phi, alpha, u)
    _check(_bitwise(got, want), f"fold-in kernel == plain sweep at D={D}, U={U}, K={K}, "
                                f"bitwise")
    state = (z.clone(), n_dk.clone())
    ms = _graph_ms(lambda: fic.foldin_positions(*state, tv, ff, phi, alpha, u), FOLDIN_TIMED)
    plain_graph_ms = _graph_ms(lambda: _foldin_positions(*state, tv, ff, phi, alpha, u), 1)
    plain_ms = _batch_ms(lambda: _foldin_positions(*state, tv, ff, phi, alpha, u), 3)
    bound_ms, bound_by, n_live, longest = foldin_bound(tv, ff, K)
    return dict(shape=f"D={D}, U={U}, K={K}, lx={fic.scan_log_width(D, K)}", ms=ms,
                plain_ms=plain_ms, plain_graph_ms=plain_graph_ms, bound_ms=bound_ms,
                bound_by=bound_by, live_positions=n_live, longest_document=longest,
                ns_per_position=ms * 1e6 / max(longest, 1))


def _print_foldin_kernel(name: str, t: dict) -> None:
    print(f"fold-in kernel, {name} ({t['shape']}): kernel == plain sweep bitwise; "
          f"{t['ms']:.4f} ms per sweep ({t['ns_per_position']:.0f} ns per position of the "
          f"longest document, {t['longest_document']} live), bound {t['bound_ms']:.4f} ms "
          f"({t['bound_by']}, {t['live_positions']} live positions); plain body "
          f"{t['plain_ms']:.4f} ms eager, {t['plain_graph_ms']:.4f} ms as a graph")


def cascade_sweeps_case(tok_v, tok_f, phi_vk, lab_ids, lab_mask, alpha: float, beta: float,
                        seed: int, sweeps: int = LOOP_SWEEPS):
    """``sweeps`` cascade sweeps from one init and one seed, through
    ``CascadeSweep`` (its noise one ``gumbel(out=)`` per position into a
    static buffer; on a card replayed from its second call) and through
    eager ``cascade_sweep`` calls (each position's noise drawn where its
    draw is made): z and n_dk equal bit for bit after every sweep.  Returns
    the ``CascadeSweep`` and a function that makes one eager sweep."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import CascadeSweep, _cascade_init, cascade_sweep
    from lda_thesis_tpu_torch.ops.sampling import mask_to_logits

    gens = [torch.Generator(device=tok_v.device) for _ in range(3)]
    for g in gens:
        g.manual_seed(seed)
    tv, ff, ids = tok_v.long(), tok_f.to(torch.float32), lab_ids.long()
    z, n_dk = _cascade_init(tv, ff, phi_vk, ids, lab_mask, mask_to_logits(lab_mask), beta,
                            None, gens[2])
    run = CascadeSweep(z.clone(), n_dk.clone(), tv, ff, phi_vk, ids, lab_mask, alpha, beta)
    for i in range(sweeps):
        run(gens[0])
        cascade_sweep(z, n_dk, tok_v, tok_f, phi_vk, lab_ids, lab_mask, alpha, beta,
                      generator=gens[1])
        _check(_bitwise([run.z, run.n_dk], [z, n_dk]),
               f"cascade sweep {i + 1}: CascadeSweep == cascade_sweep (z, n_dk), bitwise")
    return run, lambda: cascade_sweep(z, n_dk, tok_v, tok_f, phi_vk, lab_ids, lab_mask, alpha,
                                      beta, generator=gens[1])


def loglik_case(model, rounds: int = 3) -> list:
    """``LogLikelihood`` of each bucket of ``model`` (a ``LabeledLDA``)
    against ``log_likelihood``, bit for bit, at ``rounds`` saves' estimates
    (more training between them: the static θ̂ and φ̂ take new values).
    Returns each bucket's ``LogLikelihood`` and a function that makes one
    eager sum on its last inputs."""
    from lda_thesis_tpu_torch.ops.gibbs import LogLikelihood, log_likelihood

    runs = [LogLikelihood(tv, tf) for tv, tf in zip(model.toks_v, model.toks_f)]
    for r in range(rounds):
        if r:
            model.run_training(TRAIN_ITERS, THINNING, perplexity=False, total_iters=TOTAL_ITERS)
        phi, thetas = model._cur_estimates()
        for g, (run, th) in enumerate(zip(runs, thetas)):
            got = run(th, phi)
            want = log_likelihood(th, phi, model.toks_v[g], model.toks_f[g])
            _check(_bitwise([got[0]], [want[0]]) and int(got[1]) == int(want[1]),
                   f"log-likelihood, bucket {g}, call {r + 1}: LogLikelihood == "
                   f"log_likelihood, bitwise")
    return [(run, (lambda g=g, th=th: log_likelihood(th, phi, model.toks_v[g],
                                                     model.toks_f[g])), (th, phi))
            for g, (run, th) in enumerate(zip(runs, thetas))]


def _loop_timing(run, eager, call, positions: int) -> dict:
    """Device ms per sweep of a graphed loop: eager sweeps, calls of the
    graphed class (its static inputs filled, then the replay) and replays
    alone, each from CUDA events around ``LOOP_SWEEPS`` made back to back;
    and the nodes of the sweep's graph."""
    _check(run._graph is not None, "the loop replays a captured graph")
    kept = dict(run.__dict__)  # a capture may rebind what the sweep writes
    nodes = _captured_nodes(run._sweep)
    run.__dict__.update(kept)
    return dict(eager_ms=_batch_ms(eager, LOOP_SWEEPS), call_ms=_batch_ms(call, LOOP_SWEEPS),
                replay_ms=_batch_ms(run._graph.replay, LOOP_SWEEPS), graph_nodes=nodes,
                nodes_per_position=nodes / positions)


def _print_loop(name: str, shape: str, t: dict) -> None:
    print(f"compiled loops, {name} ({shape}): graphed == eager bitwise; {t['graph_nodes']} "
          f"graph nodes ({t['nodes_per_position']:.2f} per position); device ms per sweep: "
          f"eager {t['eager_ms']:.4f}, graphed call {t['call_ms']:.4f} (replay alone "
          f"{t['replay_ms']:.4f}), {t['eager_ms'] / t['call_ms']:.2f}x")


def _loop_line(loop_s, schedule=LOOP_TEST) -> str:
    return (f"the model's loop calls at ({schedule[0]}; {schedule[1]}), seconds graphed "
            f"against eager: " + ", ".join(f"{a:.4f} / {b:.4f}" for a, b in loop_s))


def compiled_loops_phase(seed: int, corpus, dicti, cascade_model, jel) -> dict:
    """The test-time position loops as replayed CUDA graphs (phase 15),
    each at full width against its eager loop, bit for bit: the
    Labeled-LDA fold-in on the planted corpus's test split (D = 464,
    U = 128, Kp = 512), HSLDA's at phase 12's width (N = 192, K = 15) at
    C = 1 and C = 8 chains, CascadeLDA's ``test_down_tree_batch`` (4; 2) on
    the JEL tree, and the log-likelihood of each bucket of the planted
    corpus; a second ``run_test`` after more training folds in against
    the new φ̂.  Each loop's graph nodes and device ms per sweep, eager and
    replayed."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.models import cascade_lda, hslda, labeled_lda
    from lda_thesis_tpu_torch.models.hslda import HSLDA, _test_init
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA, _fold_in_init
    from lda_thesis_tpu_torch.ops import foldin_cuda as fic

    rec = {"card": _card_line()}
    it, thinning = LOOP_TEST

    # a. Labeled LDA: fold_in_test, then again after more training
    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, dicti,
                       alpha=0.1, beta=0.01, seed=seed, device=DEVICE)
    model.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS)
    before = fic.launches
    with _recording(labeled_lda, "fold_in_test") as calls:
        first = model.run_test(corpus.test_docs, it, thinning)
        model.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS)
        second = model.run_test(corpus.test_docs, it, thinning)
    rec["foldin_launches"] = fic.launches - before
    _check(rec["foldin_launches"] == 2 * it,
           f"two run_test calls at it = {it}: one fold-in kernel launch a sweep "
           f"({rec['foldin_launches']})")
    loop_s = [_same_as_eager(eager_fold_in, call, f"Labeled-LDA fold-in, run_test {n + 1}")
              for n, call in enumerate(calls)]
    _check(torch.equal(calls[1][0][0], model.ph_hat)
           and not torch.equal(calls[0][0][0], calls[1][0][0])
           and not np.array_equal(first, second),
           "the second run_test folds in against the new φ̂ (another θ̂)")
    phi, tv, tf, mask, alpha = calls[1][0][:5]
    D, U = tv.shape
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    z, n_dk = _fold_in_init(phi, tv, tf, mask, torch.rand((U, D), generator=g, device=DEVICE))
    run, eager = foldin_sweeps_case(
        z, n_dk, tv, tf, phi, alpha, seed,
        lambda x: x / torch.clamp(x.sum(dim=1, keepdim=True), min=1.0))
    t = _loop_timing(run, eager, lambda: run(g), U)
    shape = f"D={D}, U={U}, Kp={phi.shape[1]}"
    _print_loop("Labeled-LDA fold-in", shape, t)
    rec["labeled_foldin_kernel"] = foldin_kernel_case(z, n_dk, tv, tf, phi, alpha, seed)
    _print_foldin_kernel("Labeled-LDA fold-in", rec["labeled_foldin_kernel"])
    print(f"  run_test after {TRAIN_ITERS} more sweeps folds in against the new φ̂: equal to "
          f"a fresh eager fold-in, bitwise, and unlike the first run_test; {_loop_line(loop_s)}")
    rec["labeled_foldin"] = dict(t, shape=shape, stale_phi_check=True, loop_s=loop_s)
    del run, eager

    # b. the log-likelihood of each bucket
    per_bucket = []
    for g_, (run, eager, inputs) in enumerate(loglik_case(model)):
        t = _loop_timing(run, eager, lambda: run(*inputs), int(model.toks_v[g_].shape[1]))
        _print_loop(f"log-likelihood, bucket {g_}", f"D={inputs[0].shape[0]}, "
                    f"U={model.toks_v[g_].shape[1]}, Kp={model.Kp}", t)
        per_bucket.append(t)
    rec["loglik"] = per_bucket
    del model, per_bucket

    # c. HSLDA at phase 12's width, one chain and eight
    hjel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    for C in (1, 8):
        if C == 1:
            m = HSLDA(hjel.train_docs, hjel.train_labs, hjel.labelset, k=HSLDA_K, seed=seed,
                      device=DEVICE)
        else:
            m = _hslda_model(hjel.train_docs, hjel.train_labs, hjel.labelset, seed, C, DEVICE,
                             HSLDA_K)
        m.run_training(it=LOOP_CYCLES, thinning=1)
        with _recording(hslda, "_test_loop") as calls:
            scores = m.run_tests(hjel.test_docs, it=it, s=thinning)
        _check(len(calls) == 1 and bool(np.isfinite(scores).all()),
               f"HSLDA C={C}: one fold-in for every chain, finite scores")
        loop_s = [_same_as_eager(eager_test_loop, calls[0], f"HSLDA fold-in, C={C}")]
        tv, mask, init_phi, sweep_phi, ab = calls[0][0][:5]
        D, N = tv.shape
        g = torch.Generator(device=DEVICE)
        g.manual_seed(seed)
        z, n_dk = _test_init(tv.long(), mask.to(torch.float32), init_phi,
                             torch.rand((N, D), generator=g, device=DEVICE))
        n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
        run, eager = foldin_sweeps_case(z, n_dk, tv, mask, sweep_phi, ab, seed,
                                        lambda x: x / n_d[:, None])
        t = _loop_timing(run, eager, lambda: run(g), N)
        shape = f"C={C}, rows C*D={D}, N={N}, K={init_phi.shape[1]}, alpha*beta {tuple(ab.shape)}"
        _print_loop("HSLDA fold-in", shape, t)
        rec[f"hslda_foldin_kernel_c{C}"] = foldin_kernel_case(z, n_dk, tv, mask, sweep_phi, ab,
                                                              seed)
        _print_foldin_kernel(f"HSLDA fold-in, C={C}", rec[f"hslda_foldin_kernel_c{C}"])
        print(f"  {_loop_line(loop_s)}")
        rec[f"hslda_foldin_c{C}"] = dict(t, shape=shape, loop_s=loop_s)
        del m, run, eager

    # d. CascadeLDA's test, (4; 2) on the JEL tree
    with _recording(cascade_lda, "cascade_test_loop") as calls:
        cascade_model.test_down_tree_batch(jel.test_docs, CASCADE_IT, CASCADE_S)
    loop_s = [_same_as_eager(eager_cascade_loop, call, f"cascade test loop, call {n + 1}")
              for n, call in enumerate(calls)]
    args, kw = max(calls, key=lambda c: c[0][0].numel() * c[0][3].shape[1])[:2]
    run, eager = cascade_sweeps_case(*args, kw["alpha"], kw["beta"], seed)
    g = torch.Generator(device=DEVICE)
    g.manual_seed(seed)
    R, U = args[0].shape
    t = _loop_timing(run, eager, lambda: run(g), U)
    shape = f"R={R}, U={U}, Kt={args[3].shape[1]}; {len(calls)} calls"
    _print_loop("CascadeLDA test loop", shape, t)
    print(f"  {_loop_line(loop_s, (CASCADE_IT, CASCADE_S))}")
    rec["cascade"] = dict(t, shape=shape, loop_s=loop_s)
    return rec


# ---------------------------------------------------------------- training graphs

TG_CALLS = 2  # run_training calls of each setting held to the eager loop
TG_LOCAL = (20, 10)  # LocalLDA (iters; thinning) of the phase, M = 1: 20 blocks a call
TG_CHAINS = 8  # a rank's chains, with 4 buckets
TG_TIMED = 5  # merge blocks or sweeps timed back to back
# edge_cases of each route of kernel 1: staged, warp, wide, general
TG_ROUTES = ("interior gaps", "A=56", f"A={32 * 8 + 8}", "A=16000")
TG_DENSE = (10, 5)  # (iters; thinning) of the dense Labeled-LDA and AD-LDA calls
DIVISOR_SAVES = 50  # saves of the divisor check
ALPHA_TG, BETA_TG = 0.1, 0.01


def _copy_generator(gen):
    import torch

    twin = torch.Generator(device=gen.device)
    twin.set_state(gen.get_state())
    return twin


def _state_copy(state):
    """A copy of a state tuple whose fields are tensors or tuples of them."""
    return type(state)(*(tuple(t.clone() for t in part) if isinstance(part, tuple)
                         else part.clone() for part in state))


def _flat(state) -> list:
    return [*state.z, *state.n_dk, state.n_vk, state.n_k]


def eager_training(model, iters: int, thinning: int, total_iters=None,
                   perplexity: bool = False, continue_avg: bool = False) -> dict:
    """``run_training`` of a ``LabeledLDA`` (fused, dense or compact) or a
    ``LocalLDA`` (fused or dense) from its current state as eager calls of
    the functional sweeps: each merge block one ``fused_train_block_buckets``,
    each exact sweep of a bucket one ``exact_sweep`` or ``compact_sweep``,
    drawing from a copy of the model's generator; each save's estimates,
    thinned means (``running_average``; with ``continue_avg``, a
    ``LabeledLDA``'s means and save count carried on) and perplexity sums
    as functional calls.  The reference of the replayed training loops; the
    model is left as it was.  Returns the state, the thinned means ``ph (V,
    Kp)`` and ``th`` (per bucket), the positive perplexities and the
    generator's state after."""
    import torch

    from lda_thesis_tpu_torch.models.state import (
        phi_from_counts,
        running_average,
        theta_from_counts,
    )
    from lda_thesis_tpu_torch.ops.gibbs import (
        compact_sweep,
        exact_sweep,
        live_rows,
        log_likelihood,
        theta_from_compact,
    )
    from lda_thesis_tpu_torch.ops.gibbs_fused import (
        fused_train_block_buckets,
        select_merge_block,
        theta_from_fused,
    )

    alpha, beta = (model.alpha, model.beta) if hasattr(model, "alpha") else (model.a, model.b)
    gen = _copy_generator(model._gen)
    st = _state_copy(model.counts)
    G, dev = model.buckets.n_buckets, model.device
    z_t = None
    if model.sweep == "fused":
        merge = select_merge_block(model.merge_every, thinning, total_iters or iters)

        def theta(g):
            return theta_from_fused(st.n_dk[g], model.lab_ids_t[g], model.lab_valid_t[g],
                                    alpha, model.Kp)

        def block(st, m):
            return fused_train_block_buckets(st, model._toks_v_t, model._toks_f_t,
                                             model.lab_ids_t, model._lab_valid_tt, alpha, beta,
                                             m, generator=gen)
    else:
        _check(model.sweep in ("dense", "compact"), f"eager_training runs no {model.sweep!r} sweep")
        merge = 1
        z_t = [z.T.clone(memory_format=torch.contiguous_format) for z in st.z]
        vbeta = float(model.V * beta)
        live = [live_rows(tv, tf) for tv, tf in zip(model._toks_v_t, model._toks_f_t)]

        def theta(g):
            if model.sweep == "dense":
                return theta_from_counts(st.n_dk[g], model.labs_t[g], alpha)
            return theta_from_compact(st.n_dk[g], model.lab_ids_t[g], model.lab_valid_t[g],
                                      alpha, model.Kp)

        def block(st, m):
            for _ in range(m):
                for g in range(G):
                    tv, tf = model._toks_v_t[g], model._toks_f_t[g]
                    u = torch.rand(tuple(tv.shape), generator=gen, device=dev)
                    if model.sweep == "dense":
                        exact_sweep(z_t[g], st.n_dk[g], st.n_vk, st.n_k, tv, tf,
                                    model.labs_t[g], alpha, beta, vbeta, u, live=live[g])
                    else:
                        z_t[g] = compact_sweep(z_t[g], st.n_dk[g], st.n_vk, st.n_k, tv, tf,
                                               model.lab_ids_t[g], model.lab_valid_t[g], alpha,
                                               beta, vbeta, u)
            return st
    carried = continue_avg and getattr(model, "_avg_s", 0) > 0
    if carried:
        ph, th, s0 = model.ph_hat.clone(), [t.clone() for t in model._th_hat_t], model._avg_s
    else:
        ph = torch.zeros((model.V, model.Kp), dtype=torch.float32, device=dev)
        th = [torch.zeros((len(ix), model.Kp), dtype=torch.float32, device=dev)
              for ix in model.buckets.doc_idx]
        s0 = 0
    perps = []
    n_save = iters // thinning
    for s in range(s0 + 1, s0 + n_save + 1):
        for _ in range(thinning // merge):
            st = block(st, merge)
        cur_ph = phi_from_counts(st.n_vk, st.n_k, beta, model.topic_mask)
        cur_th = [theta(g) for g in range(G)]
        ph = running_average(ph, cur_ph, s)
        th = [running_average(t, c, s) for t, c in zip(th, cur_th)]
        if perplexity:
            ll = torch.zeros((), dtype=torch.float32, device=dev)
            n = torch.zeros((), dtype=torch.float32, device=dev)
            for g in range(G):
                llg, ng = log_likelihood(cur_th[g], cur_ph, model.toks_v[g], model.toks_f[g])
                ll, n = ll + llg, n + ng.to(torch.float32)
            perps.append(float(torch.exp(-ll / torch.clamp(n, min=1.0))))
    left = iters - n_save * thinning
    while left > 0:
        st = block(st, min(merge, left))
        left -= min(merge, left)
    if z_t is not None:
        st = st._replace(z=tuple(z.T.contiguous() for z in z_t))
    return dict(state=st, ph=ph, th=th, perplexities=[p for p in perps if p > 0],
                generator=gen.get_state())


def training_equal(model, want: dict, perps_before: int = 0) -> bool:
    """Whether ``model`` after a ``run_training`` call holds ``want``
    (``eager_training`` from the state before it) bit for bit: z, n_dk,
    n_vk, n_k, φ̂, θ̂, the call's perplexities and the generator's state."""
    import torch

    same = (_bitwise(_flat(model.counts), _flat(want["state"]))
            and torch.equal(model._gen.get_state(), want["generator"]))
    if hasattr(model, "_th_hat_t"):  # LabeledLDA: the means on the device
        return (same and _bitwise([model.ph_hat, *model._th_hat_t], [want["ph"], *want["th"]])
                and model.cur_perplx[perps_before:] == want["perplexities"])
    ph = want["ph"][:, : model.K].T.cpu().numpy()
    th = model.buckets.scatter_rows([t.cpu().numpy() for t in want["th"]])[:, : model.K]
    return (same and model.ph_hat.dtype == ph.dtype and np.array_equal(model.ph_hat, ph)
            and np.array_equal(model.th_hat, th))


def eager_chains_training(model, iters: int, thinning: int, total_iters=None) -> dict:
    """``DistributedLabeledLDA.run_training`` of one rank in the replicated
    bucketed layout as eager calls of ``fused_train_block_buckets`` over the
    chain axis (no data row to merge over), from copies of its state and
    generators, the saves as the trainer's loop makes them.  The model is
    left as it was; returns the state fields and the generators' states."""
    from lda_thesis_tpu_torch.models.state import running_average
    from lda_thesis_tpu_torch.ops.gibbs_fused import (
        FusedBucketState,
        fused_train_block_buckets,
        select_merge_block,
    )
    from lda_thesis_tpu_torch.parallel._util import dispatch_chunks
    from lda_thesis_tpu_torch.parallel.fused_sharded import theta_chains, train_blocks
    from lda_thesis_tpu_torch.parallel.sharded import phi_chains

    _check(model.mesh.shape["data"] == 1 and model.n_buckets > 1,
           "eager_chains_training: one data shard, buckets")
    s, corpora = model.state, model.corpus
    gens = [_copy_generator(g) for g in model._gens]
    M = select_merge_block(model.merge_every, thinning, total_iters or iters)
    V, K = s.n_vk.shape[1:]
    vbeta = float(V) * float(model.beta)
    inputs = ([c.tok_v_t for c in corpora], [c.tok_f_t for c in corpora],
              [c.lab_ids for c in corpora], [c.lab_valid_t for c in corpora])
    box = [_state_copy(FusedBucketState(s.z, s.n_dk, s.n_vk, s.n_k)),
           s.ph_hat.clone(), tuple(t.clone() for t in s.th_hat), s.s]

    def block(m):
        box[0] = fused_train_block_buckets(box[0], *inputs, model.alpha, model.beta, m,
                                           generator=gens, vbeta=vbeta)

    def save():
        st, n = box[0], box[3] + 1
        cur_ph = phi_chains(st.n_vk, st.n_k, model.beta, vbeta, model.topic_mask)
        box[2] = tuple(running_average(t, theta_chains(nd, c, model.alpha, K), n)
                       for t, nd, c in zip(box[2], st.n_dk, corpora))
        box[1], box[3] = running_average(box[1], cur_ph, n), n

    for step in dispatch_chunks(int(iters), int(thinning)):
        train_blocks(block, save, step, int(thinning), M)
    st = box[0]
    return dict(tensors=[*st.z, *st.n_dk, st.n_vk, st.n_k, box[1], *box[2]], s=box[3],
                generators=[g.get_state() for g in gens])


def eager_dense_chains_training(model, iters: int, thinning: int) -> dict:
    """``DistributedLabeledLDA.run_training`` of one rank in the dense
    AD-LDA layout (``sweep="dense"``) as eager calls: each sweep one
    ``exact_sweep`` over the chain axis, chain c's uniforms from a copy of
    its generator; each save every chain's φ (``phi_chains``) and θ
    (``theta_from_counts`` over the chain axis) folded in by
    ``running_average``.  The model is left as it was; returns what
    :func:`chains_equal` reads."""
    import torch

    from lda_thesis_tpu_torch.models.state import running_average, theta_from_counts
    from lda_thesis_tpu_torch.ops.gibbs import exact_sweep, live_rows
    from lda_thesis_tpu_torch.parallel.sharded import phi_chains

    _check(model.mesh.shape["data"] == 1 and model.sweep == "dense",
           "eager_dense_chains_training: one data shard, the dense layout")
    s, c = model.state, model.corpus
    gens = [_copy_generator(g) for g in model._gens]
    tv_t = c.tok_v.T.contiguous()
    tf_t = c.tok_f.T.to(torch.float32).contiguous()
    live = live_rows(tv_t, tf_t)
    z_t = s.z.transpose(1, 2).contiguous()
    n_dk, n_vk, n_k = s.n_dk.clone(), s.n_vk.clone(), s.n_k.clone()
    ph, th, n = s.ph_hat.clone(), s.th_hat.clone(), s.s
    vbeta = float(n_vk.shape[1] * model.beta)
    u = torch.empty(tuple(z_t.shape), dtype=torch.float32, device=z_t.device)
    for i in range(int(iters)):
        for uc, gen in zip(u, gens):
            torch.rand(tuple(uc.shape), generator=gen, out=uc)
        exact_sweep(z_t, n_dk, n_vk, n_k, tv_t, tf_t, c.labs, model.alpha, model.beta, vbeta,
                    u, live=live)
        if (i + 1) % int(thinning) == 0:
            n += 1
            ph = running_average(ph, phi_chains(n_vk, n_k, model.beta, vbeta,
                                                model.topic_mask), n)
            th = running_average(th, theta_from_counts(n_dk, c.labs, model.alpha), n)
    return dict(tensors=[*z_t.transpose(1, 2), *n_dk, n_vk, n_k, ph, *th], s=n,
                generators=[g.get_state() for g in gens])


def chains_equal(model, want: dict) -> bool:
    import torch

    s = model.state
    return (_bitwise([*s.z, *s.n_dk, s.n_vk, s.n_k, s.ph_hat, *s.th_hat], want["tensors"])
            and s.s == want["s"]
            and all(torch.equal(g.get_state(), w)
                    for g, w in zip(model._gens, want["generators"], strict=True)))


def fused_problem(device, seed: int, D: int, U: int, A: int, n_buckets: int = 2):
    """A merge-block problem of ``n_buckets`` buckets of ``D`` documents
    (``U`` type positions, a share of them f = 0) and ``A`` label slots
    over ``A + 8`` topics, every slot valid; the state drawn from ``seed``.
    Returns ``(state, toks_v_t, toks_f_t, lab_ids_t, lab_valid_tt)``."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs_fused import init_fused_buckets

    rng = np.random.default_rng(seed)
    K, V = A + 8, 3 * U + 40
    parts = []
    for g in range(n_buckets):
        tok_v = rng.integers(0, V, size=(D, U))
        tok_f = rng.integers(1, 4, size=(D, U)) * (rng.random((D, U)) > 0.3)
        lab_ids = np.sort(np.stack([rng.choice(K, A, replace=False) for _ in range(D)]), axis=1)
        parts.append([torch.from_numpy(np.ascontiguousarray(x)).to(device)
                      for x in (tok_v, tok_f, lab_ids, np.ones((D, A), np.float32))])
    tv, tf, li, lv = (list(x) for x in zip(*parts))
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    state = init_fused_buckets(tv, tf, li, lv, V, K, generator=gen)
    return (state, [t.T.contiguous() for t in tv], [t.T.to(torch.float32).contiguous()
                                                    for t in tf],
            li, [t.T.contiguous() for t in lv])


def replayed_blocks_case(device, seed: int, name: str, calls: int = 3, chains: int = 0,
                         M: int = 2) -> dict:
    """``calls`` merge blocks of ``FusedBlocks`` (on a card: eager, capture
    and replay, replays) over a problem at the ``(D, U, A)`` of
    ``edge_cases()[name]`` against as many chained eager
    ``fused_train_block_buckets`` calls from one seed, bitwise after each;
    with ``chains``, that many chains, one generator each.  Returns the
    runner, the route of its launches (by the counters) and the launches
    the calls counted."""
    import torch

    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.ops.gibbs_fused import FusedBlocks, fused_train_block_buckets

    D, U, A = edge_cases()[name][:3]
    state, *inputs = fused_problem(device, seed, D, U, A)
    if chains:
        state = type(state)(*(tuple(t.expand(chains, *t.shape).clone() for t in part)
                              if isinstance(part, tuple)
                              else part.expand(chains, *part.shape).clone()
                              for part in state))

    def generators():
        gens = [torch.Generator(device=device) for _ in range(max(chains, 1))]
        for j, g in enumerate(gens):
            g.manual_seed(seed + 100 + j)
        return gens if chains else gens[0]

    run = FusedBlocks(state, *inputs, ALPHA_TG, BETA_TG)
    gen, twin = generators(), generators()
    before = _route_counts(fbc)
    for i in range(calls):
        got = run(M, generator=gen)
        counted = _route_counts(fbc)
        state = fused_train_block_buckets(state, *inputs, ALPHA_TG, BETA_TG, M, generator=twin)
        _set_route_counts(fbc, counted)  # eager: not counted
        _check(got is run.state and _bitwise(_flat(got), _flat(state)),
               f"replayed merge block {name}, chains {chains}, call {i + 1}: FusedBlocks == "
               f"fused_train_block_buckets, bitwise")
    moved = tuple(a - b for a, b in zip(_route_counts(fbc), before))
    return dict(run=run, route=_route_of(moved), launches=moved, shape=(D, U, A))



def _runners(model) -> list:
    """The kept training runners (``ops/gibbs._Replayed``) of ``model``: a
    ``LabeledLDA``'s or ``LocalLDA``'s blocks or sweeps and saves, one
    rank's of a ``DistributedLabeledLDA`` (replicated layouts), an
    ``HSLDA``'s cycle and save runners, or those of each of a
    ``DistributedHSLDA``'s loops (data axis 1, replicated table)."""
    if hasattr(model, "_loops"):  # DistributedHSLDA
        runs = [r for loop in model._loops.values() for r in (loop._run, loop._saves)]
    elif hasattr(model, "_cycle"):  # HSLDA
        runs = (model._cycle, model._save)
    elif hasattr(model, "mesh"):
        loop = model._loop
        runs = (() if loop is None else (loop._sweep, loop._saves) if model.sweep == "dense"
                else (loop.blocks.run, loop.blocks.saves))
    else:
        runs = (model._fused, *(model._exact.runs if model._exact else ()), model._save)
    return [r for r in runs if r is not None]


def replay_counts(model) -> tuple:
    """(graphs captured, bodies run eagerly) so far by ``model``'s kept
    runners: on a card each key's first call runs its body eagerly and its
    second captures it."""
    runs = _runners(model)
    return sum(len(r._graphs) for r in runs), sum(len(r._key_calls) for r in runs)


def _tg_call(model, train, eager, what: str, launches: int, kernel2=None,
             warm: bool = False) -> dict:
    """One ``run_training`` call (``train``) held to its eager loop
    (``eager``, run first from the same state): bitwise, with ``launches``
    kernel-1 launches counted in the call and, given ``kernel2``, that many
    (draw, commit) launches of kernel 2; with ``warm`` (a model's call after
    one of the same settings), no graph captured and no body run eagerly.
    Returns the seconds of both (host clock, synchronized), the call's
    kernel-1 launches by route (all, warp, general) and its captures and
    eager bodies."""
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    perps = len(getattr(model, "cur_perplx", ()))
    _sync()
    t0 = time.perf_counter()
    want = eager()
    _sync()
    eager_s = time.perf_counter() - t0
    before, k2, runs = _route_counts(fbc), (duc.launches, duc.commit_launches), replay_counts(model)
    t0 = time.perf_counter()
    train()
    _sync()
    train_s = time.perf_counter() - t0
    counted = [a - b for a, b in zip(_route_counts(fbc), before)]
    _check(counted[0] == launches, f"{what}: kernel-1 launches {counted[0]} == {launches}")
    k2 = (duc.launches - k2[0], duc.commit_launches - k2[1])
    if kernel2 is not None:
        _check(k2 == tuple(kernel2), f"{what}: kernel-2 launches {k2} == {tuple(kernel2)}")
    fresh = [a - b for a, b in zip(replay_counts(model), runs)]
    if warm:
        _check(fresh == [0, 0], f"{what}: no graph captured and no body run eagerly ({fresh})")
    same = (hslda_training_equal(model, want) if hasattr(model, "_cycle")
            else chains_equal(model, want) if hasattr(model, "mesh")
            else training_equal(model, want, perps))
    _check(same, f"{what}: the replayed run == the eager loop, bitwise (z, n_dk, n_vk, n_k, "
                 f"φ̂, θ̂, perplexities, generator)")
    return dict(train_s=train_s, eager_s=eager_s, launches=counted, kernel2=list(k2),
                captures=fresh[0], eager_bodies=fresh[1], warm=warm)


def _host_ms(fn, reps: int) -> float:
    """Host-clock ms per call of ``fn`` over ``reps`` calls made back to
    back, each returning before the device finishes: the host's time to
    enqueue one call, where the device keeps up."""
    import torch

    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    return 1e3 * host / reps


def _tg_block_timing(run, eager_block, M: int, gen) -> dict:
    """Device ms per merge block from CUDA events around ``TG_TIMED`` blocks
    made back to back: eager ``fused_train_block_buckets`` calls, runner
    calls (uniforms drawn, then the replay) and replays alone; the host's
    ms to enqueue an eager block and a runner call (``_host_ms``); and the
    nodes of the block's graph.  The kernel counters are left as they
    were."""
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    _check(M in run._graphs, f"the merge block of M = {M} replays a captured graph")
    counts = _route_counts(fbc)
    out = dict(graph_nodes=_captured_nodes(lambda: run._body(run._u[M])),
               eager_ms=_batch_ms(eager_block, TG_TIMED),
               call_ms=_batch_ms(lambda: run(M, generator=gen), TG_TIMED),
               replay_ms=_batch_ms(run._graphs[M][0].replay, TG_TIMED),
               eager_host_ms=_host_ms(eager_block, TG_TIMED),
               call_host_ms=_host_ms(lambda: run(M, generator=gen), TG_TIMED))
    _set_route_counts(fbc, counts)
    buckets = len(run._inputs[0])
    _check(out["graph_nodes"] >= buckets,
           f"a merge block's graph holds {out['graph_nodes']} nodes, at least its {buckets} "
           f"kernel-1 launches")
    return out


def _tg_profile(train, tokens: int) -> dict:
    """One training call under torch.profiler: wall, busy, idle share and
    tokens/s (``tokens`` resampled by the call)."""
    prof = _profile(train)
    return dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                idle_share=prof["idle_share"], tokens_per_s=tokens / (prof["wall_ms"] / 1e3))


def _tg_print(name: str, r: dict) -> None:
    t = r["block"]
    print(f"training graphs, {name}: {len(r['calls'])} calls replayed == eager loop, bitwise; "
          f"{t['graph_nodes']} graph nodes a block; device ms per block eager "
          f"{t['eager_ms']:.4f}, runner call {t['call_ms']:.4f} (replay alone "
          f"{t['replay_ms']:.4f}); host ms to enqueue a block eager {t['eager_host_ms']:.4f}, "
          f"a runner call {t['call_host_ms']:.4f}; peak {r['peak_gb']:.2f} GB")
    if "save_ms" in r:
        print(f"  a save's estimates (phi, theta of every bucket): device ms {r['save_ms']:.4f}, "
              f"host ms to enqueue {r['save_host_ms']:.4f}")
    for key, p in r.items():
        if key.startswith("profile"):
            print(f"  {key}: {p['tokens_per_s']:.4g} tokens/s, wall {p['wall_ms']:.3f} ms, "
                  f"busy {p['busy_ms']:.3f} ms, idle share {p['idle_share']:.4f}")


def compact_sweeps_case(model, seed: int) -> list:
    """Per bucket of ``model`` (a compact ``LabeledLDA``): 3 ``CompactSweep``
    calls (eager, capture and replay, replay) over a copy of its state
    against 3 ``compact_sweep`` calls from one seed, bitwise after each; then
    the sweep graph's nodes and device ms per sweep, eager, runner call and
    replay alone (CUDA events around ``TG_TIMED`` sweeps)."""
    import torch

    from lda_thesis_tpu_torch.ops.gibbs import CompactSweep, compact_sweep

    out = []
    for g in range(model.buckets.n_buckets):
        st = model.counts
        z_t = st.z[g].T.clone(memory_format=torch.contiguous_format)
        args = (model._toks_v_t[g], model._toks_f_t[g], model.lab_ids_t[g],
                model.lab_valid_t[g], model.alpha, model.beta, float(model.V * model.beta))
        mine = [st.n_dk[g].clone(), st.n_vk.clone(), st.n_k.clone()]
        ref = [x.clone() for x in mine]
        run = CompactSweep(z_t.clone(), *mine, *args)
        gens = [torch.Generator(device=DEVICE) for _ in range(2)]
        for gen in gens:
            gen.manual_seed(seed + g)
        for i in range(3):
            run(gens[0])
            u = torch.rand(tuple(z_t.shape), generator=gens[1], device=DEVICE)
            z_t = compact_sweep(z_t, *ref, *args, u)
            _check(_bitwise([run.z_t, *mine], [z_t, *ref]),
                   f"compact sweep, bucket {g}, call {i + 1}: CompactSweep == compact_sweep, "
                   f"bitwise")
        _check(run._graph is not None, f"compact sweep, bucket {g}: the sweep replays a graph")
        U = int(z_t.shape[0])
        box = [z_t]

        def eager():  # chained, so z and the counts stay consistent
            box[0] = compact_sweep(box[0], *ref, *args, u)

        out.append(dict(
            shape=tuple(z_t.shape), graph_nodes=_captured_nodes(run._sweep),
            eager_ms=_batch_ms(eager, TG_TIMED),
            call_ms=_batch_ms(lambda: run(gens[0]), TG_TIMED),
            replay_ms=_batch_ms(run._graph.replay, TG_TIMED), positions=U))
    return out


def _old_average(avg, cur, s: int):
    """The thinned mean as the port computed it before the save index went
    on the device: ``keep * avg + cur / float(s)`` with host numbers."""
    if s <= 1:
        return cur.clone()
    s32 = np.float32(s)
    return float((s32 - np.float32(1.0)) / s32) * avg + cur / float(s32)


def divisor_check(model, seed: int) -> dict:
    """Whether the thinned mean with its weights in device scalars
    (``running_average``, and ``running_average_`` in place) has the bits
    of the host-number form (:func:`_old_average`) on the card, at saves
    s = 1 … ``DIVISOR_SAVES`` of φ̂ (V, Kp) and every bucket's θ̂ of
    ``model`` (a fused ``LabeledLDA``), one merge block of its runner
    between saves (the model's chain moves on; its generator does not).
    Returns the count of elements whose bits differ at each s, by form."""
    import torch

    from lda_thesis_tpu_torch.models.labeled_lda import fused_blocks
    from lda_thesis_tpu_torch.models.state import (
        AverageWeights,
        running_average,
        running_average_,
    )

    run = fused_blocks(model, model.alpha, model.beta)
    gen = torch.Generator(device=DEVICE)
    gen.manual_seed(seed + 17)
    avgs, counts = None, {"functional": [], "in_place": []}

    def differ(a, b) -> int:
        return int((a.contiguous().view(torch.int32) != b.contiguous().view(torch.int32)).sum())

    for s in range(1, DIVISOR_SAVES + 1):
        run(THINNING, generator=gen)
        cur_ph, cur_th = model._cur_estimates()
        curs = [cur_ph, *cur_th]
        avgs = [torch.zeros_like(c) for c in curs] if avgs is None else avgs
        old = [_old_average(a, c, s) for a, c in zip(avgs, curs)]
        w = AverageWeights(DEVICE, s)
        counts["functional"].append(sum(differ(running_average(a, c, s), o)
                                        for a, c, o in zip(avgs, curs, old)))
        counts["in_place"].append(sum(differ(running_average_(a.clone(), c, w), o)
                                      for a, c, o in zip(avgs, curs, old)))
        avgs = old
    elements = sum(int(a.numel()) for a in avgs)
    same = not any(counts["functional"]) and not any(counts["in_place"])
    print(f"divisor check: keep·avg + cur·(1/s) with the weights in device scalars "
          f"{'==' if same else '!='} keep·avg + cur/float(s) bitwise at s = 1..{DIVISOR_SAVES} "
          f"on φ̂ and {len(avgs) - 1} buckets' θ̂ ({elements} elements a save); differing "
          f"elements by save: functional {counts['functional']}, in place "
          f"{counts['in_place']}")
    return dict(bitwise=same, saves=DIVISOR_SAVES, elements=elements, **counts)


def save_timing(model) -> dict:
    """The save step of ``model`` (a ``LabeledLDA`` whose saves replay
    graphs with perplexity off and on), on a copy of its means (a second
    ``SaveStep`` whose body runs eagerly): per setting, the nodes of the
    save's body, device ms per save of the eager body and of the model's
    runner call (weights refilled, then the replay; CUDA events around
    ``TG_TIMED`` saves made back to back) and the host's ms to issue each
    (``_host_ms``).  The model's means are the runner's and take the timed
    saves; a later call without ``continue_avg`` starts them anew."""
    from lda_thesis_tpu_torch.ops.gibbs import SaveStep

    run = model._save
    _check(set(run._graphs) == {False, True},
           "the saves replay a graph with perplexity off and on")
    probe = SaveStep(run.ph_hat, run.th_hat)
    probe._graphed = False
    out = {}
    for p in (False, True):
        loglik = model._perplexity_of if p else None

        def eager(loglik=loglik):
            probe(2, model._cur_estimates, loglik)

        def replayed(loglik=loglik):
            run(2, model._cur_estimates, loglik)

        out["perplexity_on" if p else "perplexity_off"] = dict(
            graph_nodes=_captured_nodes(lambda: probe._body(model._cur_estimates, loglik)),
            eager_ms=_batch_ms(eager, TG_TIMED), replay_ms=_batch_ms(replayed, TG_TIMED),
            eager_host_ms=_host_ms(eager, TG_TIMED), replay_host_ms=_host_ms(replayed, TG_TIMED))
    for key, t in out.items():
        print(f"  a save, {key.replace('_', ' ')}: {t['graph_nodes']} graph nodes; device ms "
              f"eager {t['eager_ms']:.4f}, replayed {t['replay_ms']:.4f}; host ms to issue "
              f"eager {t['eager_host_ms']:.4f}, replayed {t['replay_host_ms']:.4f}")
    return out


def merge_block_split(run, M: int) -> dict:
    """Where a replayed merge block's device time goes, at the runner's
    shapes: the block's nodes and device ms from one replay's profiler
    records (``_most_records``), beside the records of each step of
    ``fused_train_block`` run alone over the four buckets on the runner's
    static state and uniforms (``gather_cv``, the slot pick
    ``slot_totals``, kernel 1, ``_scatter_deltas``): records, nodes and
    device ms each.  The kernel counters are left as they were."""
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc
    from lda_thesis_tpu_torch.ops.gibbs_fused import (
        _scatter_deltas,
        fused_block,
        gather_cv,
        slot_totals,
    )

    st, (tvs, tfs, lis, lvs) = run.state, run._inputs
    alpha, beta = run._consts
    vbeta = float(st.n_vk.shape[-2]) * beta if run._vbeta is None else run._vbeta
    us = run._u[M]
    cvs = [gather_cv(st.n_vk, tv, li) for tv, li in zip(tvs, lis)]
    nkgs = [slot_totals(st.n_k, li, vbeta) for li in lis]
    counts = _route_counts(fbc)

    def kernel():
        return [fused_block(cv, tf, u, z, nkg, lv, nd, alpha, beta)
                for cv, tf, u, z, nkg, lv, nd in zip(cvs, tfs, us, st.z, nkgs, lvs, st.n_dk)]

    z1s = [z for z, _ in kernel()]
    steps = {
        "gather_cv": lambda: [gather_cv(st.n_vk, tv, li) for tv, li in zip(tvs, lis)],
        "slot_totals": lambda: [slot_totals(st.n_k, li, vbeta) for li in lis],
        "kernel 1": kernel,
        "_scatter_deltas": lambda: [_scatter_deltas(st.n_vk, tv, tf, li, z0, z1)
                                    for tv, tf, li, z0, z1 in zip(tvs, tfs, lis, st.z, z1s)],
    }
    out = {}
    for name, fn in steps.items():
        nodes = _captured_nodes(fn)
        records, ms = _most_records(fn, nodes)[""]
        out[name] = dict(nodes=nodes, records=records, device_ms=ms)
    graph = run._graphs[M][0]
    nodes = _captured_nodes(lambda: run._body(us))
    records, ms = _most_records(graph.replay, nodes)[""]
    out["replayed block"] = dict(nodes=nodes, records=records, device_ms=ms)
    _set_route_counts(fbc, counts)
    print("  a replayed merge block's device time by step (profiler records, "
          f"{len(tvs)} buckets): " + "; ".join(
              f"{name} {t['device_ms']:.4f} ms ({t['records']} records, {t['nodes']} nodes)"
              for name, t in out.items()))
    return out


def _tg_warm_line(calls: list) -> str:
    """The wall of the calls that followed one of the same settings, and
    their captures and eager bodies (zero each)."""
    warm = [c for c in calls if c["warm"]]
    return (f"a later call {min(c['train_s'] for c in warm):.4f} s wall, "
            f"{sum(c['captures'] for c in warm)} graphs captured and "
            f"{sum(c['eager_bodies'] for c in warm)} bodies run eagerly in "
            f"{len(warm)} later calls")


def training_graphs_phase(seed: int, corpus, dicti, card: str) -> dict:
    """The training loops as replayed CUDA graphs (phase 16), each at full
    width against its eager loop of functional calls, bit for bit, the
    saves replayed too: a replayed block on each of kernel 1's routes
    (``replayed_blocks_case`` at ``TG_ROUTES``' edge shapes); the divisor
    check (``divisor_check``); ``LabeledLDA`` fused (50; 25) with
    perplexity off and on, and a call that carries the means on; ``LocalLDA``
    at K = 20 (staged route) and K = 50 (warp route), fused, and dense, (20;
    10); one rank of ``TG_CHAINS`` chains with 4 buckets (50; 25) and of
    ``TG_CHAINS`` dense AD-LDA chains ``TG_DENSE``; ``LabeledLDA`` dense
    ``TG_DENSE`` and compact (10; 5).  A model's later calls of one setting
    capture no graph and run no body eagerly.  For each: the block's (or
    sweep's) graph nodes, device ms per block eager and replayed, tokens/s
    and the device's idle share of a profiled call, and peak device memory;
    for the fused path also a save's nodes and times, eager and replayed
    (``save_timing``), and a replayed block's device time by step
    (``merge_block_split``).  Last, HSLDA's (``hslda_training_graphs``)."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.models.local_lda import LocalLDA
    from lda_thesis_tpu_torch.ops.gibbs_fused import fused_train_block_buckets
    from lda_thesis_tpu_torch.parallel import make_mesh

    rec = {"card": card, "routes": {}}
    want_route = dict(zip(TG_ROUTES, ("staged", "warp", "wide", "general")))
    for name in TG_ROUTES:
        r = replayed_blocks_case(DEVICE, seed, name)
        _check(r["route"] == want_route[name] and r["launches"][0] == 3 * 2
               and r["run"]._graphs,
               f"replayed blocks {name}: 6 launches on the {want_route[name]} route "
               f"({r['route']}, {r['launches']})")
        rec["routes"][name] = dict(route=r["route"], launches=r["launches"], shape=r["shape"])
    print(f"training graphs: 3 replayed merge blocks == eager on each route of kernel 1: "
          f"{json.dumps(rec['routes'])}")

    def gen_of(chains=0):
        gens = [torch.Generator(device=DEVICE) for _ in range(max(chains, 1))]
        for j, g in enumerate(gens):
            g.manual_seed(seed + 7 + j)
        return gens if chains else gens[0]

    def labeled(**kw):
        return LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, dicti,
                          alpha=0.1, beta=0.01, seed=seed, device=DEVICE, **kw)

    def dense_plan(model, iters):
        plan = [planned_sweep_launches(tf) for tf in model._toks_f_t]
        return iters * sum(p[0] for p in plan), iters * sum(p[1] for p in plan)

    # the divisor check, on a model of its own
    probe = labeled(n_buckets=4)
    rec["divisor"] = divisor_check(probe, seed)
    del probe

    # Labeled LDA, fused (50; 25), perplexity off and on, then a call that
    # carries the means on
    torch.cuda.reset_peak_memory_stats()
    model = labeled(n_buckets=4)
    G, blocks = model.buckets.n_buckets, TRAIN_ITERS // 25
    calls = [_tg_call(model,
                      lambda p=p: model.run_training(TRAIN_ITERS, THINNING, perplexity=p,
                                                     total_iters=TOTAL_ITERS),
                      lambda p=p: eager_training(model, TRAIN_ITERS, THINNING, TOTAL_ITERS, p),
                      f"Labeled-LDA fused (50; 25), perplexity {p}, call {n + 1}", blocks * G,
                      warm=n > 0)
             for p in (False, True) for n in range(TG_CALLS)]
    calls.append(_tg_call(
        model, lambda: model.run_training(TRAIN_ITERS, THINNING, continue_avg=True,
                                          total_iters=TOTAL_ITERS),
        lambda: eager_training(model, TRAIN_ITERS, THINNING, TOTAL_ITERS, True,
                               continue_avg=True),
        "Labeled-LDA fused (50; 25), perplexity True, continue_avg", blocks * G, warm=True))
    _check(model._avg_s == 4, f"continue_avg carried the save count on ({model._avg_s})")
    run, M, st = model._fused, model._merge_M, _state_copy(model.counts)
    eager_gen = gen_of()
    r = dict(calls=calls, block=_tg_block_timing(
        run, lambda: fused_train_block_buckets(st, model._toks_v_t, model._toks_f_t,
                                               model.lab_ids_t, model._lab_valid_tt,
                                               model.alpha, model.beta, M,
                                               generator=eager_gen), M, gen_of()))
    r["save"] = save_timing(model)
    r["block_split"] = merge_block_split(run, M)
    tokens = model.n_tokens * TRAIN_ITERS
    for p in (False, True):
        r[f"profile_perplexity_{'on' if p else 'off'}"] = _tg_profile(
            lambda p=p: model.run_training(TRAIN_ITERS, THINNING, perplexity=p,
                                           total_iters=TOTAL_ITERS), tokens)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    r["graphs"] = sorted(run._graphs)
    _check_counts(model.counts, float(model.n_tokens), "training graphs, Labeled-LDA fused")
    _tg_print("Labeled-LDA fused (50; 25)", r)
    print(f"  Labeled-LDA fused (50; 25): {_tg_warm_line(calls)}")
    rec["labeled_fused"] = r
    del model, run, st
    torch.cuda.empty_cache()

    # LocalLDA at K = 20 (staged route) and K = 50 (warp route), (20; 10), M = 1,
    # and dense at K = 20
    local = planted_corpus(seed, V=LOCAL_V)
    texts = [" ".join(csv_word(int(w[1:])) for w in d)
             for d in local.train_docs + local.test_docs]
    iters, thinning = TG_LOCAL
    for K in (20, 50):
        torch.cuda.reset_peak_memory_stats()
        m = LocalLDA(texts, alpha=0.1, beta=0.01, K=K, seed=seed, device=DEVICE)
        calls = [_tg_call(m, lambda: m.run_training(iters, thinning),
                          lambda: eager_training(m, iters, thinning),
                          f"LocalLDA K = {K} ({iters}; {thinning}), call {n + 1}",
                          iters * m.buckets.n_buckets, warm=n > 0)
                 for n in range(TG_CALLS)]
        warp = sum(c["launches"][1] for c in calls)
        _check(warp == (TG_CALLS * iters if K > 32 else 0),
               f"LocalLDA K = {K}: {warp} warp-route launches")
        run, st = m._fused, _state_copy(m.counts)
        eager_gen = gen_of()
        r = dict(calls=calls, warp_launches=warp, block=_tg_block_timing(
            run, lambda: fused_train_block_buckets(st, m._toks_v_t, m._toks_f_t, m.lab_ids_t,
                                                   m._lab_valid_tt, m.a, m.b, 1,
                                                   generator=eager_gen), 1, gen_of()))
        r["profile"] = _tg_profile(lambda: m.run_training(iters, thinning),
                                   m.n_tokens * iters)
        r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        _check_counts(m.counts, float(m.n_tokens), f"training graphs, LocalLDA K = {K}")
        _tg_print(f"LocalLDA K = {K} (D={m.D}, A={m.A}, M = 1, ({iters}; {thinning}))", r)
        print(f"  LocalLDA K = {K}: {_tg_warm_line(calls)}")
        rec[f"local_k{K}"] = r
        del m, run, st
        torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    m = LocalLDA(texts, alpha=0.1, beta=0.01, K=20, seed=seed, sweep="dense", device=DEVICE)
    calls = [_tg_call(m, lambda: m.run_training(iters, thinning),
                      lambda: eager_training(m, iters, thinning),
                      f"LocalLDA dense K = 20 ({iters}; {thinning}), call {n + 1}", 0,
                      kernel2=dense_plan(m, iters), warm=n > 0)
             for n in range(TG_CALLS)]
    r = dict(calls=calls, profile=_tg_profile(lambda: m.run_training(iters, thinning),
                                              m.n_tokens * iters),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    _check_counts(m.counts, float(m.n_tokens), "training graphs, LocalLDA dense")
    p = r["profile"]
    print(f"training graphs, LocalLDA dense K = 20 ({iters}; {thinning}): {len(calls)} calls "
          f"replayed == eager loop, bitwise; {p['tokens_per_s']:.4g} tokens/s, idle share "
          f"{p['idle_share']:.4f}; peak {r['peak_gb']:.2f} GB; "
          + _tg_warm_line(calls))
    rec["local_dense"] = r
    del m
    torch.cuda.empty_cache()

    # one rank of TG_CHAINS chains, 4 buckets, (50; 25)
    torch.cuda.reset_peak_memory_stats()
    cm = _md_model(corpus, dicti, seed, make_mesh(device=DEVICE), TG_CHAINS, n_buckets=4)
    calls = [_tg_call(cm, lambda: cm.run_training(TRAIN_ITERS, THINNING,
                                                  total_iters=TOTAL_ITERS),
                      lambda: eager_chains_training(cm, TRAIN_ITERS, THINNING, TOTAL_ITERS),
                      f"{TG_CHAINS} chains, 4 buckets, (50; 25), call {n + 1}",
                      blocks * cm.n_buckets, warm=n > 0)
             for n in range(TG_CALLS)]
    run, s, M = cm._loop.blocks.run, cm.state, cm._merge_M
    st = _state_copy(type(run.state)(s.z, s.n_dk, s.n_vk, s.n_k))
    eager_gens = gen_of(TG_CHAINS)
    vbeta = float(cm.V * cm.beta)
    r = dict(calls=calls, block=_tg_block_timing(
        run, lambda: fused_train_block_buckets(st, *run._inputs, cm.alpha, cm.beta, M,
                                               generator=eager_gens, vbeta=vbeta),
        M, gen_of(TG_CHAINS)))
    r["profile"] = _tg_profile(
        lambda: cm.run_training(TRAIN_ITERS, THINNING, total_iters=TOTAL_ITERS),
        TG_CHAINS * cm.n_tokens * TRAIN_ITERS)
    r["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    _tg_print(f"{TG_CHAINS} chains, 4 buckets, (50; 25)", r)
    print(f"  {TG_CHAINS} chains: {_tg_warm_line(calls)}")
    rec[f"chains_{TG_CHAINS}"] = r
    del cm, run, st
    torch.cuda.empty_cache()

    # one rank of TG_CHAINS dense AD-LDA chains, TG_DENSE
    iters, thinning = TG_DENSE
    torch.cuda.reset_peak_memory_stats()
    dm = _md_model(corpus, dicti, seed, make_mesh(device=DEVICE), TG_CHAINS, sweep="dense")
    draws, commits = planned_sweep_launches(dm.corpus.tok_f.T.to(torch.float32))
    calls = [_tg_call(dm, lambda: dm.run_training(iters, thinning),
                      lambda: eager_dense_chains_training(dm, iters, thinning),
                      f"{TG_CHAINS} dense AD-LDA chains ({iters}; {thinning}), call {n + 1}",
                      0, kernel2=(iters * draws, iters * commits), warm=n > 0)
             for n in range(TG_CALLS)]
    r = dict(calls=calls, profile=_tg_profile(lambda: dm.run_training(iters, thinning),
                                              TG_CHAINS * dm.n_tokens * iters),
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    p = r["profile"]
    print(f"training graphs, {TG_CHAINS} dense AD-LDA chains ({iters}; {thinning}): "
          f"{len(calls)} calls replayed == eager loop, bitwise; {p['tokens_per_s']:.4g} "
          f"tokens/s, idle share {p['idle_share']:.4f}; peak {r['peak_gb']:.2f} GB; "
          + _tg_warm_line(calls))
    rec[f"dense_chains_{TG_CHAINS}"] = r
    del dm
    torch.cuda.empty_cache()

    # Labeled LDA, dense TG_DENSE, perplexity on
    torch.cuda.reset_peak_memory_stats()
    model = labeled(sweep="dense")
    calls = [_tg_call(model, lambda: model.run_training(iters, thinning),
                      lambda: eager_training(model, iters, thinning, perplexity=True),
                      f"Labeled-LDA dense ({iters}; {thinning}), call {n + 1}", 0,
                      kernel2=dense_plan(model, iters), warm=n > 0)
             for n in range(TG_CALLS)]
    r = dict(calls=calls, profile=_tg_profile(
        lambda: model.run_training(iters, thinning, perplexity=False),
        model.n_tokens * iters), peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    _check_counts(model.counts, float(model.n_tokens), "training graphs, Labeled-LDA dense")
    p = r["profile"]
    print(f"training graphs, Labeled-LDA dense ({iters}; {thinning}): {len(calls)} calls "
          f"replayed == eager loop, bitwise; {p['tokens_per_s']:.4g} tokens/s with perplexity "
          f"off, idle share {p['idle_share']:.4f}; peak {r['peak_gb']:.2f} GB; "
          + _tg_warm_line(calls))
    rec["labeled_dense"] = r
    del model
    torch.cuda.empty_cache()

    # Labeled LDA, compact (10; 5)
    torch.cuda.reset_peak_memory_stats()
    model = labeled(sweep="compact")
    calls = [_tg_call(model, lambda: model.run_training(COMPACT_ITERS, COMPACT_THINNING),
                      lambda: eager_training(model, COMPACT_ITERS, COMPACT_THINNING,
                                             perplexity=True),
                      f"Labeled-LDA compact ({COMPACT_ITERS}; {COMPACT_THINNING}), call "
                      f"{n + 1}", 0, warm=n > 0)
             for n in range(TG_CALLS)]
    sweeps = compact_sweeps_case(model, seed)
    prof = _tg_profile(lambda: model.run_training(COMPACT_ITERS, COMPACT_THINNING,
                                                  perplexity=False),
                       model.n_tokens * COMPACT_ITERS)
    r = dict(calls=calls, sweeps=sweeps, profile_perplexity_off=prof,
             peak_gb=torch.cuda.max_memory_allocated() / 1e9)
    positions = sum(t["positions"] for t in sweeps)
    nodes = sum(t["graph_nodes"] for t in sweeps)
    _check(all(t["graph_nodes"] >= t["positions"] for t in sweeps),
           f"each compact sweep's graph holds a node or more a position ({nodes} for "
           f"{positions})")
    print(f"training graphs, Labeled-LDA compact ({COMPACT_ITERS}; {COMPACT_THINNING}): "
          f"{len(calls)} calls replayed == eager loop, bitwise; {nodes} graph nodes a sweep "
          f"over the buckets ({nodes / positions:.2f} per position); device ms per sweep "
          f"eager {sum(t['eager_ms'] for t in sweeps):.4f}, runner calls "
          f"{sum(t['call_ms'] for t in sweeps):.4f} (replays alone "
          f"{sum(t['replay_ms'] for t in sweeps):.4f}); {prof['tokens_per_s']:.4g} tokens/s "
          f"with perplexity off, idle share {prof['idle_share']:.4f}; peak "
          f"{r['peak_gb']:.2f} GB")
    print(f"  Labeled-LDA compact: {_tg_warm_line(calls)}")
    rec["compact"] = r
    del model
    torch.cuda.empty_cache()

    # HSLDA at full width, one model and one rank of TG_CHAINS chains, two
    # calls of HSLDA_REPLAYED each
    rec.update(hslda_training_graphs(seed))
    return rec


def hslda_training_graphs(seed: int) -> dict:
    """Phase 16's HSLDA cases: ``TG_CALLS`` ``run_training`` calls of
    ``HSLDA_REPLAYED`` cycles each (the later ones with ``continue_avg``) of
    an ``HSLDA`` and of a one-rank ``DistributedHSLDA`` of ``TG_CHAINS``
    chains at full width, each held to ``eager_hslda_training``; the later
    calls capture no graph and run no body eagerly."""
    import torch

    from lda_thesis_tpu_torch.data.synthetic import jel_corpus
    from lda_thesis_tpu_torch.models.hslda import HSLDA

    jel = jel_corpus(seed, n_l3=HSLDA_N_L3)
    args = (jel.train_docs, jel.train_labs, jel.labelset)
    rec = {}
    for name, C in (("hslda", 0), (f"hslda_chains_{TG_CHAINS}", TG_CHAINS)):
        torch.cuda.reset_peak_memory_stats()
        m = (_hslda_model(*args, seed, C, DEVICE, HSLDA_K) if C
             else HSLDA(*args, k=HSLDA_K, seed=seed, device=DEVICE))
        calls = [_tg_call(m, lambda n=n: m.run_training(*HSLDA_REPLAYED, continue_avg=n > 0),
                          lambda n=n: eager_hslda_training(m, *HSLDA_REPLAYED,
                                                           continue_avg=n > 0),
                          f"{name} {HSLDA_REPLAYED}, call {n + 1}", 0, warm=n > 0)
                 for n in range(TG_CALLS)]
        r = dict(calls=calls, peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                 graphs=list(replay_counts(m)))
        print(f"training graphs, {name} {HSLDA_REPLAYED} at full width: {len(calls)} calls "
              f"replayed == the eager loop, bitwise (z, counts, η, a, β, φ̂"
              f"{'' if C else ', z̄'}, generators); (graphs, eager bodies) of its runners "
              f"{r['graphs']}; peak {r['peak_gb']:.2f} GB; " + _tg_warm_line(calls))
        rec[name] = r
        del m
        torch.cuda.empty_cache()
    return rec


def warp_record(rec: dict, local: dict, ptxas: dict) -> dict:
    """The warp route's line of the kernel records: its launches on its
    main path (LocalLDA ``-k 50``, phase 10), its time, bound and plain
    version at ``WIDE_SLOT_SHAPE``, and both routes' at every timed shape."""
    from lda_thesis_tpu_torch.ops.fused_block_cuda import WARP_ROWS_MAX

    t = rec["timed"]
    return {
        "name": "fused_block_warp",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": local["k50"]["launches"],
        "bitwise_equal": True,
        "max_abs_err": rec["route_max_abs_err"]["warp"],
        "ms": t["wide_slot_warp_ms"],
        "plain_ms": t["wide_slot_plain_ms"],
        "bound_ms": t["wide_slot_bound_ms"],
        "bound_by": t["wide_slot_bound_by"],
        "library_ms": None,
        "per": f"launch of the warp route at (D, U, A, M) = {WIDE_SLOT_SHAPE} (LocalLDA "
               "K = 50); device time from CUDA events around 10 back-to-back launches, "
               "the mean of two runs; *_general_ms the general (CTA) route's at the same "
               "inputs in the same run; launches are LocalLDA -k 50's (20; 10)",
        "rows_max": WARP_ROWS_MAX,
        "ptxas": ptxas,
        "timed": t,
        "local_lda_k50_wall_s": local["k50"]["wall_s"],
    }


def wide_record(rec: dict, local: dict, ptxas: dict) -> dict:
    """The wide route's line of the kernel records: its launches on its main
    path (LocalLDA ``-k 300``, phase 10), its time, bound and plain version
    at ``K300_SHAPE``, and the general (CTA) route's time on the same
    inputs."""
    t = rec["timed"]
    return {
        "name": "fused_block_wide",
        "route": "cuda",
        "source": SOURCE,
        "replaces": REPLACES,
        "launches": local["k300"]["launches"],
        "bitwise_equal": True,
        "max_abs_err": rec["route_max_abs_err"]["wide"],
        "ms": t["k300_wide_ms"],
        "plain_ms": t["k300_plain_ms"],
        "bound_ms": t["k300_bound_ms"],
        "bound_by": t["k300_bound_by"],
        "library_ms": None,
        "per": f"launch of the wide route at (D, U, A, M) = {K300_SHAPE} (LocalLDA "
               "K = 300); device time from CUDA events around 10 back-to-back launches, "
               "the mean of two runs; general_ms the general (CTA) route's on the same "
               "inputs in the same run; launches are LocalLDA -k 300's (20; 10)",
        "general_ms": t["k300_general_ms"],
        "k1000": {k: t[f"k1000_{k}"] for k in ("wide_ms", "general_ms", "bound_ms",
                                                "plain_ms", "steps")},
        "max_slots": rec["wide_max_slots"],
        "ptxas": ptxas,
        "local_lda_k300_wall_s": local["k300"]["wall_s"],
    }


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args(argv)

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from lda_thesis_tpu_torch.data.synthetic import jel_corpus, planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc
    from lda_thesis_tpu_torch.ops import foldin_cuda as fic
    from lda_thesis_tpu_torch.ops import fused_block_cuda as fbc

    ptxas = {"warp": {}, "wide": {}}  # filled by a build in this run
    fold_ptxas = {}
    seconds = {}
    clock = [time.perf_counter()]

    def phase_done(name: str) -> None:
        now = time.perf_counter()
        seconds[name] = now - clock[0]
        clock[0] = now
        print(f"[phase {name}: {seconds[name]:.2f} s]")

    # 1. environment
    card = _card_line()
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}, numpy {np.__version__}")
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, "
          f"{torch.cuda.device_count()} visible)")
    _check(not torch.backends.cuda.matmul.allow_tf32, "TF32 matmul is off")
    _check(torch.get_float32_matmul_precision() == "highest",
           "float32 matmuls run in IEEE FP32 (precision 'highest')")
    phase_done("environment")

    # 2. kernel builds: one nvcc per source, started together
    with ThreadPoolExecutor(max_workers=3) as pool:
        builds = {name: pool.submit(mod.build)
                  for name, mod in (("fused_block", fbc), ("draw_update", duc),
                                    ("foldin", fic))}
        for name, fut in builds.items():
            _, secs, log = fut.result()
            print(f"kernel build {name}: {secs:.2f} s")
            for line in log.splitlines():
                if "registers" in line or "spill" in line:
                    print("  " + line.strip())
            if name == "fused_block" and log:  # a build in this run: ptxas spoke
                ptxas = route_ptxas(log)
                warp = ptxas["warp"]
                _check(sorted(warp) == list(range(1, fbc.WARP_ROWS_MAX + 1))
                       and all(v["spill_stores"] == 0 for v in warp.values())
                       and ptxas["wide"].get("spill_stores") == 0,
                       f"the warp route's S = 1..{fbc.WARP_ROWS_MAX} and the wide route "
                       f"build with no spill stores ({ptxas})")
                print(f"warp route, ptxas by rows S: {json.dumps(warp)}; wide route: "
                      f"{json.dumps(ptxas['wide'])}")
            if name == "foldin" and log:
                fold = fold_ptxas = foldin_ptxas(log)
                print(f"fold-in kernel, ptxas by instantiation: {json.dumps(fold)}")
                _check(len(fold) == 27 and all(v["spill_stores"] == 0 for k, v in fold.items()
                                               if k.startswith("R")),
                       f"the fold-in kernel's 27 instantiations build, the register route's "
                       f"21 with no spill stores ({fold})")
    phase_done("build")

    # 3. merge-block kernel against its plain version
    corpus = planted_corpus(args.seed)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    probe = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset,
                       dicti, alpha=0.1, beta=0.01, seed=args.seed, device=DEVICE)
    rec = kernel_phase(probe, args.seed)
    del probe
    phase_done("fused_block kernel")

    # 4. fused path
    run = main_path(corpus, dicti, args.seed)
    model = run.pop("model")
    steady = {p: steady_training(model, p) for p in (True, False)}
    del model
    phase_done("fused path")

    # 5. draw-update kernel against its plain version
    jel = jel_corpus(args.seed)
    jel_dicti = prune_dict(jel.train_docs, lower=0, upper=1)
    draw = draw_kernel_phase(corpus, dicti, jel, jel_dicti, args.seed)
    phase_done("draw_update kernel")

    # 6. dense path
    dense = exact_path(corpus, dicti, args.seed, "dense", TRAIN_ITERS, THINNING)
    _check(dense["launches"] == TRAIN_ITERS * draw["draws_per_sweep"],
           "dense: one draw launch per live position per sweep")
    dense_model = dense.pop("model")
    graphed = graph_check(dense_model, args.seed + 4)
    dense_prof = dense_profile(dense_model)
    del dense_model
    phase_done("dense path")

    # 7. compact path
    compact = exact_path(corpus, dicti, args.seed, "compact", COMPACT_ITERS,
                         COMPACT_THINNING)
    compact.pop("model")
    phase_done("compact path")

    # 8. CascadeLDA
    cascade = cascade_path(jel, jel_dicti, args.seed)
    cascade_model = cascade.pop("model")
    phase_done("cascade path")

    # 9. the product surface: the CLIs, checkpoint/resume, entry()
    product = product_phase(args.seed)
    phase_done("product surface")

    # 10. LocalLDA through its CLI, and 11. the VI engine through the
    # Labeled-LDA CLI
    local = local_lda_phase(args.seed)
    phase_done("LocalLDA")
    vi = vi_phase(args.seed)
    phase_done("VI engine")

    # 12. HSLDA: card against CPU, replay against eager, the CLI at full width
    hslda = hslda_phase(args.seed)
    phase_done("HSLDA")

    # 13. multi-device: chains batched in kernel 1, the distributed trainer,
    # ranks over gloo on the one card, the CLI's multi-device flags
    md = multi_device_phase(args.seed, card)
    phase_done("multi-device")

    # 14. multi-device HSLDA: chains batched in one z-sweep graph, the
    # trainer at 1-64 chains, two gloo ranks on the card, the CLI's
    # --n-chains with a kill and resume
    hmd = hslda_multi_phase(args.seed, card, hslda["cli_opt2"]["wall_s"]["test"])
    phase_done("multi-device HSLDA")

    # 15. the test-time loops as replayed CUDA graphs, each against its
    # eager loop
    loops = compiled_loops_phase(args.seed, corpus, dicti, cascade_model, jel)
    del cascade_model
    phase_done("compiled loops")

    # 16. the training loops as replayed CUDA graphs, each against its eager
    # loop of functional calls
    graphs = training_graphs_phase(args.seed, corpus, dicti, card)
    phase_done("training graphs")

    # 17. records
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
        "per": "merge block (4 bucket launches, M=25); ms is device time "
               "(CUDA events around 20 back-to-back calls), call_ms the calls', "
               "warp_ms the warp route's on the same inputs",
        "call_ms": rec["call_ms"],
        "warp_ms": rec["warp_ms"],
        "chain_steps": rec["chain_steps"],
        "ns_per_step": rec["ns_per_step"],
        "buckets": rec["buckets"],
        "gather_ms": rec["gather_ms"],
        "scatter_ms": rec["scatter_ms"],
        "train_tokens_per_s": run["tokens_per_s"],
        "steady_train_tokens_per_s": steady[True]["tokens_per_s"],
        "steady_train_tokens_per_s_no_perplexity": steady[False]["tokens_per_s"],
        "device_idle_share": steady[True]["device_idle_share"],
        "device_idle_share_no_perplexity": steady[False]["device_idle_share"],
        "auc_roc": run["metrics"]["auc_roc"],
        "cli_launches": product["fused"]["launches"],
        "cli_train_tokens_per_s": product["fused"]["tokens_per_s"],
        "cli_wall_s_by_step": product["fused"]["wall_s"],
        "cli_auc_roc": product["fused"]["auc_roc"],
        "cli_preprocessing": product["fused"]["pipeline"],
        "checkpoint_write_ms": product["checkpoint"]["write_ms"],
        "checkpoint_npz_mb": product["checkpoint"]["npz_mb"],
        "kill_resume_bitwise_arrays": product["checkpoint"]["arrays"],
        "trace_records": product["trace"]["kernel1_records"],
        "launches_local_lda": local["fused"]["launches"],
        "staged_max_abs_err": rec["route_max_abs_err"]["staged"],
        "general_max_abs_err": rec["route_max_abs_err"]["general"],
        "local_lda": local,
        "launches_multi_device": md["trainer"]["launches"],
        "launches_multi_device_cli_n_chains_8": md["cli"]["n_chains_launches"],
        "multi_device_batched_ms": md["batch"]["batched_ms"],
        "multi_device_single_chain_ms": md["batch"]["single_ms"],
    }, {
        "name": "draw_update",
        "route": "cuda",
        "source": DRAW_SOURCE,
        "replaces": DRAW_REPLACES,
        "launches": dense["launches"],
        "bitwise_equal": True,
        "max_abs_err": draw["max_abs_err"],
        "ms": draw["ms"],
        "plain_ms": draw["plain_ms"],
        "bound_ms": draw["bound_ms"],
        "bound_by": draw["bound_by"],
        "library_ms": None,
        "per": "launch as the sweep makes it (table rows in place), mean over the first "
               "and last positions of the dense path's buckets weighted by their "
               "positions; ms is device time (CUDA events around replays of a graph of "
               "20 launches), call_ms the call's; "
               "ms_all_positions the mean device time over every launch of one replayed "
               "sweep, step_ms_per_position CUDA events around replayed sweeps over all "
               f"{dense['positions']} positions",
        "call_ms": draw["call_ms"],
        "ms_all_positions": draw["ms_all_positions"],
        "bound_ms_all_positions": draw["bound_ms_all_positions"],
        "commit_ms": draw["commit_ms"],
        "step_ms_per_position": graphed["step_ms_per_position"],
        "sweep_ms": graphed["sweep_ms"],
        "draws_per_sweep": draw["draws_per_sweep"],
        "commits_per_sweep": draw["commits_per_sweep"],
        "buckets": draw["buckets"],
        "cascade_level2": draw["cascade_level2"],
        "launches_cascade": cascade["launches"],
        "dense_train_tokens_per_s": dense["tokens_per_s"],
        "dense_profiled_wall_ms_no_perplexity": dense_prof["wall_ms"],
        "dense_profiled_busy_ms_no_perplexity": dense_prof["busy_ms"],
        "dense_profiled_tokens_per_s_no_perplexity": dense_prof["tokens_per_s"],
        "dense_device_idle_share_no_perplexity": dense_prof["idle_share"],
        "dense_auc_roc": dense["metrics"]["auc_roc"],
        "compact_train_tokens_per_s": compact["tokens_per_s"],
        "compact_auc_roc": compact["metrics"]["auc_roc"],
        "cascade_auc_by_depth": cascade["aucs"],
        "cascade_train_s": cascade["train_s"],
        "cascade_test_s": cascade["test_s"],
        "cli_dense_launches": product["dense"]["launches"],
        "cli_dense_train_tokens_per_s": product["dense"]["tokens_per_s"],
        "cli_dense_wall_s_by_step": product["dense"]["wall_s"],
        "cli_dense_auc_roc": product["dense"]["auc_roc"],
        "cli_cascade_auc_by_depth": product["cascade"]["aucs"],
        "cli_cascade_s": product["cascade"]["seconds"],
        "launches_multi_device_dense": md["dense"]["launches"],
        "launches_multi_device_dense_cli_n_chains_8": md["cli"]["dense_n_chains_launches"],
        "batched_launch": "a rank's chains in one launch per position "
                          "(draw_update_chains_kernel and count_commit_chains_kernel, grid "
                          "y = chain) and one sweep graph per rank; multi_device_dense_chains "
                          "holds its device ms per replayed sweep against single-chain graphs",
        "multi_device_dense_chains": md["dense_chains"],
    }, warp_record(rec, local, ptxas["warp"]), wide_record(rec, local, ptxas["wide"]), {
        "name": "count_commit",
        "route": "cuda",
        "source": DRAW_SOURCE,
        "replaces": COMMIT_REPLACES,
        "launches": dense["commit_launches"],
        "bitwise_equal": True,
        "max_abs_err": draw["max_abs_err"],
        "ms": draw["commit_ms"],
        "plain_ms": draw["commit_plain_ms"],
        "bound_ms": draw["commit_bound_ms"],
        "bound_by": "bytes",
        "library_ms": draw["commit_library_ms"],
        "per": "launch, mean device time over every commit of one replayed sweep "
               "(torch.profiler); plain_ms and library_ms (two index_add_ calls) at "
               "bucket 0 position 1",
        "launches_cascade": cascade["commit_launches"],
        "cli_dense_launches": product["dense"]["commit_launches"],
        "launches_multi_device_dense": md["dense"]["commit_launches"],
        "launches_multi_device_dense_cli_n_chains_8":
            md["cli"]["dense_n_chains_commit_launches"],
    }, {
        "name": "foldin",
        "route": "cuda",
        "source": FOLDIN_SOURCE,
        "replaces": FOLDIN_REPLACES,
        "launches": loops["foldin_launches"],
        "bitwise_equal": True,
        "max_abs_err": 0.0,
        "ms": loops["labeled_foldin_kernel"]["ms"],
        "plain_ms": loops["labeled_foldin_kernel"]["plain_ms"],
        "bound_ms": loops["labeled_foldin_kernel"]["bound_ms"],
        "bound_by": loops["labeled_foldin_kernel"]["bound_by"],
        "library_ms": None,
        "per": "sweep, the Labeled-LDA fold-in of phase 15 (D = 464, U = 128, Kp = 512); ms "
               "is device time (CUDA events around replays of a graph of 20 launches), "
               "plain_ms the plain body's sweep run eagerly, plain_graph_ms replayed as one "
               "graph (the port's fold-in before the kernel); hslda the HSLDA fold-in at "
               "C = 1 and 8",
        "plain_graph_ms": loops["labeled_foldin_kernel"]["plain_graph_ms"],
        "labeled": loops["labeled_foldin_kernel"],
        "hslda_c1": loops["hslda_foldin_kernel_c1"],
        "hslda_c8": loops["hslda_foldin_kernel_c8"],
        "ptxas": fold_ptxas,
    }]
    print(json.dumps({"phase_seconds": seconds}))
    print(json.dumps({"vi": vi}))
    print(json.dumps({"hslda": hslda}))
    print(json.dumps({"multi_device": md}))
    print(json.dumps({"multi_device_hslda": hmd}))
    print(json.dumps({"compiled_loops": loops}))
    print(json.dumps({"training_graphs": graphs}))
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
