"""Probe the exact sweep's draw kernel (ops/csrc/draw_update.cu) on the card.

    python3 tools/probe_draw_update.py

Builds the kernels, makes the dense Labeled-LDA model of ``chip_smoke.py``
(synthetic depth-3 abstracts, seed 0) and, at the first and last position
of each bucket, traces 20 ``draw_rows`` launches under torch.profiler
(host and device) and prints every CUDA record the session kept, by name
and count; then times the same 20 launches captured as one CUDA graph with
CUDA events around 10 replays.  Then the same two timings of a launch of
64 live rows at K = 21 ... 1100.  Prints the card's name and power limit
first.
"""

from __future__ import annotations

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402

REPS = 20


def records(fn) -> list:
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.002)
        for _ in range(REPS):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.002)
    return [(e.key[:70], e.count, e.self_device_time_total / 1e3 / max(e.count, 1))
            for e in prof.key_averages() if e.device_type == DeviceType.CUDA]


def main() -> int:
    if not torch.cuda.is_available():
        print("probe_draw_update: no CUDA device", file=sys.stderr)
        return 1
    from lda_thesis_tpu_torch.data.synthetic import planted_corpus
    from lda_thesis_tpu_torch.data.vocab import prune_dict
    from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA
    from lda_thesis_tpu_torch.ops import draw_update_cuda as duc

    print(chip_smoke._card_line())
    duc.build()
    corpus = planted_corpus(0)
    dicti = prune_dict(corpus.train_docs, lower=0, upper=1)
    model = LabeledLDA(corpus.train_docs, corpus.train_labs, corpus.labelset, dicti,
                       alpha=0.1, beta=0.01, seed=0, sweep="dense", device="cuda")
    st = model.counts
    vbeta = float(model.V * model.beta)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(1)
    for g in range(model.buckets.n_buckets):
        tv, tf = model._toks_v_t[g], model._toks_f_t[g]
        U = tv.shape[0]
        z_t = st.z[g].T.contiguous()
        for p in (0, U - 1):
            _, draw = chip_smoke.sweep_inputs(tv, tf, z_t, st.n_dk[g], st.n_vk, st.n_k,
                                              model.labs_t[g], p, gen)
            if not draw[-1].numel():
                continue

            def fn():
                duc.draw_rows(*draw, model.alpha, model.beta, vbeta)

            recs = records(fn)
            print(f"bucket {g} position {p} ({draw[-1].numel()} live rows): records "
                  + "; ".join(f"{n} x {k} ({ms:.5f} ms)" for k, n, ms in recs))
            print(f"  graph of {REPS} launches: {chip_smoke._graph_ms(fn, REPS):.5f} ms "
                  "per launch")

    # the same launch at other widths: 64 live rows over a 600-row table
    rng = np.random.default_rng(0)
    for K in (21, 32, 128, 256, 371, 512, 1024, 1100):
        D, V = 64, 600
        labs = torch.ones((D, K), device="cuda")
        n_dk = torch.from_numpy(rng.integers(1, 20, size=(D, K)).astype(np.float32)).cuda()
        table = torch.from_numpy(rng.integers(0, 300, size=(V, K)).astype(np.float32)).cuda()
        f = torch.ones(D, device="cuda")
        z = torch.zeros(D, dtype=torch.int32, device="cuda")
        u = torch.rand(D, device="cuda")
        live = torch.arange(D, dtype=torch.int32, device="cuda")
        words = torch.from_numpy(rng.integers(0, V, size=D)).cuda()
        n_k = table.sum(0) + 1000.0

        def fn():
            duc.draw_rows(u, f, z, labs, n_dk, table, words, n_k, live, 0.1, 0.01, 89.69)

        recs = records(fn)
        print(f"K={K} (64 live rows): "
              + "; ".join(f"{n} x {ms:.5f} ms" for k, n, ms in recs if "draw" in k)
              + f"; graph {chip_smoke._graph_ms(fn, REPS):.5f} ms per launch")
    return 0


if __name__ == "__main__":
    sys.exit(main())
