"""HSLDA cells: the port's ``HSLDA`` on the configuration's JEL-shaped
corpus, in an order drawn from the run's seed (``corpus.for_run``), and
seeded with it.

The configuration gives the corpus generator, its seed and sizes (``corpus``),
the model's settings (``model_args``), the coupling (``opt``) and, for
prediction, the fit that set-up trains (``fit``).  The traffic mix names
the call:

* ``"train"``: ``run_training(iters, thinning, opt)``; its work is
  ``n_tokens · iters`` token draws (one per token a cycle).  After the
  window one more call is made from a recorded state (counts, η, a, β and
  the generator's state) and the reference follows it.
* ``"predict"``: ``run_tests`` of the held-out documents at ``(it,
  thinning)`` and each document's top-``top`` labels by
  ``label_predictions``; its work is the documents predicted.  The state at
  the start of set-up's fit is recorded, and the reference follows the fit
  to tables of its own (φ̂, n_vk, β, η).  The generator's state before each
  request is recorded, and the reference redoes a sample of the window's
  requests drawn from the seed (the last one always among them) against
  its own tables.

The model's own generator (``model._gen``) is the one private attribute
read: its state is where the reference picks up the program's draws.
"""

from __future__ import annotations

import random
import time
from typing import Dict, List, Tuple

import numpy as np
import torch

from portbench import corpus as corpora
from portbench import work as counted
from portbench.reference import hslda as ref

ROOT = ""  # the label of column 0, always on
# an auxiliary a counts as off where it differs from the reference's by more
# than A_OFF, a document's thinned z̄ where any topic's differs by more than
# ZBAR_OFF: a sound call moves none, the bfloat16 control most (PERF.md)
A_OFF = 1e-3
ZBAR_OFF = 1e-6


def _host(t) -> torch.Tensor:
    return torch.as_tensor(t).detach().to("cpu", copy=True)


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from lda_thesis_tpu_torch.models.hslda import HSLDA

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.corpus = c = corpora.for_run(config["corpus"], seed)
        t1 = time.perf_counter()
        self.model = HSLDA(c.train_docs, c.train_labs, c.labelset, seed=seed, device=device,
                           **config["model_args"])
        t2 = time.perf_counter()
        self.kind = traffic["call"]
        self.opt = int(config["opt"])
        self.requests: List[Tuple[torch.Tensor, np.ndarray, list]] = []
        self.record = False
        if self.kind == "predict":
            fit = config["fit"]
            self._fit = dict(start=self._state(), gen=self.model._gen.get_state())
            self.model.run_training(fit["iters"], fit["thinning"], opt=self.opt)
        for _ in range(int(traffic["warm_calls"])):
            self.call()
        self.record = True
        self.phases = {"corpus": t1 - t0, "model": t2 - t1, "warm-up": time.perf_counter() - t2}

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize()

    def call(self) -> float:
        t, m = self.traffic, self.model
        if self.kind == "train":
            m.run_training(t["iters"], t["thinning"], opt=self.opt)
            self._sync()
            return float(m.n_tokens * t["iters"])
        state = m._gen.get_state()
        probs = m.run_tests(self.corpus.test_docs, t["it"], t["thinning"])
        preds = [m.label_predictions(row)[:t["top"]] for row in probs]
        if self.record:
            self.requests.append((state, probs, preds))
        return float(len(self.corpus.test_docs))

    def work(self) -> dict:
        """The counted operations of one call (``portbench/work.py``)."""
        m, t, c = self.model, self.traffic, self.corpus
        if self.kind == "train":
            tokens = [len(d) for d in c.train_docs]
            labels = [len(set(l)) + 1 for l in c.train_labs]
            S = max(max(tokens) + 2, 8)
            return {"ops_per_call": float(t["iters"] * counted.hslda_cycle_ops(
                        tokens, labels, m.K, m.L, S))}
        tokens = [sum(1 for w in d if w in m.w_to_v) for d in c.test_docs]
        return {"ops_per_call": float(counted.foldin_ops(tokens, m.K, t["it"]))}

    # ----------------------------------------------------------- the check

    def _state(self) -> "ref.State":
        m = self.model
        c = m.counts
        return ref.State(*(_host(x) for x in (c.z, c.n_dk, c.n_vk, c.n_k, m.eta, m.a, m.beta)))

    def after_window(self) -> None:
        """Record what the reference needs while the model is alive."""
        m = self.model
        self.layout = dict(tok_v=_host(m.tok_v).numpy(), mask=_host(m.mask).numpy(),
                           labs=_host(m.labs).numpy(),
                           words=[m.v_to_w[v] for v in range(m.V)], labels=list(m.lablist))
        self.V, self.K = m.V, m.K
        if self.kind == "train":
            start, gen_state = self._state(), m._gen.get_state()
            self.call()
        else:  # the fit's start; requests leave the trained state as it is
            start, gen_state = self._fit["start"], self._fit["gen"]
        self._checked = dict(start=start, gen=gen_state, end=self._state(), ph=_host(m.ph),
                             th=_host(m.th), word_ids=dict(m.w_to_v))

    def free(self) -> None:
        self.model = None

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared with the reference (``limits/<cell>.json``
        holds each one's limit).  ``control=True`` judges the reference
        itself run in bfloat16 in the program's place, from the same
        state and draws."""
        lay = self.layout
        ref.check_layout(lay["tok_v"], lay["mask"], lay["labs"], lay["words"], lay["labels"],
                         self.corpus.train_docs, self.corpus.train_labs, ROOT)
        return (self._check_train if self.kind == "train" else self._check_predict)(control)

    def _follow(self, cycles: int, thinning: int, control: bool, prefix: str = ""):
        """The recorded call (``cycles`` cycles from the recorded start and
        generator state) against the reference's; returns the numbers
        compared, and the end state and φ̂ of the reference and of the side
        judged (the program's, or the control's)."""
        ck, a = self._checked, self.config["model_args"]
        dev = self.device
        lay = self.layout
        tok_v = torch.as_tensor(lay["tok_v"], device=dev)
        mask = torch.as_tensor(lay["mask"], device=dev)
        labs = torch.as_tensor(lay["labs"], device=dev)
        start = ref.State(*(x.to(dev) for x in ck["start"]))
        n_dk, n_vk, n_k = ref.recount(tok_v, mask, start.z, self.V, self.K)
        start_off = sum(int((x != y.long()).sum())
                        for x, y in zip((n_dk, n_vk, n_k), start[1:4]))
        # a is truncated to the sign of its label
        positive = labs > 0
        start_off += int((((start.a > 0) & ~positive) | ((start.a < 0) & positive)).sum())

        def follow(dtype):
            gen = torch.Generator(device=dev)
            gen.set_state(ck["gen"])
            return ref.train_call(tok_v, mask, labs, start, gen, self.V, a["alpha"],
                                  a["alpha_prime"], a["gamma"], a["mu"], a["sigma"],
                                  cycles, thinning, dtype)

        end, ph, th = follow(torch.float32)
        if control:  # the reference in bfloat16 in the program's place
            got, got_ph, got_th = follow(torch.bfloat16)
        else:
            got = ref.State(*(x.to(dev) for x in ck["end"]))
            got_ph, got_th = ck["ph"].to(dev), ck["th"].to(dev)
        live = mask > 0
        a_gap = (got.a - end.a).abs()
        numbers = {
            "start_counts_off": start_off,
            "z_off_share": float(((got.z.long() != end.z) & live).sum()) / float(live.sum()),
            "eta_gap": float((got.eta - end.eta).abs().max()),
            "a_off_share": float((a_gap > A_OFF).float().mean()),
            "beta_rel_gap": float(((got.beta - end.beta).abs() / end.beta).max()),
            "phi_hat_gap": float((got_ph - ph).abs().max()),
            "zbar_off_share": float(((got_th - th).abs().amax(dim=1) > ZBAR_OFF).float().mean()),
        }
        return {prefix + k: v for k, v in numbers.items()}, (end, ph), (got, got_ph)

    def _check_train(self, control: bool) -> Dict[str, float]:
        t = self.traffic
        return self._follow(t["iters"], t["thinning"], control)[0]

    def _check_predict(self, control: bool) -> Dict[str, float]:
        ck, t, a, fit = self._checked, self.traffic, self.config["model_args"], self.config["fit"]
        dev = self.device
        # the fit, followed from its start: the tables the requests read
        out, tables, got_tables = self._follow(fit["iters"], fit["thinning"], control,
                                               prefix="fit_")
        tv, mk = ref.test_layout(self.corpus.test_docs, ck["word_ids"])
        tok_v, mask = torch.as_tensor(tv, device=dev), torch.as_tensor(mk, device=dev)

        def inputs(state, ph):
            """The fold-in's tables from a fit's end: φ̂ for the init pass,
            (n_vk + γ) normalised over the words for the sweeps, αβ, η."""
            sweep = state.n_vk.cpu().numpy().astype(np.float64) + a["gamma"]
            sweep_phi = torch.as_tensor(sweep / sweep.sum(axis=0, keepdims=True),
                                        dtype=torch.float32, device=dev)
            return (ph.to(dev, torch.float32).T.contiguous(), sweep_phi,
                    (a["alpha"] * state.beta).to(dev), state.eta.cpu().numpy())

        own, judged = inputs(*tables), inputs(*got_tables)
        n = len(self.requests)
        picked = sorted(set(random.Random(self.seed).sample(
            range(n - 1), min(int(t["checked_requests"]) - 1, n - 1))) | {n - 1})
        gap, rank_off, docs = 0.0, 0, 0
        for i in picked:
            state, probs, preds = self.requests[i]

            def follow(tab, dtype):
                init_phi, sweep_phi, alpha_beta, eta = tab
                gen = torch.Generator(device=dev)
                gen.set_state(state)
                zbar = ref.fold_in(init_phi, sweep_phi, alpha_beta, tok_v, mask, t["it"],
                                   t["thinning"], gen, dtype)
                return ref.scores(zbar.cpu().numpy(), eta, a["xi"])

            want = follow(own, torch.float32)
            if control:  # the reference in bfloat16 in the program's place, on its own fit
                probs = follow(judged, torch.bfloat16)
                preds = [[(0.0, x) for x in row]
                         for row in ref.top_labels(probs, self.layout["labels"], t["top"])]
            gap = max(gap, float(np.abs(probs - want).max()))
            top = ref.top_labels(want, self.layout["labels"], t["top"])
            rank_off += sum(1 for p, w in zip(preds, top) if [x for _, x in p] != w)
            docs += len(top)
        out.update(score_gap=gap, rank_off_share=rank_off / max(docs, 1))
        return out


def build(config: dict, traffic: dict, seed: int, device: str) -> Job:
    return Job(config, traffic, seed, device)
