"""Labeled LDA cells: the port's ``LabeledLDA`` on the configuration's
corpus, in an order drawn from the run's seed (``corpus.for_run``), and
seeded with it.

The configuration gives the corpus generator, its seed and sizes (``corpus``),
the model's settings (``model_args``) and, for prediction, the fit that
set-up trains (``fit``).  The traffic mix names the call:

* ``"train"``: ``run_training(iters, thinning, perplexity, total_iters)``,
  a chunk of a longer run; its work is ``n_tokens · iters`` token draws.
  After the window one more call is made from a recorded state (its counts
  and its generator's state) and the reference follows it draw for draw.
* ``"predict"``: ``run_test`` of the held-out documents at ``(it,
  thinning)`` and their top-``top`` labels by ``get_preds``; its work is
  the documents predicted.  The state at the start of set-up's fit is
  recorded, and the reference follows the fit draw for draw to tables of
  its own.  The generator's state before each request is recorded, and the
  reference redoes a sample of the window's requests drawn from the seed
  (the last one always among them) against its own φ̂.

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
from portbench.reference import labeled_lda as ref

ROOT = "root"  # the label of topic 0, always on


def _host(t: torch.Tensor) -> torch.Tensor:
    return t.detach().to("cpu", copy=True)


class Job:
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from lda_thesis_tpu_torch.data.vocab import prune_dict
        from lda_thesis_tpu_torch.models.labeled_lda import LabeledLDA

        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.corpus = c = corpora.for_run(config["corpus"], seed)
        t1 = time.perf_counter()
        dicti = prune_dict(c.train_docs, lower=0, upper=1)
        args = config["model_args"]
        self.model = LabeledLDA(c.train_docs, c.train_labs, c.labelset, dicti, seed=seed,
                                device=device, **args)
        t2 = time.perf_counter()
        self.kind = traffic["call"]
        self.requests: List[Tuple[torch.Tensor, np.ndarray, list]] = []
        self.record = False
        if self.kind == "predict":
            fit = config["fit"]
            self._fit = dict(start=self._state(), gen=self.model._gen.get_state())
            self.model.run_training(fit["iters"], fit["thinning"], perplexity=False,
                                    total_iters=fit["total_iters"])
        for _ in range(int(traffic["warm_calls"])):
            self.call()
        self.record = True
        self.phases = {"corpus": t1 - t0, "model": t2 - t1, "warm-up": time.perf_counter() - t2}

    # ------------------------------------------------------------ the window

    def call(self) -> float:
        t, m = self.traffic, self.model
        if self.kind == "train":
            m.run_training(t["iters"], t["thinning"], perplexity=bool(t["perplexity"]),
                           total_iters=t["total_iters"])
            if self.device.type == "cuda":
                torch.cuda.synchronize()
            return float(m.n_tokens * t["iters"])
        state = m._gen.get_state()
        theta = m.run_test(self.corpus.test_docs, t["it"], t["thinning"])
        preds = m.get_preds(theta, t["top"])
        if self.record:
            self.requests.append((state, theta, preds))
        return float(len(self.corpus.test_docs))

    def work(self) -> dict:
        """The counted work of one call (``portbench/work.py``): its
        operations and, for training, kernel 1's bound per merge block."""
        m, t, c = self.model, self.traffic, self.corpus
        out: Dict[str, float] = {}
        if self.kind == "train":
            labels = [len(set(l)) + 1 for l in c.train_labs]
            types = [len(set(d)) for d in c.train_docs]
            saves = t["iters"] // t["thinning"]
            out["ops_per_call"] = (t["iters"] * counted.llda_sweep_ops(types, labels)
                                   + saves * counted.llda_save_ops(m.V, m.K, labels))
            merge = ref.merge_block_size(self.config["model_args"]["merge_every"],
                                         t["thinning"], t["total_iters"])
            labels, types = np.asarray(labels), np.asarray(types)
            out["kernel1_bound_s_per_block"] = sum(
                counted.kernel1_launch_bound_s(int((types[ix] * labels[ix]).sum()),
                                               int(types[ix].sum()), tf.shape[1], tf.shape[0],
                                               int(labels[ix].sum()), merge)
                for ix, tf in zip(m.buckets.doc_idx, m.buckets.tok_f))
            out["launches_per_block"] = float(m.buckets.n_buckets)
        else:
            types = [len(set(w for w in d if w in m.w_to_v)) for d in c.test_docs]
            out["ops_per_call"] = counted.foldin_ops(types, m.K, t["it"])
        return out

    # ----------------------------------------------------------- the check

    def _state(self) -> "ref.State":
        st = self.model.counts
        return ref.State(tuple(_host(z) for z in st.z), tuple(_host(x) for x in st.n_dk),
                         _host(st.n_vk), _host(st.n_k))

    def after_window(self) -> None:
        """Record what the reference needs while the model is alive."""
        m = self.model
        layout = [ref.Bucket(ix, tv, tf, _host(li).numpy(), _host(lv).numpy())
                  for ix, tv, tf, li, lv in zip(m.buckets.doc_idx, m.buckets.tok_v,
                                                m.buckets.tok_f, m.lab_ids_t, m.lab_valid_t)]
        self.layout = layout
        self.words = [m.v_to_w[v] for v in range(m.V)]
        self.labels = list(m.labelmap.keys())
        self.K = m.K
        if self.kind == "train":
            start, gen_state = self._state(), m._gen.get_state()
            self.call()
        else:  # the fit's start; requests leave the trained state as it is
            start, gen_state = self._fit["start"], self._fit["gen"]
        self._checked = dict(start=start, gen=gen_state, end=self._state(),
                             ph=_host(m.ph_hat), th=torch.as_tensor(m.th_hat),
                             word_ids=dict(m.w_to_v))

    def free(self) -> None:
        self.model = None

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared with the reference (``limits/<cell>.json``
        holds each one's limit).  ``control=True`` judges the reference
        itself run in bfloat16 in the program's place, from the same
        state and draws."""
        ref.check_layout(self.layout, self.words, self.labels, self.corpus.train_docs,
                         self.corpus.train_labs, ROOT)
        return (self._check_train if self.kind == "train" else self._check_predict)(control)

    def _on_device(self, state: "ref.State") -> "ref.State":
        d = self.device
        return ref.State(tuple(z.to(d) for z in state.z), tuple(x.to(d) for x in state.n_dk),
                         state.n_vk.to(d), state.n_k.to(d))

    def _follow(self, iters: int, thinning: int, total_iters: int, control: bool,
                prefix: str = ""):
        """The recorded call (``iters`` sweeps from the recorded start and
        generator state) against the reference's; returns the numbers
        compared, and the φ̂ (V, Kp) of the reference and of the side judged
        (the program's, or the control's)."""
        ck, a = self._checked, self.config["model_args"]
        start = self._on_device(ck["start"])
        V, Kp = start.n_vk.shape
        recount = ref.recount(self.layout, start.z, V, Kp)
        start_off = sum(int((x != y).sum()) for x, y in zip(
            (*recount.n_dk, recount.n_vk, recount.n_k), (*start.n_dk, start.n_vk, start.n_k)))
        live = [torch.as_tensor(b.tok_f.T > 0, device=self.device) for b in self.layout]
        valid = [torch.as_tensor(b.lab_valid.T > 0, device=self.device) for b in self.layout]
        start_off += sum(int((~torch.gather(v, 0, z.long()) & l).sum())
                         for v, z, l in zip(valid, start.z, live))
        merge = ref.merge_block_size(a["merge_every"], thinning, total_iters)

        def follow(dtype):
            gen = torch.Generator(device=self.device)
            gen.set_state(ck["gen"])
            return ref.train_call(self.layout, start, gen, a["alpha"], a["beta"], self.K,
                                  iters, thinning, merge, dtype)

        end, ph, th = follow(torch.float32)
        th = torch.cat(th)  # θ̂ of the documents in bucket order
        if control:  # the reference in bfloat16 in the program's place
            got, got_ph, got_th = follow(torch.bfloat16)
            got_th = torch.cat(got_th)
        else:
            order = np.concatenate([b.doc_idx for b in self.layout])
            got, got_ph, got_th = self._on_device(ck["end"]), ck["ph"], ck["th"][order]
        z_off = sum(int(((x != y) & l).sum()) for x, y, l in zip(got.z, end.z, live))
        n_live = sum(int(l.sum()) for l in live)
        pairs = list(zip((*got.n_dk, got.n_vk, got.n_k), (*end.n_dk, end.n_vk, end.n_k)))
        counts_off = sum(int((x.to(torch.float32) != y.to(torch.float32)).sum())
                         for x, y in pairs)
        n_counts = sum(x.numel() for x, _ in pairs)
        got_ph = got_ph.to(self.device, torch.float32)
        ph_got, ph_ref = got_ph[:, :self.K], ph[:, :self.K].to(torch.float32)
        th_gap = float((got_th.to(self.device, torch.float32) - th).abs().max())
        numbers = {
            "start_counts_off": start_off,
            "z_off_share": z_off / max(n_live, 1),
            "counts_off_share": counts_off / max(n_counts, 1),
            "phi_hat_rel_gap": float(((ph_got - ph_ref).abs() / ph_ref).max()),
            "theta_hat_gap": th_gap,
        }
        return {prefix + k: v for k, v in numbers.items()}, ph.to(torch.float32), got_ph

    def _check_train(self, control: bool = False) -> Dict[str, float]:
        t = self.traffic
        return self._follow(t["iters"], t["thinning"], t["total_iters"], control)[0]

    def _check_predict(self, control: bool = False) -> Dict[str, float]:
        ck, t, a, fit = self._checked, self.traffic, self.config["model_args"], self.config["fit"]
        # the fit, followed from its start: the tables the requests read
        out, phi, got_phi = self._follow(fit["iters"], fit["thinning"], fit["total_iters"],
                                         control, prefix="fit_")
        K = self.K
        tok_v, tok_f = ref.test_layout(self.corpus.test_docs, ck["word_ids"])
        tok_v = torch.as_tensor(tok_v, device=self.device)
        tok_f = torch.as_tensor(tok_f, device=self.device)
        n = len(self.requests)
        k = int(t["checked_requests"])
        picked = sorted(set(random.Random(self.seed).sample(range(n - 1), min(k - 1, n - 1)))
                        | {n - 1})
        theta_gap, rank_off, docs = 0.0, 0, 0
        for i in picked:
            state, theta, preds = self.requests[i]

            def follow(table, dtype):
                gen = torch.Generator(device=self.device)
                gen.set_state(state)
                return ref.fold_in(table, tok_v, tok_f, K, a["alpha"], t["it"], t["thinning"],
                                   gen, dtype).cpu().numpy()

            want = follow(phi, torch.float32)
            if control:  # the reference in bfloat16 in the program's place, on its own fit
                theta = follow(got_phi, torch.bfloat16)
                preds = [[(x, 0.0) for x in row] for row in ref.top_labels(theta, self.labels,
                                                                            t["top"])]
            theta_gap = max(theta_gap, float(np.abs(theta - want).max()))
            top = ref.top_labels(want, self.labels, t["top"])
            rank_off += sum(1 for p, w in zip(preds, top) if [x for x, _ in p] != w)
            docs += len(top)
        out.update(theta_gap=theta_gap, rank_off_share=rank_off / max(docs, 1))
        return out


def build(config: dict, traffic: dict, seed: int, device: str) -> Job:
    return Job(config, traffic, seed, device)
