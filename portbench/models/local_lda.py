"""LocalLDA cells: the port's ``LocalLDA`` on the configuration's corpus, in
an order drawn from the run's seed (``corpus.for_run``), and seeded with it.

The configuration gives the corpus generator, its seed and sizes
(``corpus``: its training documents are the abstracts; labels are unused)
and the model's settings (``model_args``, passed to ``LocalLDA`` as the
CLI passes its flags).  Each document is rendered as one line of text
(:func:`text`) whose words LocalLDA's preprocessing leaves as they are, so
that the model reads the texts as the CLI reads a CSV's text column.  The
traffic mix's call is ``"train"``: ``run_training(iters, thinning,
total_iters=total_iters)``, a chunk of a longer run, as
``cli/evaluate_local_lda`` calls it; its work is ``n_tokens · iters`` token
draws.

LocalLDA's sampler is Labeled LDA's over K identity slots, all valid, so
the job is ``labeled_lda.Job``'s training job with its own set-up, call,
work and record: after the window one more call is made from a recorded
state (its counts and its generator's state), and the check, once the
layout is checked against the corpus text, follows it draw for draw
(``labeled_lda.Job._follow``).  The model's own generator (``model._gen``)
is the one private attribute read.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from portbench import corpus as corpora
from portbench import work as counted
from portbench.models import labeled_lda
from portbench.reference import local_lda as ref

# the letters of a word's four base-19 digits: consonants only, no "s" or
# "y", so that no stopword, suffix or lemma rule of the preprocessing applies
LETTERS = "bcdfghjklmnpqrtvwxz"


def word(v: int) -> str:
    """Word ``v`` of a synthetic corpus as "q" and four base-19 digits over
    ``LETTERS``, which preprocessing leaves unchanged.  The benchmark keeps
    its own copy of ``chip_smoke.csv_word``'s rule, so that its corpus does
    not move with the smoke script."""
    digits = []
    for _ in range(4):
        v, r = divmod(v, len(LETTERS))
        digits.append(LETTERS[r])
    return "q" + "".join(reversed(digits))


def text(doc: List[str]) -> str:
    """A document of the corpus (words ``w<v>``) as one line of text."""
    return " ".join(word(int(w[1:])) for w in doc)


class Job(labeled_lda.Job):
    def __init__(self, config: dict, traffic: dict, seed: int, device: str):
        from lda_thesis_tpu_torch.models.local_lda import LocalLDA

        if traffic["call"] != "train" or traffic.get("perplexity"):
            raise ValueError("a LocalLDA cell runs training calls without perplexity")
        self.config, self.traffic, self.seed, self.kind = config, traffic, seed, "train"
        self.device = torch.device(device)
        t0 = time.perf_counter()
        self.corpus = corpora.for_run(config["corpus"], seed)
        self.texts = [text(d) for d in self.corpus.train_docs]
        t1 = time.perf_counter()
        self.model = LocalLDA(self.texts, seed=seed, device=device, **config["model_args"])
        t2 = time.perf_counter()
        for _ in range(int(traffic["warm_calls"])):
            self.call()
        self.phases = {"corpus": t1 - t0, "model": t2 - t1, "warm-up": time.perf_counter() - t2}

    def call(self) -> float:
        t, m = self.traffic, self.model
        m.run_training(t["iters"], t["thinning"], total_iters=t["total_iters"])
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        return float(m.n_tokens * t["iters"])

    def work(self) -> dict:
        """The counted work of one call (``portbench/work.py``): its
        operations and kernel 1's bound per merge block, every document
        drawing over the K topics, one launch a block."""
        m, t = self.model, self.traffic
        K = m.K
        types = [len(set(d)) for d in ref.documents(self.texts)]
        topics = [K] * len(types)
        saves = t["iters"] // t["thinning"]
        merge = ref.merge_block_size(self.config["model_args"]["merge_every"], t["thinning"],
                                     t["total_iters"])
        tf = m.buckets.tok_f[0]
        return {
            "ops_per_call": (t["iters"] * counted.llda_sweep_ops(types, topics)
                             + saves * counted.llda_save_ops(m.V, K, topics)),
            "kernel1_bound_s_per_block": counted.kernel1_launch_bound_s(
                sum(types) * K, sum(types), tf.shape[1], tf.shape[0], len(types) * K, merge),
            "launches_per_block": float(m.buckets.n_buckets),
        }

    def after_window(self) -> None:
        """Record what the check needs while the model is alive: the
        layout, then one more call from a recorded start and generator.
        The model's θ̂ (D, K) is taken with the reference's Kp − K topic
        columns past K, which are zero on both sides."""
        m = self.model
        self.layout = [ref.Bucket(ix, tv, tf, li.cpu().numpy(), lv.cpu().numpy())
                       for ix, tv, tf, li, lv in zip(m.buckets.doc_idx, m.buckets.tok_v,
                                                     m.buckets.tok_f, m.lab_ids_t,
                                                     m.lab_valid_t)]
        self.words = [m.v_to_w[v] for v in range(m.V)]
        self.K = m.K
        start, gen_state = self._state(), m._gen.get_state()
        self.call()
        Kp = start.n_vk.shape[1]
        self._checked = dict(start=start, gen=gen_state, end=self._state(),
                             ph=torch.as_tensor(np.ascontiguousarray(m.ph_hat.T)),
                             th=torch.as_tensor(np.pad(m.th_hat, ((0, 0), (0, Kp - m.K)))))

    def check(self, control: bool = False) -> Dict[str, float]:
        """The numbers compared with the reference (``limits/<cell>.json``
        holds each one's limit), once the program's layout is the corpus
        text's: the recorded call against the reference's from the same
        start and generator state.  ``control=True`` judges the reference
        itself run in bfloat16 in the program's place."""
        t = self.traffic
        Kp = self._checked["start"].n_vk.shape[1]
        ref.check_layout(self.layout, self.words, ref.documents(self.texts), self.K, Kp)
        ref.plain_float32()
        return self._follow(t["iters"], t["thinning"], t["total_iters"], control)[0]


def build(config: dict, traffic: dict, seed: int, device: str) -> Job:
    return Job(config, traffic, seed, device)
