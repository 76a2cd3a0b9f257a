"""CascadeLDA — label-tree ensemble of Labeled-LDA models, on PyTorch.

Counterpart of ``lda_thesis_tpu/models/cascade_lda.py`` (reference
CascadeLDA.py:56-344 and its per-node member SubLDA, CascadeLDA.py:347-434).
Each tree level is trained as one joint masked Labeled LDA: every
(document, node) membership is a row whose label mask admits only the
node's local root and the node's children present in the document.  The
masks make topic columns disjoint across nodes, so the joint sweep
factorises exactly into the independent per-node trainings.  Test inference
(``test_down_tree_batch``) runs each level as one batch of (document,
surviving node) tasks through ``ops/gibbs.cascade_test_loop``.

Samplers: ``sweep="dense"`` (``"auto"``) is the exact per-position sweep,
on a card a count commit and a draw kernel per position, the level's sweep
captured once as a CUDA graph and replayed (``ops/gibbs.ExactSweep``);
``"compact"`` is the same sampler on compact label slots; ``"fused"`` is the
merge-block sampler (ops/gibbs_fused.py) with M = ``select_merge_block(5,
s, it)``.

Shapes.  The JAX package pads rows, positions, the level topic axis and the
vocabulary to stable bucket sizes (its ``_bucket``) so that XLA compiles
each level once across splits.  PyTorch runs eagerly, so the port keeps the
natural shapes.  Padded rows (zero frequencies, all-zero mask) and padded
topics are algebraic no-ops in both, so only the draw stream differs; V·β
is passed to the sweeps as the true vocabulary size times β either way.

Reference bugs deliberately not replicated, as in the JAX package: SubLDA's
corrupting count init (CascadeLDA.py:381-385), the multinomial
renormalisation hacks (CascadeLDA.py:199-201,231-233), and NaN rows of the
unsmoothed φ for empty topics (0 here).
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..data.encode import compact_labels, encode_bow_types
from ..ops.gibbs import (
    ExactSweep,
    cascade_test_loop,
    compact_sweep,
    init_counts,
    init_counts_compact,
)
from ..ops.gibbs_fused import fused_train_block, init_fused, select_merge_block
from .state import phi_unsmoothed, running_average

__all__ = ["CascadeLDA"]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class _LevelChain:
    """One joint level training's Gibbs state and its sampler.

    ``advance(m)`` runs ``m`` sweeps (one merge block of ``m`` for the fused
    sampler); ``step`` is the sweep count a save block is made of (M for the
    fused sampler, 1 for the exact ones); ``n_vk`` is the current table.
    """

    def __init__(self, model: "CascadeLDA", tok_v, tok_f, mask: np.ndarray,
                 it: int, s: int):
        self.m = model
        R, U = tok_v.shape
        K = mask.shape[1]
        self.vbeta = float(model.V) * model.beta
        self.tv_t = tok_v.T.contiguous()
        self.tf_t = tok_f.T.to(torch.float32).contiguous()
        gen = model._gen
        if model.sweep == "dense":
            self.labs = model._t(mask, torch.float32)
            c = init_counts(tok_v, tok_f, self.labs, model.V, generator=gen)
            self.step = 1
        else:
            lab_ids, lab_valid = compact_labels(mask)
            self.li = model._t(lab_ids, torch.int64)
            self.lv = model._t(lab_valid, torch.float32)
            if model.sweep == "compact":
                c = init_counts_compact(tok_v, tok_f, self.li, self.lv, model.V, K,
                                        generator=gen)
                self.step = 1
            else:
                c = init_fused(tok_v, tok_f, self.li, self.lv, model.V, K, generator=gen)
                self.lv_t = self.lv.T.contiguous()
                self.step = select_merge_block(5, int(s), int(it))
        self.state = c
        if model.sweep != "fused":
            self.z_t = c.z.T.contiguous()
        if model.sweep == "dense":
            # on a card the level's sweep becomes one CUDA graph, replayed
            self.runner = ExactSweep(self.z_t, c.n_dk, c.n_vk, c.n_k, self.tv_t, self.tf_t,
                                     self.labs, model.alpha, model.beta, self.vbeta)

    @property
    def n_vk(self) -> torch.Tensor:
        return self.state.n_vk

    def advance(self, m: int) -> None:
        md, st = self.m, self.state
        if md.sweep == "fused":
            self.state = fused_train_block(st, self.tv_t, self.tf_t, self.li,
                                           self.lv_t, md.alpha, md.beta, m,
                                           generator=md._gen, vbeta=self.vbeta)
            return
        for _ in range(m):
            if md.sweep == "dense":
                self.runner(md._gen)
            else:
                u = torch.rand(tuple(self.tv_t.shape), generator=md._gen,
                               device=md.device)
                self.z_t = compact_sweep(self.z_t, st.n_dk, st.n_vk, st.n_k, self.tv_t,
                                         self.tf_t, self.li, self.lv, md.alpha,
                                         md.beta, self.vbeta, u)


class CascadeLDA:
    """Cascaded Labeled LDA over the 3-level JEL label tree, on ``device``
    (CUDA unless the caller passes ``"cpu"``), drawing from one
    ``torch.Generator`` seeded by ``seed``."""

    def __init__(
        self,
        docs: Sequence[Sequence[str]],
        labs: Sequence[Sequence[str]],
        labelset: Sequence[str],
        dicti,
        alpha: float = 0.001,
        beta: float = 0.001,
        seed: int = 0,
        sweep: str = "auto",
        device=None,
    ):
        self.sweep = "dense" if sweep == "auto" else sweep
        if self.sweep not in ("dense", "compact", "fused"):
            raise ValueError(f"unknown sweep {sweep!r}")
        self.device = torch.device("cuda" if device is None else device)
        self.alpha = float(alpha)
        self.beta = float(beta)
        self.dicti = dicti

        lablist = ["root"] + [x for x in labelset if x != "root"]
        self.labelmap: Dict[str, int] = {l: i for i, l in enumerate(lablist)}
        self.lablist = lablist
        self.K = len(lablist)

        self.w_to_v = dicti.token2id
        self.v_to_w = dicti.id2token
        self.V = len(dicti)
        self.D = len(docs)

        bows = [dicti.doc2bow(doc) for doc in docs]
        self.tok_v, self.tok_f = encode_bow_types(bows)  # host np arrays

        # per-depth label views (reference CascadeLDA.py:87-95)
        self.rawlabs = [list(lab) for lab in labs]
        self.l1 = [[x for x in lab if len(x) == 1] for lab in labs]
        self.l2 = [[x for x in lab if len(x) == 2] for lab in labs]
        self.l3 = [[x for x in lab if len(x) == 3] for lab in labs]
        self.lablist_l1 = [x for x in lablist if len(x) == 1]
        self.lablist_l2 = [x for x in lablist if len(x) == 2]
        self.lablist_l3 = [x for x in lablist if len(x) == 3]

        # global label-word table, reference orientation (K, V)
        self.ph = np.zeros((self.K, self.V), dtype=np.float32)
        # one record per trained level: rows, positions, topics, sweeps and
        # wall seconds
        self.level_stats: List[dict] = []

        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(int(seed))

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.ascontiguousarray(x)).to(device=self.device, dtype=dtype)

    # ------------------------------------------------------------------ train

    def _children(self, parent: str) -> List[str]:
        lvl = {1: self.lablist_l2, 2: self.lablist_l3}[len(parent)]
        return [x for x in lvl if x[: len(parent)] == parent]

    def _level_rows(
        self, parents: List[str]
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray, List[str], List[str]]:
        """The joint (doc, node) row batch of one tree level.

        Returns (row_doc_idx, mask (R, Klvl), row_root, parents, children),
        where the level topic axis is [one local root per parent] + [all
        children].
        """
        n_par = len(parents)
        children: List[str] = [c for p in parents for c in self._children(p)]
        child_col = {c: n_par + j for j, c in enumerate(children)}
        Klvl = n_par + len(children)

        row_doc: List[int] = []
        row_root: List[int] = []
        row_children: List[List[int]] = []
        for pi, p in enumerate(parents):
            lab_level = {1: self.l2, 2: self.l3}[len(p)]
            for d in range(self.D):
                if p not in self.rawlabs[d]:
                    continue
                # node-local labels: only this parent's children; everything
                # else collapses into the node root (CascadeLDA.py:119-126)
                kept = [x for x in lab_level[d] if x[: len(p)] == p]
                row_doc.append(d)
                row_root.append(pi)
                row_children.append([child_col[c] for c in kept])

        R = len(row_doc)
        mask = np.zeros((R, Klvl), dtype=np.float32)
        for r in range(R):
            mask[r, row_root[r]] = 1.0
            mask[r, row_children[r]] = 1.0
        return np.asarray(row_doc), mask, np.asarray(row_root), parents, children

    def _train_joint(self, tok_v: np.ndarray, tok_f: np.ndarray, mask: np.ndarray,
                     it: int, s: int) -> np.ndarray:
        """One joint masked training over (doc, node) rows; returns the
        thinned unsmoothed φ̂ (V, Klvl) (SubLDA.run_training,
        CascadeLDA.py:423-434).

        Saves land at exact ``s`` multiples; the trailing ``it % s`` sweeps
        run unsaved.
        """
        it, s = int(it), int(s)
        t0 = time.perf_counter()
        tv = self._t(tok_v, torch.int64)
        tf = self._t(tok_f, torch.int64)
        chain = _LevelChain(self, tv, tf, mask, it, s)
        ph_hat = torch.zeros((self.V, mask.shape[1]), dtype=torch.float32,
                             device=self.device)
        saves = 0
        for _ in range(it // s):
            for _ in range(s // chain.step):
                chain.advance(chain.step)
            saves += 1
            ph_hat = running_average(ph_hat, phi_unsmoothed(chain.n_vk), saves)
        left = it - (it // s) * s
        while left > 0:
            m = min(chain.step, left)
            chain.advance(m)
            left -= m
        out = ph_hat.cpu().numpy()
        R, U = tok_v.shape
        self.level_stats.append(dict(rows=R, positions=U, topics=mask.shape[1], sweeps=it,
                                     seconds=time.perf_counter() - t0))
        return out

    def _train_level(self, parents: List[str], it: int, s: int) -> None:
        """Jointly train all nodes of one level; splice the children's rows
        (and, for the root level, the root row) into the global φ table."""
        row_doc, mask, row_root, parents, children = self._level_rows(parents)
        if len(children) == 0 or len(row_doc) == 0:
            return
        ph_hat = self._train_joint(self.tok_v[row_doc], self.tok_f[row_doc], mask, it, s)
        n_par = len(parents)
        for j, c in enumerate(children):
            self.ph[self.labelmap[c], :] = ph_hat[:, n_par + j]
        if parents == ["root"]:
            # only the root level keeps its local-root row (CascadeLDA.py:146-147)
            self.ph[0, :] = ph_hat[:, 0]

    def go_down_tree(
        self,
        it: int,
        s: int,
        root_it: Optional[int] = None,
        root_s: Optional[int] = None,
    ) -> None:
        """Train the full tree: the root level, then the level-1 and level-2
        parents, each level as one joint batched training
        (CascadeLDA.py:135-184).

        ``root_it``/``root_s`` give the root-level model its own schedule,
        by default ``(4·it, 2·s)`` as in the JAX package; pass
        ``root_it=it, root_s=s`` for the reference's uniform schedule.
        """
        if root_it is None:
            root_it = 4 * it
        if root_s is None:
            root_s = 2 * s
        self.level_stats = []
        # root node: children = depth-1 labels, corpus = all docs
        row_mask = np.zeros((self.D, 1 + len(self.lablist_l1)), np.float32)
        row_mask[:, 0] = 1.0
        col = {c: 1 + j for j, c in enumerate(self.lablist_l1)}
        for d in range(self.D):
            for x in self.l1[d]:
                row_mask[d, col[x]] = 1.0
        ph_hat = self._train_joint(self.tok_v, self.tok_f, row_mask, root_it, root_s)
        self.ph[0, :] = ph_hat[:, 0]
        for j, c in enumerate(self.lablist_l1):
            self.ph[self.labelmap[c], :] = ph_hat[:, 1 + j]

        # level-1 parents (letters) then level-2 parents (two-char codes)
        self._train_level(self.lablist_l1, it, s)
        self._train_level(self.lablist_l2, it, s)

    # ------------------------------------------------------------------- test

    def _encode_docs(self, docs: Sequence[Sequence[str]]):
        bows = [self.dicti.doc2bow(doc) for doc in docs]
        return encode_bow_types(bows)

    def _run_tasks(
        self,
        tok_v: np.ndarray,  # (R, U)
        tok_f: np.ndarray,
        task_labels: List[List[str]],
        it: int,
        thinning: int,
    ) -> np.ndarray:
        """Batched cascade fold-in over (doc, node) tasks; returns (R, Kt) θ̂."""
        R = len(task_labels)
        Kt = _round_up(max(max(len(t) for t in task_labels), 2), 8)
        lab_ids = np.zeros((R, Kt), dtype=np.int64)
        lab_mask = np.zeros((R, Kt), dtype=np.float32)
        for r, labels in enumerate(task_labels):
            ids = [self.labelmap[x] for x in labels]
            lab_ids[r, : len(ids)] = ids
            lab_mask[r, : len(ids)] = 1.0
        avg = cascade_test_loop(
            self._t(tok_v, torch.int64), self._t(tok_f, torch.int64),
            self._t(self.ph.T, torch.float32), self._t(lab_ids, torch.int64),
            self._t(lab_mask, torch.float32), it=int(it), thinning=int(thinning),
            alpha=self.alpha, beta=self.beta, generator=self._gen)
        return avg.cpu().numpy()

    @staticmethod
    def _keep_top(th: np.ndarray, labels: List[str], threshold: float):
        """Labels kept until cumulative mass ≥ threshold (CascadeLDA.py:253-258)."""
        order = np.argsort(th)[::-1]
        loads = th[order]
        n = int((np.cumsum(loads) < threshold).sum()) + 1
        top_labs = [labels[i] for i in order[:n]]
        return list(zip(top_labs, loads[:n].tolist()))

    def test_down_tree_batch(
        self,
        docs: Sequence[Sequence[str]],
        it: int,
        thinning: int,
        threshold: float = 0.95,
    ):
        """Cascaded prediction for a batch of documents (CascadeLDA.py:249-301),
        each tree level as ONE batch over all (document, surviving-node) tasks.

        Returns (level_1, level_2, level_3): per-doc lists with the
        structure of the reference's ``test_down_tree`` output.
        """
        tok_v, tok_f = self._encode_docs(docs)
        n = len(docs)

        # level 1: the same task for every doc, over the bare letter labels
        # with no root topic (CascadeLDA.py:146-147,249-250); slot 0 = the
        # first letter receives the 1/ld init mass, as in the reference
        labels1 = self.lablist_l1
        th1 = self._run_tasks(tok_v, tok_f, [labels1] * n, it, thinning)
        level_1: List[List[Tuple[str, float]]] = []
        tasks2: List[Tuple[int, str]] = []
        for d in range(n):
            tups = self._keep_top(th1[d, : len(labels1)], labels1, threshold)
            level_1.append(tups)
            for lab, _ in tups:
                if lab != "root":
                    tasks2.append((d, lab))

        # level 2: one task per surviving (doc, letter)
        level_2: List[List[List[Tuple[str, float]]]] = [[] for _ in range(n)]
        tasks3: List[Tuple[int, str]] = []
        if tasks2:
            t_labels = [[p] + self._children(p) for _, p in tasks2]
            rows = [d for d, _ in tasks2]
            th2 = self._run_tasks(tok_v[rows], tok_f[rows], t_labels, it, thinning)
            for r, (d, p) in enumerate(tasks2):
                labels = t_labels[r]
                tups = self._keep_top(th2[r, : len(labels)], labels, threshold)
                level_2[d].append(tups)
                for lab, _ in tups:
                    if lab != p:
                        tasks3.append((d, lab))

        # level 3: one task per surviving (doc, two-char code)
        level_3: List[List[List[Tuple[str, float]]]] = [[] for _ in range(n)]
        if tasks3:
            t_labels = [[p] + self._children(p) for _, p in tasks3]
            rows = [d for d, _ in tasks3]
            th3 = self._run_tasks(tok_v[rows], tok_f[rows], t_labels, it, thinning)
            for r, (d, p) in enumerate(tasks3):
                labels = t_labels[r]
                level_3[d].append(self._keep_top(th3[r, : len(labels)], labels,
                                                 threshold))

        return level_1, level_2, level_3

    def test_down_tree(self, doc, it, thinning, threshold=0.95):
        """Single-document form of :meth:`test_down_tree_batch`
        (reference CascadeLDA.py:249)."""
        l1, l2, l3 = self.test_down_tree_batch([doc], it, thinning, threshold)
        return l1[0], l2[0], l3[0]

    def run_test(self, docs, it, thinning, depth="all") -> np.ndarray:
        """Flat (non-cascaded) fold-in over a depth-filtered φ slice
        (reference CascadeLDA.py:303-344)."""
        if depth in (1, 2, 3):
            labels = [x for x in self.lablist if len(x) in (depth, 4)]
        else:
            labels = list(self.lablist)
        tok_v, tok_f = self._encode_docs(docs)
        th = self._run_tasks(tok_v, tok_f, [labels] * len(docs), it, thinning)
        return th[:, : len(labels)]

    # ------------------------------------------------------------ diagnostics

    def topwords_per_topic(self, topwords: int = 10):
        out = []
        for lab, k in self.labelmap.items():
            idx = np.argsort(-self.ph[k])[:topwords]
            out.append([lab] + [self.v_to_w[int(v)] for v in idx])
        return out
