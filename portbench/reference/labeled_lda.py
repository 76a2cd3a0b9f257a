"""Plain reference of Labeled LDA's timed paths (Ramage '09, the thesis's
``LabeledLDA.py``): the merge-block Gibbs sampler with its thinned saves,
and the frozen-φ̂ fold-in with the top-n label ranking.

Plain PyTorch, written from the algorithm; it imports nothing of the
program.  It follows the program from a state the program reached (its
counts and its generator's state at a call's start, or its trained φ̂), so
it draws the same uniforms in the same order: per merge block, one
``(M, U_g, D_g)`` block of uniforms per length bucket, bucket by bucket;
per fold-in, one ``(U, D)`` block for the init pass and one per sweep.
Everything the program derived from the corpus (its bucket layout, label
slots and vocabulary ids) is checked against the corpus itself before it
is used (:func:`check_layout`).

The sampler's arithmetic follows the algorithm's stated order, so that a
sound run agrees draw for draw: a type position with frequency f draws a
slot a of its document with weight

    valid_a · (n_da − f·[a = z] + α) · ((cv_a − own_a) + β) · (1 / (n̄_a − own_a))

where cv and n̄ = n_k + Vβ are the block-start table's and own_a = f·[a =
z₀] is the position's own block-start count, by inverse CDF over an
inclusive scan taken in groups of eight slots (Hillis–Steele inside a
group, then each group adds the sum of the groups before it in sequence).
``dtype`` sets the precision of every floating-point number of the draw
and of the counts: the control runs it in bfloat16.
"""

from __future__ import annotations

from collections import Counter
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

GROUP = 8  # slots per group of the draw's scan


class Bucket(NamedTuple):
    """One length bucket of the training documents, doc-major: ``doc_idx
    (D_g,)`` original document indices, ``tok_v``/``tok_f (D_g, U_g)`` word
    ids and frequencies (f = 0 pads), ``lab_ids``/``lab_valid (D_g, A)``
    label slots."""

    doc_idx: np.ndarray
    tok_v: np.ndarray
    tok_f: np.ndarray
    lab_ids: np.ndarray
    lab_valid: np.ndarray


class State(NamedTuple):
    """A Gibbs state: per bucket ``z (U_g, D_g)`` slots and ``n_dk (A,
    D_g)`` counts, and the tables ``n_vk (V, Kp)``, ``n_k (Kp,)``."""

    z: Tuple[torch.Tensor, ...]
    n_dk: Tuple[torch.Tensor, ...]
    n_vk: torch.Tensor
    n_k: torch.Tensor


def check_layout(buckets: Sequence[Bucket], words: Sequence[str], labels: Sequence[str],
                 docs: Sequence[Sequence[str]], labs: Sequence[Sequence[str]],
                 root: str) -> None:
    """Raise ``ValueError`` unless the buckets hold every document once,
    each with exactly its words' counts and its labels plus ``root``
    (``words[v]`` names id v, ``labels[k]`` topic k)."""
    seen = np.zeros(len(docs), bool)
    for b in buckets:
        for r, d in enumerate(b.doc_idx):
            if seen[d]:
                raise ValueError(f"document {d} is in two buckets")
            seen[d] = True
            live = b.tok_f[r] > 0
            got = Counter({words[v]: int(f) for v, f in zip(b.tok_v[r][live], b.tok_f[r][live])})
            if live.sum() != len(got) or got != Counter(docs[d]):
                raise ValueError(f"document {d}'s word counts differ from the corpus")
            slots = b.lab_ids[r][b.lab_valid[r] > 0]
            if sorted(labels[k] for k in slots) != sorted(set(labs[d]) | {root}):
                raise ValueError(f"document {d}'s label slots differ from its labels")
    if not seen.all():
        raise ValueError(f"{int((~seen).sum())} documents are in no bucket")


def merge_block_size(merge_every: int, thinning: int, budget: int) -> int:
    """The merge block M of a run: the largest divisor of ``thinning`` at
    most ``merge_every``, and at most ``budget // 8`` for short runs."""
    cap = min(int(merge_every), max(1, int(budget) // 8))
    return max((m for m in range(1, cap + 1) if int(thinning) % m == 0), default=1)


def recount(buckets: Sequence[Bucket], z: Sequence[torch.Tensor], V: int, Kp: int) -> State:
    """The counts of the slot assignment ``z`` (per bucket ``(U_g, D_g)``)."""
    dev = z[0].device
    n_vk = torch.zeros((V, Kp), dtype=torch.float64, device=dev)
    n_dk = []
    for b, zb in zip(buckets, z):
        f = torch.as_tensor(b.tok_f.T, device=dev).to(torch.float64)  # (U, D)
        ids = torch.as_tensor(b.lab_ids.T, device=dev).long()  # (A, D)
        A, D = ids.shape
        counts = torch.zeros((A, D), dtype=torch.float64, device=dev)
        counts.scatter_add_(0, zb.long(), f)
        n_dk.append(counts.to(torch.float32))
        topic = torch.gather(ids, 0, zb.long())  # (U, D)
        v = torch.as_tensor(b.tok_v.T, device=dev).long()
        n_vk.index_put_((v.reshape(-1), topic.reshape(-1)), f.reshape(-1), accumulate=True)
    return State(tuple(zb.clone() for zb in z), tuple(n_dk), n_vk.to(torch.float32),
                 n_vk.sum(dim=0).to(torch.float32))


def _grouped_scan(w: torch.Tensor) -> torch.Tensor:
    """Inclusive scan of ``w (A, D)`` over its slots, in groups of eight."""
    A, D = w.shape
    groups = -(-A // GROUP)
    c = torch.cat([w, w.new_zeros((groups * GROUP - A, D))]).view(groups, GROUP, D)
    step = 1
    while step < GROUP:
        c = torch.cat([c[:, :step], c[:, step:] + c[:, :-step]], dim=1)
        step *= 2
    carry = w.new_zeros((D,))
    out = [c[0]]
    for h in range(1, groups):
        carry = carry + c[h - 1, GROUP - 1]
        out.append(carry[None] + c[h])
    return torch.cat(out)[:A]


def _block(bucket: Bucket, z0: torch.Tensor, ndk: torch.Tensor, n_vk: torch.Tensor,
           n_k: torch.Tensor, u: torch.Tensor, alpha: float, beta: float, vbeta: float,
           dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bucket's M sweeps against the table frozen at the block's start;
    returns the new ``(z, n_dk)``."""
    dev = z0.device
    f = torch.as_tensor(bucket.tok_f.T, device=dev).to(dtype)  # (U, D)
    v = torch.as_tensor(bucket.tok_v.T, device=dev).long()
    ids = torch.as_tensor(bucket.lab_ids.T, device=dev).long()  # (A, D)
    valid = torch.as_tensor(bucket.lab_valid.T, device=dev).to(dtype)
    A = ids.shape[0]
    slot = torch.arange(A, device=dev)[:, None]
    nbar = n_k[ids] + torch.tensor(vbeta, dtype=torch.float32).to(dtype)  # (A, D)
    z = z0.clone()
    for m in range(u.shape[0]):
        for p in range(z.shape[0]):
            fp = f[p]
            cv = n_vk[v[p][None, :], ids]  # (A, D) the block-start table's counts
            own = torch.where(slot == z0[p], fp, 0)
            ndk = ndk - torch.where(slot == z[p], fp, 0)
            w = valid * (ndk + alpha)
            w = w * ((cv - own) + beta)
            w = w * torch.reciprocal(nbar - own)
            c = _grouped_scan(w)
            draw = (c < u[m, p].to(dtype) * c[A - 1]).sum(dim=0)
            draw = torch.where(fp > 0, draw, z[p].long())
            ndk = ndk + torch.where(slot == draw, fp, 0)
            z[p] = draw.to(z.dtype)
    return z, ndk


def _commit(bucket: Bucket, z0: torch.Tensor, z1: torch.Tensor, n_vk: torch.Tensor):
    """The table after moving every position's tokens from its block-start
    topic to its block-end topic; the topic totals are its column sums."""
    dev = z0.device
    f = torch.as_tensor(bucket.tok_f.T, device=dev).to(torch.float64)
    v = torch.as_tensor(bucket.tok_v.T, device=dev).long().reshape(-1)
    ids = torch.as_tensor(bucket.lab_ids.T, device=dev).long()
    table = n_vk.to(torch.float64)
    table.index_put_((v, torch.gather(ids, 0, z0.long()).reshape(-1)), -f.reshape(-1),
                     accumulate=True)
    table.index_put_((v, torch.gather(ids, 0, z1.long()).reshape(-1)), f.reshape(-1),
                     accumulate=True)
    return table.to(n_vk.dtype), table.sum(dim=0).to(n_vk.dtype)


def _mean(avg: Optional[torch.Tensor], cur: torch.Tensor, s: int) -> torch.Tensor:
    """The thinned mean after save ``s``: (s−1)/s of the old and 1/s of the new."""
    if avg is None or s <= 1:
        return cur.clone()
    s32 = np.float32(s)
    return float((s32 - np.float32(1)) / s32) * avg + cur * float(np.float32(1) / s32)


def _estimates(buckets, state: State, alpha: float, beta: float, K: int):
    """φ (V, Kp), zero past the K real topics, and θ per bucket (D_g, Kp)."""
    V, Kp = state.n_vk.shape
    n_vk, n_k = state.n_vk.to(torch.float32), state.n_k.to(torch.float32)
    phi = (n_vk + beta) / (n_k + V * beta)
    phi[:, K:] = 0
    thetas = []
    for b, ndk in zip(buckets, state.n_dk):
        dev = ndk.device
        valid = torch.as_tensor(b.lab_valid, device=dev)
        num = ndk.T.contiguous().to(torch.float32) + valid * alpha  # (D, A)
        num = num / torch.clamp(num.sum(dim=1, keepdim=True), min=1e-38)
        th = torch.zeros((num.shape[0], Kp), dtype=torch.float32, device=dev)
        th.scatter_add_(1, torch.as_tensor(b.lab_ids, device=dev).long(), num * valid)
        thetas.append(th)
    return phi, thetas


def train_call(buckets: Sequence[Bucket], start: State, generator: torch.Generator,
               alpha: float, beta: float, K: int, iters: int, thinning: int, merge: int,
               dtype=torch.float32):
    """One training call from ``start``: ``iters`` sweeps in merge blocks
    of ``merge``, a save at every ``thinning``-th sweep; returns the end
    state, φ̂ (V, Kp) and θ̂ per bucket (the saves' thinned means)."""
    V = start.n_vk.shape[0]
    vbeta = float(V * beta)
    state = State(start.z, tuple(x.to(dtype) for x in start.n_dk), start.n_vk.to(dtype),
                  start.n_k.to(dtype))
    ph = None
    th: List[Optional[torch.Tensor]] = [None] * len(buckets)
    saves = 0

    def block(M: int) -> State:
        dev = state.n_vk.device
        us = [torch.rand((M, b.tok_v.shape[1], b.tok_v.shape[0]), generator=generator,
                         device=dev) for b in buckets]
        n_vk, n_k = state.n_vk, state.n_k
        zs, ndks = [], []
        for b, z0, ndk, u in zip(buckets, state.z, state.n_dk, us):
            z1, ndk1 = _block(b, z0, ndk, n_vk, n_k, u, alpha, beta, vbeta, dtype)
            n_vk, n_k = _commit(b, z0, z1, n_vk)
            zs.append(z1)
            ndks.append(ndk1)
        return State(tuple(zs), tuple(ndks), n_vk, n_k)

    for _ in range(iters // thinning):
        for _ in range(thinning // merge):
            state = block(merge)
        saves += 1
        cur_ph, cur_th = _estimates(buckets, state, alpha, beta, K)
        ph = _mean(ph, cur_ph, saves)
        th = [_mean(a, c, saves) for a, c in zip(th, cur_th)]
    left = iters - (iters // thinning) * thinning
    while left > 0:
        state = block(min(merge, left))
        left -= min(merge, left)
    return state, ph, th


def test_layout(docs: Sequence[Sequence[str]], word_ids: Dict[str, int]):
    """Held-out documents as ``tok_v``/``tok_f (D, U)``: each document's word
    types in id order with their counts, words without an id left out, U
    the most types of a document rounded up to a multiple of eight."""
    bows = [sorted(Counter(word_ids[w] for w in doc if w in word_ids).items())
            for doc in docs]
    U = -(-max([1] + [len(b) for b in bows]) // 8) * 8
    tok_v = np.zeros((len(docs), U), np.int64)
    tok_f = np.zeros((len(docs), U), np.int64)
    for d, bow in enumerate(bows):
        for n, (v, f) in enumerate(bow):
            tok_v[d, n], tok_f[d, n] = v, f
    return tok_v, tok_f


def fold_in(phi: torch.Tensor, tok_v: torch.Tensor, tok_f: torch.Tensor, K: int,
            alpha: float, it: int, thinning: int, generator: torch.Generator,
            dtype=torch.float32) -> torch.Tensor:
    """θ̂ (D, K) of held-out documents against a frozen ``phi (V, Kp)``.

    z is drawn per type from φ̂'s column for the word (uniform over the K
    real topics where the column is all zero); then ``it`` sweeps, each
    position drawing with weight (n_dk − f·[k = z] + α)·φ̂[v, k], and the
    normalised counts averaged at every ``thinning``-th sweep."""
    D, U = tok_v.shape
    dev = phi.device
    phi = phi.to(dtype)
    f = tok_f.to(dtype)
    real = (torch.arange(phi.shape[1], device=dev) < K).to(dtype)
    u = torch.rand((U, D), generator=generator, device=dev)
    n_dk = torch.zeros((D, phi.shape[1]), dtype=dtype, device=dev)
    z = torch.empty((D, U), dtype=torch.long, device=dev)
    for p in range(U):
        w = phi[tok_v[:, p]]
        w = torch.where(w.sum(dim=1, keepdim=True) <= 0, real[None, :], w)
        c = torch.cumsum(w, dim=1)
        z[:, p] = (c < (u[p].to(dtype) * c[:, -1])[:, None]).sum(dim=1)
        n_dk.scatter_add_(1, z[:, p, None], f[:, p, None])
    avg, saves = None, 0
    for i in range(int(it)):
        u = torch.rand((U, D), generator=generator, device=dev)
        for p in range(U):
            fp = f[:, p]
            n_dk.scatter_add_(1, z[:, p, None], -fp[:, None])
            c = torch.cumsum((n_dk + alpha) * phi[tok_v[:, p]], dim=1)
            new = (c < (u[p].to(dtype) * c[:, -1])[:, None]).sum(dim=1)
            new = torch.where(fp > 0, new, z[:, p])
            n_dk.scatter_add_(1, new[:, None], fp[:, None])
            z[:, p] = new
        if (i + 1) % int(thinning) == 0:
            saves += 1
            cur = n_dk.to(torch.float32) / torch.clamp(
                n_dk.to(torch.float32).sum(dim=1, keepdim=True), min=1.0)
            avg = _mean(avg, cur, saves)
    if avg is None:
        return torch.zeros((D, K), dtype=torch.float32, device=dev)
    return avg[:, :K]


def top_labels(theta: np.ndarray, labels: Sequence[str], n: int) -> List[List[str]]:
    """Each document's ``n`` labels of highest score, highest first."""
    names = np.asarray(labels)
    return [names[np.argsort(-row)[:n]].tolist() for row in theta]
