"""HSLDA over a ``(chains, data)`` mesh of ranks: many chains, sharded documents.

Counterpart of ``lda_thesis_tpu/parallel/hslda_sharded.py``.  Rank ``r`` is
mesh cell ``(ci, di) = divmod(r, n_data)`` (:class:`.bootstrap.Mesh`) and
holds its ``L = n_chains // mesh_chains`` local chains over its shard of
``D_s = D_p / n_data`` documents (the document axis padded to ``D_p`` with
all-zero rows: no token and no label, the root's included, as JAX pads).
Per blocked-Gibbs cycle (``models/hslda._train_cycle``'s semantics,
reference HSLDA.py:312-317) the variable groups distribute as:

* **z**: every local chain sweeps the rank's documents against its full
  table in one sweep (``ops/hslda_gibbs``, the chains as a batch axis; on a
  card one CUDA graph for all of them); the int32 table deltas are summed
  over the data row (AD-LDA).  ``table_shard="vocab"`` keeps each chain's
  table rows ``vocab_sharded.vocab_rows`` on the rank: the cycle assembles
  a transient full view with one ``all_reduce`` of zero-padded blocks
  (``vocab_sharded.full_table``), sweeps against it with the true ``V·γ``,
  and keeps its rows of the summed deltas (JAX's ``psum_scatter``);
* **η**: the Gram terms z̄ᵀz̄ (L, K, K) and z̄ᵀa (L, K, L_lab) are summed
  over the data row in one ``all_reduce`` and every replica of a chain
  draws the same η from the chain's replicated generator;
* **a**: truncated normals of the rank's documents;
* **m**: Antoniak draws of the rank's documents; ``mdot`` is the data row's
  sum of the integer totals divided by the true document count;
* **β**: the same Dirichlet draw on every replica of a chain.

Counts are int32, so every sum is exact on any backend: the replicas of a
chain stay bitwise equal, and the vocab-sharded run draws the chains of the
replicated one.

**Random streams.**  Global chain ``g = ci·L + j`` draws, on data shard
``di``, from a shard-local generator seeded by ``sharded.chain_seed(seed,
g, di)``: θ₀, the init z and a, each cycle's z noise, a's uniforms and m's
noise.  It also has a chain-replicated generator, seeded by
``chain_seed(seed, g, CHAIN_SHARD)`` on every shard of its data row: the
init η and β and each cycle's η normals and β Gammas, so the replicas draw
the same η and β without a broadcast (JAX's chain key).  ``CHAIN_SHARD =
2^16 − 1`` is no data shard's index: a mesh of that many data shards is
refused.  Every draw also takes its noise as an input
(``models/hslda.CycleNoise`` with a chain axis), for comparison with JAX.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional

import numpy as np
import torch

from ..models.hslda import (
    CycleNoise,
    CycleStep,
    a_block,
    antoniak_draw,
    beta_block,
    eta_draw,
    eta_gram,
    per_chain,
)
from ..models.state import running_average
from ..ops.gibbs import SaveStep
from ..ops.hslda_gibbs import HSLDASweep, hslda_init_counts
from .bootstrap import Mesh
from .sharded import chain_seed, gather_chains, local_chains, mean_in_order, padded, shard_rows
from .vocab_sharded import full_table, vocab_rows

__all__ = ["HSLDAShardedState", "HSLDAShardCorpus", "HSLDAGenerators", "CHAIN_SHARD",
           "make_hslda_generators", "shard_hslda_corpus", "init_hslda_sharded",
           "HSLDAShardedLoop", "make_hslda_train_step", "make_hslda_train_loop",
           "chain_ph", "pooled_ph"]

CHAIN_SHARD = 2**16 - 1  # the shard index of the chain-replicated generators' seeds


class HSLDAShardedState(NamedTuple):
    """This rank's chains (leading axis: local chains)."""

    z: torch.Tensor  # (L, D_s, N) int32
    n_dk: torch.Tensor  # (L, D_s, K) int32
    n_vk: torch.Tensor  # (L, V, K) int32, or (L, V_p/S, K): this rank's rows
    n_k: torch.Tensor  # (L, K) int32
    eta: torch.Tensor  # (L, L_lab, K)
    a: torch.Tensor  # (L, D_s, L_lab)
    beta: torch.Tensor  # (L, K)


class HSLDAShardCorpus(NamedTuple):
    """This rank's shard of the token-instance corpus."""

    tok_v: torch.Tensor  # (D_s, N) int64
    mask: torch.Tensor  # (D_s, N) int32
    labs: torch.Tensor  # (D_s, L_lab) float32


class HSLDAGenerators(NamedTuple):
    """One shard-local and one chain-replicated generator per local chain."""

    local: List[torch.Generator]
    chain: List[torch.Generator]


def make_hslda_generators(mesh: Mesh, n_chains: int, seed: int) -> HSLDAGenerators:
    """The generators of this rank's chains (see the module's streams)."""
    if mesh.shape["data"] >= CHAIN_SHARD:
        raise ValueError(f"{mesh.shape['data']} data shards: a chain's replicated "
                         f"generator takes shard index {CHAIN_SHARD}, so at most "
                         f"{CHAIN_SHARD - 1} data shards")
    L, g0 = local_chains(mesh, n_chains)

    def gen(g, di):
        out = torch.Generator(device=mesh.device)
        out.manual_seed(chain_seed(seed, g, di))
        return out

    return HSLDAGenerators(local=[gen(g0 + j, mesh.coords[1]) for j in range(L)],
                           chain=[gen(g0 + j, CHAIN_SHARD) for j in range(L)])


def shard_hslda_corpus(mesh: Mesh, tok_v, mask, labs) -> HSLDAShardCorpus:
    """Pad the document axis to the data-mesh size with all-zero rows (no
    root label, as JAX pads) and keep this rank's shard, on its device."""
    dev = mesh.device
    return HSLDAShardCorpus(
        tok_v=torch.as_tensor(shard_rows(tok_v, mesh), dtype=torch.int64, device=dev),
        mask=torch.as_tensor(shard_rows(mask, mesh), dtype=torch.int32, device=dev),
        labs=torch.as_tensor(shard_rows(np.asarray(labs, np.float32), mesh),
                             dtype=torch.float32, device=dev))


def _zbar(n_dk: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    return n_dk.to(torch.float32) / n_d[:, None]


def init_hslda_sharded(mesh: Mesh, corpus: HSLDAShardCorpus, V: int, K: int, n_chains: int,
                       generators: HSLDAGenerators, alpha: float = 1.0, aprime: float = 1.0,
                       mu: float = 0.0, table_shard: str = "replicated") -> HSLDAShardedState:
    """Per-chain prior draws and per-(chain, shard) count init
    (HSLDA.py:109-137): η and β from the chain-replicated generators, θ₀,
    z and a from the shard-local ones; the shards' tables summed over the
    data row (vocab-sharded: this rank's rows of the padded tables)."""
    L = len(generators.local)
    D_s = corpus.tok_v.shape[0]
    n_lab = corpus.labs.shape[1]
    dev = mesh.device
    eta = mu + per_chain((L, n_lab, K), generators.chain, lambda s, g: torch.randn(
        s, generator=g, device=dev, dtype=torch.float32))
    g = per_chain((L, K), generators.chain, lambda s, gen: torch._standard_gamma(
        torch.full(s, float(aprime), device=dev), generator=gen))
    beta = g / g.sum(dim=-1, keepdim=True)
    g = torch.stack([torch._standard_gamma((alpha * beta[j]).expand(D_s, K).contiguous(),
                                           generator=gen)
                     for j, gen in enumerate(generators.local)])
    theta0 = g / torch.clamp(g.sum(dim=-1, keepdim=True), min=1e-38)
    rows = padded(V, mesh.shape["data"]) if table_shard == "vocab" else V
    c = hslda_init_counts(corpus.tok_v, corpus.mask, theta0, rows, generator=generators.local)
    a, _ = a_block(_zbar(c.n_dk, corpus.mask), eta, corpus.labs, generator=generators.local)
    n_vk = mesh.data_sum_(c.n_vk)
    if table_shard == "vocab":
        n_vk = n_vk[:, vocab_rows(mesh, V)].contiguous()
    return HSLDAShardedState(z=c.z, n_dk=c.n_dk, n_vk=n_vk, n_k=mesh.data_sum_(c.n_k),
                             eta=eta, a=a, beta=beta)


def chain_ph(n_vk: torch.Tensor, n_k: torch.Tensor) -> torch.Tensor:
    """(L, K, rows) unsmoothed per-chain topic-word estimates n_kv / n_k: the
    denominator is the chain's topic total, which the table's rows sum to
    exactly (a vocab-sharded rank holds only its rows; pad rows give 0)."""
    return n_vk.to(torch.float32).transpose(1, 2) / torch.clamp(
        n_k.to(torch.float32)[:, :, None], min=1.0)


class HSLDAShardedLoop:
    """Blocked-Gibbs cycles of this rank's chains: ``loop(state, ph_hat,
    n_saves, iters, thinning, generators, noise=None) -> (state, ph_hat,
    n_saves)``.

    The loop keeps work buffers across calls: ``z`` position-major ``(N,
    L·D_s)`` and the counts.  Where the data axis is 1 and the table
    replicated, no collective lies inside a cycle, and a
    :class:`..models.hslda.CycleStep` over the buffers runs every local
    chain's whole cycle (the z noise, a's and m's from ``generators.local``,
    η's and β's from ``generators.chain``) and a ``SaveStep`` the per-chain
    φ̂ save: on a card each one replayed CUDA graph, kept across calls.
    Elsewhere one :class:`..ops.hslda_gibbs.HSLDASweep` replays the
    z-sweep and the rest of the cycle runs eagerly around its collectives.
    Each call loads ``state``, runs ``iters`` cycles and folds the
    per-chain φ̂ into the thinned mean ``ph_hat (L, K, rows)`` after every
    ``thinning``-th cycle (``running_average``'s bits, save count
    ``n_saves``), leaving the last ``iters % thinning`` unsaved; it returns
    the save runner's means where it ran a save.  ``cycles_done`` counts
    the cycles the loop has run; the draws come from the generators, which
    carry their own state.  ``noise`` (a ``CycleNoise`` with a chain axis)
    replaces one cycle's draws.
    """

    def __init__(self, mesh: Mesh, corpus: HSLDAShardCorpus, n_chains: int,
                 stirling_logs: torch.Tensor, D_total: int, alpha: float = 1.0,
                 aprime: float = 1.0, gamma: float = 1.0, mu: float = 0.0,
                 sigma: float = 1.0, xi: float = 0.0, opt: int = 1,
                 table_shard: str = "replicated", V: Optional[int] = None):
        if table_shard not in ("replicated", "vocab"):
            raise ValueError(f"unknown table_shard {table_shard!r}")
        if table_shard == "vocab" and V is None:
            raise TypeError("table_shard='vocab' requires the true vocab size V")
        self.mesh, self.corpus = mesh, corpus
        self.n_chains = int(n_chains)
        self.logs = stirling_logs
        self.D_total = int(D_total)
        self.alpha, self.aprime, self.gamma = float(alpha), float(aprime), float(gamma)
        self.mu, self.sigma, self.xi, self.opt = float(mu), float(sigma), float(xi), int(opt)
        self.vocab = table_shard == "vocab"
        self.V = V
        self.cycles_done = 0
        self._bound = False
        self._sweep = self._run = self._saves = None

    def _bind(self, state: HSLDAShardedState) -> None:
        L, D_s, N = state.z.shape
        K = state.n_k.shape[1]
        V = state.n_vk.shape[1] if self.V is None else int(self.V)
        rows = padded(V, self.mesh.shape["data"]) if self.vocab else state.n_vk.shape[1]
        dev = state.n_k.device
        self.z_t = torch.empty((N, L * D_s), dtype=torch.int32, device=dev)
        self.n_dk = torch.empty_like(state.n_dk)
        self.n_vk = torch.empty((L, rows, K), dtype=torch.int32, device=dev)
        self.n_k = torch.empty_like(state.n_k)
        cp = self.corpus
        self._bound = True
        if self.mesh.shape["data"] > 1 or self.vocab:
            # The data row's all_reduces (the table deltas, η's Gram terms,
            # mdot) sit inside the cycle.  gloo cannot be captured, and NCCL
            # takes one rank per card, so no card here could check a captured
            # one: the cycle stays eager around a replayed z-sweep.
            self._sweep = HSLDASweep(self.z_t, self.n_dk, self.n_vk, self.n_k, cp.tok_v,
                                     cp.mask, cp.labs, self.gamma, self.xi, self.opt, V)
            return
        self._run = CycleStep(self.z_t, self.n_dk, self.n_vk, self.n_k, cp.tok_v, cp.mask,
                              cp.labs, state.eta, state.a, state.beta, self.logs, self.mu,
                              self.sigma, self.aprime, self.alpha, self.gamma, self.xi, V,
                              D_total=self.D_total)
        self._saves = SaveStep(torch.zeros((L, K, rows), dtype=torch.float32, device=dev), ())

    def _estimates(self):
        return chain_ph(self.n_vk, self.n_k), ()

    def load(self, state: HSLDAShardedState) -> None:
        """Copy ``state`` into the work buffers (η, a and β into the cycle
        runner's, where it runs)."""
        if not self._bound:
            self._bind(state)
        L, D_s, N = state.z.shape
        self.z_t.copy_(state.z.permute(2, 0, 1).reshape(N, L * D_s))
        self.n_dk.copy_(state.n_dk)
        self.n_k.copy_(state.n_k)
        if self.vocab:
            self.table = state.n_vk.clone()  # the persistent table: this rank's rows
        else:
            self.n_vk.copy_(state.n_vk)
            self.table = self.n_vk
        if self._run is None:
            self.eta, self.a, self.beta = state.eta, state.a, state.beta
        else:
            self._run.load(state.eta, state.a, state.beta)
            self.eta, self.a, self.beta = self._run.params

    def state(self) -> HSLDAShardedState:
        """A snapshot of the work buffers as a state."""
        L, D_s, _ = self.n_dk.shape
        N = self.z_t.shape[0]
        return HSLDAShardedState(
            z=self.z_t.view(N, L, D_s).permute(1, 2, 0).contiguous(),
            n_dk=self.n_dk.clone(), n_vk=self.table.clone(), n_k=self.n_k.clone(),
            eta=self.eta.clone(), a=self.a.clone(), beta=self.beta.clone())

    def cycle(self, generators: Optional[HSLDAGenerators] = None,
              noise: Optional[CycleNoise] = None) -> None:
        """One cycle z → η → a → m → β of every local chain, in place."""
        mesh, corpus = self.mesh, self.corpus
        noise = noise or CycleNoise()
        local = None if generators is None else generators.local
        chain = None if generators is None else generators.chain
        if self._run is not None:
            self._run(self.opt, local, chain, noise)
            self.mdot = self._run.mdot
            self.cycles_done += 1
            return
        # z: sweep against each chain's full table, then the AD-LDA merge
        if self.vocab:
            full = full_table(mesh, self.table, self.V)
            self.n_vk.copy_(full)
        else:
            full = self.n_vk.clone()
        n_k_old = self.n_k.clone()
        self._sweep(self.eta, self.a, self.alpha * self.beta, generator=local,
                    gumbels=noise.z)
        d_vk = mesh.data_sum_(self.n_vk - full)
        d_k = mesh.data_sum_(self.n_k - n_k_old)
        if self.vocab:
            self.table += d_vk[:, vocab_rows(mesh, self.V)]
        else:
            torch.add(full, d_vk, out=self.n_vk)
        torch.add(n_k_old, d_k, out=self.n_k)

        # η from the data row's Gram terms, one all_reduce
        K = self.n_k.shape[1]
        zbar = _zbar(self.n_dk, corpus.mask)
        gram = torch.cat(eta_gram(zbar, self.a), dim=2)  # (L, K, K + L_lab)
        mesh.data_sum_(gram)
        eta = eta_draw(gram[:, :, :K], gram[:, :, K:], self.mu, self.sigma, noise.eta, chain)
        # a and m on the rank's documents; mdot over the data row
        a, _ = a_block(zbar, eta, corpus.labs, noise.a, local)
        m = antoniak_draw(self.n_dk, self.alpha, self.beta, self.logs, noise.m, local)
        mdot = mesh.data_sum_(m.sum(dim=1)).to(torch.float32) / self.D_total
        self.beta = beta_block(mdot, self.aprime, noise.beta, chain)
        self.eta, self.a, self.mdot = eta, a, mdot
        self.cycles_done += 1

    def __call__(self, state: HSLDAShardedState, ph_hat: torch.Tensor, n_saves: int,
                 iters: int, thinning: int, generators: Optional[HSLDAGenerators] = None,
                 noise: Optional[CycleNoise] = None):
        self.load(state)
        saves = self._saves
        if saves is not None and ph_hat is not None and ph_hat is not saves.ph_hat:
            saves.load(ph_hat, ())
        for i in range(int(iters)):
            self.cycle(generators, noise)
            if (i + 1) % int(thinning) == 0:
                n_saves += 1
                if saves is None:
                    ph_hat = running_average(ph_hat, chain_ph(self.table, self.n_k), n_saves)
                else:
                    saves(n_saves, self._estimates)
                    ph_hat = saves.ph_hat
        return self.state(), ph_hat, n_saves


def make_hslda_train_loop(mesh: Mesh, corpus: HSLDAShardCorpus, n_chains: int,
                          stirling_logs, D_total: int, alpha: float = 1.0,
                          aprime: float = 1.0, gamma: float = 1.0, mu: float = 0.0,
                          sigma: float = 1.0, xi: float = 0.0, opt: int = 1,
                          table_shard: str = "replicated", V: Optional[int] = None
                          ) -> HSLDAShardedLoop:
    """The multi-cycle trainer with the thinned per-chain φ̂ mean, see
    :class:`HSLDAShardedLoop`.  ``D_total`` divides ``mdot`` (the true
    document count, as ``DistributedHSLDA`` passes it); ``V`` is the true
    vocabulary size, required with ``table_shard="vocab"``."""
    return HSLDAShardedLoop(mesh, corpus, n_chains, stirling_logs, D_total, alpha, aprime,
                            gamma, mu, sigma, xi, opt, table_shard, V)


def make_hslda_train_step(mesh: Mesh, corpus: HSLDAShardCorpus, n_chains: int,
                          stirling_logs, D_total: int, alpha: float = 1.0,
                          aprime: float = 1.0, gamma: float = 1.0, mu: float = 0.0,
                          sigma: float = 1.0, xi: float = 0.0, opt: int = 1,
                          table_shard: str = "replicated", V: Optional[int] = None):
    """``step(state, generators=None, noise=None) -> state``: one sharded
    blocked-Gibbs cycle (the input is not modified)."""
    loop = make_hslda_train_loop(mesh, corpus, n_chains, stirling_logs, D_total, alpha,
                                 aprime, gamma, mu, sigma, xi, opt, table_shard, V)

    def step(state: HSLDAShardedState, generators: Optional[HSLDAGenerators] = None,
             noise: Optional[CycleNoise] = None) -> HSLDAShardedState:
        loop.load(state)
        loop.cycle(generators, noise)
        return loop.state()

    return step


def pooled_ph(state: HSLDAShardedState, gamma: float, V: Optional[int] = None,
              mesh: Optional[Mesh] = None, n_chains: Optional[int] = None,
              table_shard: str = "replicated") -> torch.Tensor:
    """(K, V) chain-pooled smoothed topic-word estimate, the mean over every
    chain in chain order (on every rank).  ``V`` is the true vocabulary
    size, required for a vocab-sharded state, whose table rows are padded
    (smoothing the pad rows would put mass on words that do not exist); it
    defaults to the table's row count.  ``mesh`` and ``n_chains`` gather
    the chains of other ranks."""
    n_vk = state.n_vk
    if table_shard == "vocab":
        if V is None or mesh is None:
            raise TypeError("a vocab-sharded state needs its mesh and the true V")
        n_vk = full_table(mesh, n_vk, V)
    if mesh is not None and not mesh.single_device:
        n_vk = gather_chains(mesh, n_vk, n_chains)
    if V is not None:
        n_vk = n_vk[:, :V]
    n_kv = n_vk.to(torch.float32).transpose(1, 2) + gamma  # (C, K, V)
    return mean_in_order(n_kv / n_kv.sum(dim=2, keepdim=True))
