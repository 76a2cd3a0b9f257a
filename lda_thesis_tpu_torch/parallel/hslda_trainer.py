"""Multi-chain HSLDA trainer over a ``(chains, data)`` mesh of ranks.

Counterpart of ``lda_thesis_tpu/parallel/hslda_trainer.py``.
``DistributedHSLDA`` keeps the single-chain :class:`..models.hslda.HSLDA`
API (its constructor, ``run_training``, ``run_tests``) and trains
``n_chains`` independent blocked-Gibbs chains with the documents sharded
over the mesh (:mod:`.hslda_sharded`: AD-LDA merges of the int32 deltas,
the Gram terms of η summed over the data row).  A rank's chains are a batch
axis of one z-sweep, so on a card one CUDA graph sweeps them all.

    # one process, sixteen chains batched on one card
    model = DistributedHSLDA(docs, labs, labelset, n_chains=16, k=15)
    # or, under ``python -m torch.distributed.run --nproc-per-node 4``:
    initialize_distributed()
    mesh = make_mesh(n_data=2, n_chains=2)
    model = DistributedHSLDA(docs, labs, labelset, mesh=mesh, n_chains=8)
    model.run_training(25, 5)
    scores = model.run_tests(test_docs, 250, 25)  # chain-averaged

Prediction pools the chains by model averaging of probabilities, not of
parameters: HSLDA's topics are not identifiable across chains, so each
chain folds the documents in against its own (φ̂_c, sweep φ_c, α·β_c), all
chains at once (``models/hslda.chains_test_loop``), and the scores
Φ(η_c·z̄_c − ξ) are averaged over chains.  Every rank makes the same calls;
the estimators gather over the process group.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch

from ..models.hslda import HSLDA, chain_scores, chains_test_loop
from .bootstrap import Mesh
from .hslda_sharded import (
    HSLDAShardedState,
    init_hslda_sharded,
    make_hslda_generators,
    make_hslda_train_loop,
    shard_hslda_corpus,
)
from .sharded import fold_in_seed, gather_chains, make_mesh, padded

__all__ = ["DistributedHSLDA"]


class DistributedHSLDA(HSLDA):
    """HSLDA with ``n_chains`` sharded chains; API-compatible with HSLDA.

    ``mesh`` defaults to one rank on ``device`` (CUDA unless the caller
    passes ``"cpu"``); there all ``n_chains`` chains run batched.
    ``table_shard="vocab"`` keeps each chain's table and thinned φ̂ sharded
    over the data row by vocabulary rows (bitwise the same chains).
    """

    def __init__(self, docs: Sequence[Sequence[str]], labs: Sequence[Sequence[str]],
                 labelset: Sequence[str], mesh: Optional[Mesh] = None, n_chains: int = 8,
                 table_shard: str = "replicated", device=None, **kwargs):
        self.mesh = mesh if mesh is not None else make_mesh(n_chains=1, device=device)
        if device is not None and torch.device(device).type != self.mesh.device.type:
            raise ValueError(f"device {device} differs from the mesh's {self.mesh.device}")
        if int(n_chains) < 1 or int(n_chains) % self.mesh.shape["chains"]:
            raise ValueError(f"n_chains={n_chains} is not a positive multiple of the mesh "
                             f"chains axis {self.mesh.shape['chains']}")
        if table_shard not in ("replicated", "vocab"):
            raise ValueError(f"unknown table_shard {table_shard!r}")
        self.n_chains = int(n_chains)
        self.table_shard = table_shard
        super().__init__(docs, labs, labelset, device=self.mesh.device, **kwargs)

    def _init_state(self) -> None:
        """The sharded corpus, the chains' generators and their initial
        state (``hslda_sharded.init_hslda_sharded``); the fold-in draws
        from ``_gen``, seeded the same on every rank."""
        mesh = self.mesh
        self._gen.manual_seed(fold_in_seed(self.seed))
        self._gens = make_hslda_generators(mesh, self.n_chains, self.seed)
        self.corpus = shard_hslda_corpus(mesh, self.tok_v.cpu().numpy(),
                                         self.mask.cpu().numpy(), self.labs.cpu().numpy())
        self._Vp = padded(self.V, mesh.shape["data"]) if self.table_shard == "vocab" \
            else self.V
        self.state: HSLDAShardedState = init_hslda_sharded(
            mesh, self.corpus, self.V, self.K, self.n_chains, self._gens, alpha=self.alpha,
            aprime=self.aprime, mu=self.mu, table_shard=self.table_shard)
        self._ph_hat: Optional[torch.Tensor] = None  # (L, K, rows) thinned per-chain φ̂
        self._n_saves = 0
        self._loops = {}  # opt -> HSLDAShardedLoop

    # ------------------------------------------------------------------ train

    def _loop(self, opt: int):
        if self.mesh is None:
            raise RuntimeError("an unpickled multi-rank DistributedHSLDA has no mesh: "
                               "further training needs one")
        if opt not in self._loops:
            self._loops[opt] = make_hslda_train_loop(
                self.mesh, self.corpus, self.n_chains, self._stirling_logs, D_total=self.D,
                alpha=self.alpha, aprime=self.aprime, gamma=self.gamma, mu=self.mu,
                sigma=self.sigma, xi=self.xi, opt=opt, table_shard=self.table_shard,
                V=self.V)
        return self._loops[opt]

    def run_training(self, it: int = 25, thinning: int = 5, opt: int = 1,
                     continue_avg: bool = False) -> None:
        """``it`` blocked-Gibbs cycles of every chain, with the per-chain φ̂
        folded into the thinned mean after every ``thinning``-th cycle.
        ``continue_avg=True`` carries the mean across calls (chunked or
        resumed training); the default restarts it, as ``HSLDA`` does."""
        if not continue_avg:
            self._n_saves = 0
            self._ph_hat = None
        st = self.state
        ph = (torch.zeros((st.n_vk.shape[0], self.K, st.n_vk.shape[1]), dtype=torch.float32,
                          device=self.device) if self._ph_hat is None else self._ph_hat)
        self.state, ph, self._n_saves = self._loop(int(opt))(
            st, ph, self._n_saves, int(it), int(thinning), self._gens)
        self._ph_hat = ph if self._n_saves else None
        self._cycles_done += int(it)

    # ------------------------------------------------------------ estimators

    def _gathered(self, x: torch.Tensor, axis: Optional[int] = None) -> torch.Tensor:
        """Every chain's ``x`` (this rank's (L, …)) as (C, …); ``axis`` is the
        vocabulary axis of a vocab-sharded array, cut back to the true V."""
        vocab = axis is not None and self.table_shard == "vocab"
        if self.mesh is None:
            if vocab and x.shape[axis] != self._Vp:
                raise RuntimeError("an unpickled vocab-sharded model holds only its rank's "
                                   "table rows and cannot predict")
            out = x
        elif vocab:
            out = gather_chains(self.mesh, x, self.n_chains, shard_axis=axis, full=self._Vp)
        else:
            out = gather_chains(self.mesh, x, self.n_chains)
        if axis is not None:
            out = out.narrow(axis, 0, self.V)
        return out

    def _chain_ph(self) -> np.ndarray:
        """(C, K, V) per-chain unsmoothed topic-word estimates (float64)."""
        n_kv = self._gathered(self.state.n_vk, 1).cpu().numpy().transpose(0, 2, 1)
        n_kv = n_kv.astype(np.float64)
        return n_kv / np.maximum(n_kv.sum(axis=2, keepdims=True), 1)

    # The inherited diagnostics would read a single-chain state; topics are
    # not identifiable across chains, so they report chain 0 and
    # ``_chain_ph()`` gives every chain.

    def get_ph(self) -> np.ndarray:
        """(K, V) chain-0 unsmoothed topic-word estimate."""
        return self._chain_ph()[0]

    def get_zbar(self) -> np.ndarray:
        """(D, K) chain-0 empirical topic mixtures over the real documents."""
        n_dk = self.state.n_dk
        if self.mesh is not None:
            n_dk = gather_chains(self.mesh, n_dk, self.n_chains, shard_axis=1,
                                 full=n_dk.shape[1] * self.mesh.shape["data"])
        n_dk = n_dk[0, : self.D].cpu().numpy()
        n_d = np.maximum(self.mask.sum(dim=1).cpu().numpy(), 1)
        return n_dk / n_d[:, None]

    # ------------------------------------------------------------ persistence
    #
    # A mesh holds process groups, and a captured graph does not pickle: the
    # pickle keeps the rank's state and the mesh's shape.  A model pickled
    # from one rank comes back on a one-rank mesh and can train on; one
    # pickled from a rank of a larger mesh has no mesh, predicts from the
    # chains its rank held (replicated tables), and needs a mesh to train.

    def __getstate__(self):
        d = super().__getstate__()
        d["_mesh_shape"] = None if self.mesh is None else (
            dict(self.mesh.shape), self.mesh.single_device)
        d["mesh"] = None
        d["_loops"] = {}
        return d

    def __setstate__(self, d):
        shape = d.pop("_mesh_shape", None)
        self.__dict__.update(d)
        if shape is not None and shape[1]:
            self.mesh = Mesh(shape[0]["chains"], shape[0]["data"], self.device)

    # ------------------------------------------------------------------- test

    def run_tests(self, newdocs: Sequence[Sequence[str]], it: int = 250,
                  s: int = 25) -> np.ndarray:
        """Chain-averaged label probabilities for held-out documents: every
        chain folds the documents in against its own (φ̂_c, sweep φ_c,
        α·β_c), all chains in one fold-in, and Φ(η_c·z̄_c − ξ) is averaged
        over the chains."""
        tok_v, mask = self._encode_test(newdocs)
        st = self.state
        if self._ph_hat is not None:
            ph = self._gathered(self._ph_hat, 2).cpu().numpy()
        else:
            ph = self._chain_ph().astype(np.float32)
        init_phi = torch.as_tensor(np.ascontiguousarray(ph.transpose(0, 2, 1)),
                                   dtype=torch.float32, device=self.device)  # (C, V, K)
        sweep = self._gathered(st.n_vk, 1).cpu().numpy().astype(np.float64) + self.gamma
        sweep = sweep / sweep.sum(axis=1, keepdims=True)  # normalise over V
        sweep_phi = torch.as_tensor(sweep, dtype=torch.float32, device=self.device)
        ab = self.alpha * self._gathered(st.beta)  # (C, K)
        zbar = chains_test_loop(tok_v, mask, init_phi, sweep_phi, ab, it=int(it),
                                thinning=int(s), generator=self._gen)
        return chain_scores(zbar.cpu().numpy(), self._gathered(st.eta).cpu().numpy(),
                            self.xi)
