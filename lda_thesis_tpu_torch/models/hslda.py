"""HSLDA — Hierarchically Supervised LDA (Perotte '11), on PyTorch.

Counterpart of ``lda_thesis_tpu/models/hslda.py`` (reference HSLDA.py:82-394).
K latent topics plus a probit regression of every label on the empirical
topic mixture z̄, hierarchy-aware through sign-constrained truncated-normal
auxiliaries ``a``; blocked Gibbs over five variable groups z → η → a → m → β
(HSLDA.py:312-317), one cycle per :func:`_train_cycle`:

* z: the token-instance sweep with the probit coupling
  (``ops/hslda_gibbs``);
* η: the Bayesian-regression posterior by a Cholesky factor of the (K, K)
  precision and triangular solves (:func:`eta_block`);
* a: truncated normals by inverse CDF (:func:`a_block`);
* m: Antoniak table counts by Gumbel-max over a log Stirling table
  (:func:`antoniak_draw`, averaged over documents);
* β: a Gamma-normalised Dirichlet (:func:`beta_block`).

The linear-model blocks run in float32 as the JAX function does
(``torch.linalg.cholesky_ex``: no host sync; IEEE float32 matmuls, TF32
off as ``torch.backends.cuda.matmul.allow_tf32`` leaves it by default).
Each block takes its draws as an optional input of the JAX draw's shape,
so a test can feed JAX's.  Every block also takes a leading chain axis
(``parallel/hslda_sharded`` runs a rank's chains at once), drawing each
chain's numbers from its own generator where it is given one per chain.

JAX compiles the training loop as one program (``_train_loop_hslda``).
Here :class:`CycleStep` runs a cycle as one body (the z-sweep, z̄, η, a, m
and mdot), on a card one replayed CUDA graph per coupling, with every draw
but β's Gammas filled outside the graph in the eager order; the φ̂/z̄
saves run through ``ops/gibbs.SaveStep``.  A model keeps both runners for
its life, so its second ``run_training`` captures nothing.

The model runs on ``device`` (CUDA unless the caller passes ``"cpu"``) and
draws from one ``torch.Generator`` on that device, seeded by ``seed``:
construction draws η, β, θ₀, the init z and a in the JAX constructor's
order, and each cycle draws the z-sweep's Gumbel noise, η's normals, a's
uniforms, m's Gumbel noise and β's Gamma variates, in that order.  The
generator's state is part of a checkpoint, so a chunked or resumed run
equals the uninterrupted one draw for draw (the JAX package gets the same
from a per-cycle ``fold_in`` of its master key).  JAX's ``dispatch_chunks``
(a TPU dispatch workaround) has no counterpart: the cycles loop in Python.

Deliberate deviations from the reference, as in the JAX package: ``sample_m``
draws the table-count *index* (MIGRATION.md:57) and keeps the reference's
mean-over-documents ``mdot`` scaling; root ``''`` is label 0 and real labels
take 1..L-1; the test's thinned averaging runs once per sweep.
"""

from __future__ import annotations

from typing import Callable, Dict, List, NamedTuple, Optional, Sequence, Union

import numpy as np
import torch

from ..data.encode import binarize_labels, build_labelmap, compact_labels, encode_instances
from ..ops.gibbs import FoldinSweep, SaveStep, _load_into, _Replayed
from ..ops.hslda_gibbs import (
    HSLDACounts,
    HSLDASweep,
    _m_width,
    _noise,
    _static,
    _sweep_,
    fill_gumbels,
    hslda_init_counts,
    hslda_z_sweep,
)
from ..ops.sampling import gumbel, norm_cdf, open_uniforms, stirling_table, truncated_normal
from ..utils.tracing import annotate
from .state import running_average

__all__ = ["HSLDA", "CycleNoise", "CycleStep", "eta_block", "eta_gram", "eta_draw", "a_block",
           "antoniak_draw", "beta_block", "chains_test_loop", "chain_scores", "D_BLOCK"]

D_BLOCK = 512  # documents per block of the m draw (the JAX function's noise blocks)

Draws = Optional[Union[torch.Tensor, Callable[[torch.Tensor], torch.Tensor]]]


class CycleNoise(NamedTuple):
    """The draws of one cycle, each optional: ``z (N, D, K)`` Gumbel noise,
    ``eta (K, L)`` standard normals, ``a (D, L)`` uniforms in [1e-7, 1),
    ``m (D, K, S)`` Gumbel noise and ``beta``, the Gamma variates (K,) or a
    function of their concentration that gives them.  For a state with a
    chain axis each has one more: ``z (N, C, D, K)``, the others a leading
    ``C``."""

    z: Optional[torch.Tensor] = None
    eta: Optional[torch.Tensor] = None
    a: Optional[torch.Tensor] = None
    m: Optional[torch.Tensor] = None
    beta: Draws = None


def _f32(x: float) -> float:
    return float(np.float32(x))


def per_chain(shape, generator, draw) -> torch.Tensor:
    """A draw of ``shape``: ``draw(shape, gen)`` from one generator, or, given
    one generator per chain (``shape[0]`` of them), chain c's slice from
    generator c, as a single-chain draw of ``shape[1:]``."""
    if generator is None or isinstance(generator, torch.Generator):
        return draw(tuple(shape), generator)
    if len(generator) != shape[0]:
        raise ValueError(f"{len(generator)} generators for {shape[0]} chains")
    return torch.stack([draw(tuple(shape[1:]), g) for g in generator])


def eta_gram(zbar: torch.Tensor, a: torch.Tensor):
    """The data terms of η's posterior: ``(z̄ᵀz̄, z̄ᵀa)``, (K, K) and (K, L),
    or per chain (C, K, K) and (C, K, L).  A sharded run sums them over
    its data row before :func:`eta_draw` (``hslda_sharded.py:216-227``)."""
    return zbar.mT @ zbar, zbar.mT @ a


def eta_draw(gram: torch.Tensor, raw: torch.Tensor, mu: float, sigma: float,
             normals: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
    """η ~ its Bayesian-regression posterior (HSLDA.py:274-287) given the
    Gram terms of :func:`eta_gram`; returns η (L, K), or (C, L, K) per chain.

    Σ̂⁻¹ = I/σ + z̄ᵀz̄ is factored by Cholesky; μ̂ = Σ̂ (μ/σ + z̄ᵀa) by two
    triangular solves, and η_l = μ̂_l + Σ̂^{1/2} ε with Σ̂^{1/2} = chol⁻ᵀ.
    ``normals`` is ε, (K, L) or (C, K, L); the factor and the solves batch
    over chains."""
    K, L = gram.shape[-1], raw.shape[-1]
    sigma32 = _f32(sigma)
    eye = torch.eye(K, dtype=torch.float32, device=gram.device)
    sig_inv = eye / sigma32 + gram  # (K, K) precision
    chol, _ = torch.linalg.cholesky_ex(sig_inv)
    raw_mean = float(np.float32(mu) / np.float32(sigma)) + raw  # (K, L)
    tmp = torch.linalg.solve_triangular(chol, raw_mean, upper=False)
    mu_hat = torch.linalg.solve_triangular(chol.mT, tmp, upper=True)
    if normals is None:
        eps = per_chain(tuple(raw.shape[:-2]) + (K, L), generator, lambda s, g: torch.randn(
            s, generator=g, device=gram.device, dtype=torch.float32))
    else:
        eps = normals.to(device=gram.device, dtype=torch.float32)
    return (mu_hat + torch.linalg.solve_triangular(chol.mT, eps, upper=True)).mT


def eta_block(zbar: torch.Tensor, a: torch.Tensor, mu: float, sigma: float,
              normals: Optional[torch.Tensor] = None, generator=None) -> torch.Tensor:
    """η ~ its posterior given z̄ (D, K) and a (D, L) (HSLDA.py:274-287):
    :func:`eta_draw` of :func:`eta_gram`; returns η (L, K).  With a chain
    axis (z̄ (C, D, K), a (C, D, L)) it draws every chain's η (C, L, K)."""
    return eta_draw(*eta_gram(zbar, a), mu, sigma, normals, generator)


def a_block(zbar: torch.Tensor, eta: torch.Tensor, labs: torch.Tensor,
            uniforms: Optional[torch.Tensor] = None, generator=None):
    """a ~ N(z̄ηᵀ, 1) truncated to (0, ∞) on positive labels and (−∞, 0) on
    negative ones (HSLDA.py:289-292); returns (a, z̄ηᵀ), both (D, L), or
    (C, D, L) for z̄ (C, D, K) and η (C, L, K)."""
    mean_a = zbar @ eta.mT
    lo = torch.where(labs > 0, 0.0, float("-inf"))
    hi = torch.where(labs > 0, float("inf"), 0.0)
    if uniforms is None and generator is not None and not isinstance(generator,
                                                                     torch.Generator):
        uniforms = per_chain(mean_a.shape, generator,
                             lambda s, g: open_uniforms(s, mean_a.device, g))
    return truncated_normal(lo, hi, loc=mean_a, scale=1.0, uniforms=uniforms,
                            generator=generator), mean_a


def antoniak_draw(n_dk: torch.Tensor, alpha: float, beta: torch.Tensor,
                  stirling_logs: torch.Tensor, gumbels: Optional[torch.Tensor] = None,
                  generator=None) -> torch.Tensor:
    """Antoniak table counts m ∈ {0..n} with p(m) ∝ s(n, m)·(αβ_k)^m per
    (document, topic), by Gumbel-max over the log Stirling table
    (HSLDA.py:298-310 with the index-draw fix); returns m (D, K) int64, or
    (C, D, K) for ``n_dk (C, D, K)`` and ``beta (C, K)``.

    Counts are clipped to the table (S rows).  ``gumbels`` is the noise
    (D, K, S) or (C, D, K, S); documents go in blocks of ``D_BLOCK``, all
    chains at once, to bound the (C, ·, K, S) transient."""
    single = n_dk.dim() == 2
    n3 = n_dk[None] if single else n_dk
    C, D, K = n3.shape
    S = stirling_logs.shape[0]
    log_ab = torch.log(torch.clamp(alpha * beta.reshape(C, K), min=1e-38))  # (C, K)
    n_clip = torch.clamp(n3, max=S - 1).long()
    step = torch.arange(S, dtype=torch.float32, device=n_dk.device)[None, None, None, :] \
        * log_ab[:, None, :, None]  # (C, 1, K, S)
    shape = (C, D, K, S)
    if gumbels is None:
        gumbels = per_chain(shape, [generator] if single else generator,
                            lambda s, g: gumbel(s, n_dk.device, g))
    elif gumbels.numel() != C * D * K * S or (not single and tuple(gumbels.shape) != shape):
        raise ValueError(f"gumbels must have shape {shape[1:] if single else shape}, "
                         f"got {tuple(gumbels.shape)}")
    gumbels = gumbels.reshape(shape)
    m = torch.empty((C, D, K), dtype=torch.int64, device=n_dk.device)
    for s in range(0, D, D_BLOCK):
        logits = stirling_logs[n_clip[:, s:s + D_BLOCK]] + step  # (C, ·, K, S), -inf above n
        m[:, s:s + D_BLOCK] = torch.argmax(
            logits + gumbels[:, s:s + D_BLOCK].to(logits.device), dim=3)
    return m[0] if single else m


def beta_block(mdot: torch.Tensor, aprime: float, gammas: Draws = None,
               generator=None) -> torch.Tensor:
    """β ~ Dir(mdot + α') by normalised Gamma variates (HSLDA.py:294-296),
    (K,) or per chain (C, K).  ``gammas`` is the variates or a function of
    the concentration that gives them."""
    conc = mdot + _f32(aprime)
    if gammas is None:
        if generator is None or isinstance(generator, torch.Generator):
            g = torch._standard_gamma(conc, generator=generator)
        else:  # one generator per chain
            g = torch.stack([torch._standard_gamma(conc[c], generator=gen)
                             for c, gen in enumerate(generator)])
    else:
        g = gammas(conc) if callable(gammas) else gammas
        g = g.to(device=conc.device, dtype=torch.float32)
    return g / g.sum(dim=-1, keepdim=True)


def _train_cycle(counts: HSLDACounts, tok_v, mask, labs, eta, a, beta, stirling_logs,
                 mu: float, sigma: float, aprime: float, alpha: float, gamma: float,
                 xi: float, opt: int, lab_pos_ids=None, lab_pos_valid=None,
                 noise: Optional[CycleNoise] = None,
                 generator: Optional[torch.Generator] = None):
    """One blocked-Gibbs cycle z → η → a → m → β (HSLDA.py:312-317) on copies
    of the counts; returns ``(counts, eta, a, beta, zbar, mean_a)`` as the
    JAX function does.  Draws come from ``noise`` where it holds them, else
    from ``generator``, in the order z, η, a, m, β.  The functional form of
    a :class:`CycleStep` call, which has its bits."""
    noise = noise or CycleNoise()
    alpha_beta = alpha * beta
    counts, _ = hslda_z_sweep(counts, tok_v, mask, labs, eta, a, alpha_beta, gamma, xi,
                              opt=opt, lab_pos_ids=lab_pos_ids, lab_pos_valid=lab_pos_valid,
                              gumbels=noise.z, generator=generator)
    n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
    zbar = counts.n_dk.to(torch.float32) / n_d[:, None]  # (D, K)
    eta_new = eta_block(zbar, a, mu, sigma, noise.eta, generator)
    a_new, mean_a = a_block(zbar, eta_new, labs, noise.a, generator)
    m = antoniak_draw(counts.n_dk, alpha, beta, stirling_logs, noise.m, generator)
    # the mean over documents, the reference's scaling (HSLDA.py:310): an
    # exact integer sum and one division, the same bits on every device
    mdot = m.sum(dim=0).to(torch.float32) / m.shape[0]
    beta_new = beta_block(mdot, aprime, noise.beta, generator)
    return counts, eta_new, a_new, beta_new, zbar, mean_a


def _fill(out: torch.Tensor, generator, draw) -> None:
    """Fill ``out (C, …)`` as :func:`per_chain` draws it: ``draw(out, gen)``
    over the whole buffer from one generator, or, given one generator per
    chain, chain c's slice from generator c."""
    if generator is None or isinstance(generator, torch.Generator):
        draw(out, generator)
        return
    if len(generator) != out.shape[0]:
        raise ValueError(f"{len(generator)} generators for {out.shape[0]} chains")
    for dst, gen in zip(out, generator):
        draw(dst, gen)


class CycleStep(_Replayed):
    """Repeated blocked-Gibbs cycles (:func:`_train_cycle`) over one state,
    which every call updates in place: the count tensors ``z_t (N, C·D)``
    (position-major), ``n_dk (C, D, K)``, ``n_vk (C, V, K)``, ``n_k (C, K)``
    given, and η (C, L, K), a (C, D, L) and β (C, K), which the runner owns
    (copied from the given tensors).  A single chain's ``(D, K)``, ``(V,
    K)``, ``(K,)`` tensors and ``z_t (N, D)`` are taken as C = 1 views, and
    its blocks run on the tensors without the chain axis, as
    :func:`_train_cycle` runs them.  ``params`` are (η, a, β) as the caller
    sees them (a single chain's without the axis): a reader that keeps them
    past the next call clones them.

    A call fills static noise buffers in the eager draw order, from
    ``generator`` (or one generator per chain, each filling its chain's
    slice as a single-chain cycle draws it) or from ``noise`` where it
    holds the draws: the z-sweep's Gumbels (N, C, D, K), then η's normals
    (C, K, L) from ``eta_generator`` (default ``generator``), a's uniforms
    (C, D, L) and m's Gumbels (C, D, K, S).  Then the body: the z-sweep
    (``ops/hslda_gibbs._sweep_``, α·β from the static β), z̄, η, a, m and
    ``mdot = Σ_d m / D_total``, η and a written in place.  Under
    :class:`~..ops.gibbs._Replayed`'s rule the body is one CUDA graph per
    coupling ``opt`` on a card (the first call of an ``opt`` eager, the
    second captured, later ones replayed); on the CPU it runs eagerly.  β's
    Gamma variates take mdot from the body and are the cycle's last draw,
    so they are drawn after it, from ``eta_generator``, and normalised into
    the static β.  ``V`` is the true vocabulary size; ``D_total`` divides
    mdot (default D).  A call is the span ``hslda_cycle``."""

    _layer = "hslda_cycle"

    def __init__(self, z_t, n_dk, n_vk, n_k, tok_v, mask, labs, eta, a, beta,
                 stirling_logs, mu: float, sigma: float, aprime: float, alpha: float,
                 gamma: float, xi: float, V: int, D_total: Optional[int] = None,
                 lab_pos_ids=None, lab_pos_valid=None):
        super().__init__(n_dk.device)
        self.single = single = n_dk.dim() == 2
        chains = [t[None] if single else t for t in (n_dk, n_vk, n_k)]
        C, D, K = chains[0].shape
        N, L, S = tok_v.shape[1], labs.shape[1], stirling_logs.shape[0]
        if tuple(z_t.shape) != (N, C * D):
            raise ValueError(f"z_t must have shape {(N, C * D)}, got {tuple(z_t.shape)}")
        dev, f32 = n_dk.device, torch.float32
        self.state = (z_t, *chains)
        self._n_dk = n_dk  # the blocks' view
        self._st = _static(tok_v, mask, labs, V, K, gamma, C, chains[1].shape[1])
        self._n_d = torch.clamp(mask.sum(dim=1), min=1).to(f32)
        self._logs = stirling_logs
        self._pos = (None if lab_pos_ids is None else lab_pos_ids.long().contiguous(),
                     None if lab_pos_valid is None else lab_pos_valid.to(f32))
        self.mu, self.sigma, self.aprime = float(mu), float(sigma), float(aprime)
        self.alpha, self.gamma, self.xi = float(alpha), float(gamma), float(xi)
        self.D_total = int(D if D_total is None else D_total)
        self.eta = torch.empty((C, L, K), dtype=f32, device=dev)
        self.a = torch.empty((C, D, L), dtype=f32, device=dev)
        self.beta = torch.empty((C, K), dtype=f32, device=dev)
        self.mdot = torch.empty((C, K), dtype=f32, device=dev)
        self.g_z = torch.empty((N, C, D, K), dtype=f32, device=dev)
        self.g_eta = torch.empty((C, K, L), dtype=f32, device=dev)
        self.u_a = torch.empty((C, D, L), dtype=f32, device=dev)
        self.g_m = torch.empty((C, D, K, S), dtype=f32, device=dev)
        self._M = {}  # opt -> the sweep's M buffer
        self.params = tuple(self._v(t) for t in (self.eta, self.a, self.beta))
        _load_into(self.params, (eta, a, beta))

    def _v(self, t: torch.Tensor) -> torch.Tensor:
        """``t`` as the blocks take it: a single chain's without the axis."""
        return t[0] if self.single else t

    def load(self, eta, a, beta) -> None:
        """Copy (η, a, β) set from elsewhere (told apart from the static
        tensors by identity) into the static tensors in place; each must
        keep its shape."""
        for p, x in zip(self.params, (eta, a, beta)):
            if x is not p:
                _load_into((p,), (x,))

    def fill(self, generator=None, eta_generator=None,
             noise: Optional[CycleNoise] = None) -> None:
        """Fill the noise buffers of one cycle (z, η, a, m), in that order."""
        noise = noise or CycleNoise()
        eta_gen = generator if eta_generator is None else eta_generator
        if noise.z is None:
            fill_gumbels(self.g_z, generator)
        else:
            self.g_z.copy_(_noise(self.g_z.shape, self.g_z, noise.z, None))
        draws = (
            (self.g_eta, noise.eta, eta_gen,
             lambda out, g: torch.randn(tuple(out.shape), generator=g, out=out)),
            (self.u_a, noise.a, generator,
             lambda out, g: open_uniforms(out.shape, out.device, g, out=out)),
            (self.g_m, noise.m, generator,
             lambda out, g: gumbel(out.shape, out.device, g, out=out)))
        for buf, given, gen, draw in draws:
            if given is None:
                _fill(buf, gen, draw)
            elif given.numel() != buf.numel():
                raise ValueError(f"noise of {given.numel()} numbers for a buffer of "
                                 f"shape {tuple(buf.shape)}")
            else:
                buf.copy_(given.to(dtype=torch.float32).reshape(buf.shape))

    def _body(self, opt: int) -> None:
        _sweep_(self._st, *self.state, self._M[opt], self.eta, self.a, self.alpha * self.beta,
                self.g_z, self.gamma, self.xi, opt, *self._pos)
        v = self._v
        eta, a, n_dk = v(self.eta), v(self.a), self._n_dk
        zbar = n_dk.to(torch.float32) / self._n_d[:, None]
        eta_new = eta_block(zbar, a, self.mu, self.sigma, v(self.g_eta))
        a_new, _ = a_block(zbar, eta_new, self._st.labs, v(self.u_a))
        m = antoniak_draw(n_dk, self.alpha, v(self.beta), self._logs, v(self.g_m))
        # the mean over documents (HSLDA.py:310): an exact integer sum, one division
        v(self.mdot).copy_(m.sum(dim=-2).to(torch.float32) / self.D_total)
        eta.copy_(eta_new)
        a.copy_(a_new)

    def __call__(self, opt: int, generator=None, eta_generator=None,
                 noise: Optional[CycleNoise] = None) -> None:
        """One cycle with coupling ``opt``; draws as :meth:`fill`, then β's
        Gammas from ``noise.beta`` or ``eta_generator``."""
        opt = int(opt)
        noise = noise or CycleNoise()
        eta_gen = generator if eta_generator is None else eta_generator
        with annotate(self._layer):
            if opt not in self._M:
                sparse2 = opt == 2 and self._pos[0] is not None
                self._M[opt] = torch.empty(
                    self.a.shape[:2] + (_m_width(self._st, opt, sparse2),),
                    dtype=torch.float32, device=self.a.device)
            self.fill(generator, eta_gen, noise)
            self._run(opt, lambda: self._body(opt))
            self.params[2].copy_(beta_block(self._v(self.mdot), self.aprime, noise.beta,
                                            eta_gen))


def _test_init(tv, mF, init_phi, init_uniforms):
    """:func:`_test_loop`'s init pass: z (D, N) int32 drawn from the thinned
    φ̂ by inverse CDF with ``init_uniforms (N, D)``, and its ``n_dk``."""
    D, N = tv.shape
    n_dk = torch.zeros((D, init_phi.shape[1]), dtype=torch.float32, device=tv.device)
    z = torch.empty((D, N), dtype=torch.int32, device=tv.device)
    for p in range(N):
        c = torch.cumsum(init_phi[tv[:, p]], dim=1)
        z_p = (c < (init_uniforms[p] * c[:, -1])[:, None]).sum(dim=1)
        n_dk.scatter_add_(1, z_p[:, None], mF[:, p, None])
        z[:, p] = z_p
    return z, n_dk


def _test_loop(tok_v, mask, init_phi, sweep_phi, alpha_beta, it: int, thinning: int,
               init_uniforms: Optional[torch.Tensor] = None,
               sweep_uniforms: Optional[Sequence[torch.Tensor]] = None,
               generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """Batched fold-in of held-out documents (HSLDA.py:335-374): z drawn from
    the thinned φ̂ (``init_phi (V, K)``) by inverse CDF, then ``it`` sweeps
    with ``sweep_phi`` frozen (``ops/gibbs.FoldinSweep``, α·β as the prior;
    on a card one replayed CUDA graph from the second sweep on, with the
    bits of ``foldin_sweep``) and z̄ averaged at every ``thinning``-th
    sweep; returns z̄ (D, K).

    ``init_uniforms (N, D)`` and ``sweep_uniforms`` (one (N, D) per sweep)
    are the draws; without them they come from ``generator``."""
    D, N = tok_v.shape
    device = tok_v.device
    with annotate("foldin.init"):
        n_d = torch.clamp(mask.sum(dim=1), min=1).to(torch.float32)
        if init_uniforms is None:
            init_uniforms = torch.rand((N, D), generator=generator, device=device)
        z, n_dk = _test_init(tok_v.long(), mask.to(torch.float32), init_phi, init_uniforms)
    with annotate("foldin.sweeps"):
        sweep = FoldinSweep(z, n_dk, tok_v, mask, sweep_phi, alpha_beta)
        avg = torch.zeros_like(n_dk)
        s = 0
        for i in range(int(it)):
            sweep(generator, uniforms=None if sweep_uniforms is None else sweep_uniforms[i])
            if (i + 1) % int(thinning) == 0:
                s += 1
                avg = running_average(avg, n_dk / n_d[:, None], s)
    return avg


def chains_test_loop(tok_v, mask, init_phi, sweep_phi, alpha_beta, it: int, thinning: int,
                     init_uniforms: Optional[torch.Tensor] = None,
                     sweep_uniforms: Optional[Sequence[torch.Tensor]] = None,
                     generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """:func:`_test_loop` of C chains at once: each chain folds the same
    documents in against its own ``init_phi``/``sweep_phi (C, V, K)`` and
    ``alpha_beta (C, K)``; returns z̄ (C, D, K).

    The chains' documents lie side by side as C·D rows of one fold-in,
    chain c's words reading rows ``c·V + v`` of the stacked (C·V, K)
    tables and its rows taking α·β_c, so each position is as many launches
    for C chains as for one.  The uniforms are ``(N, C·D)`` (chain c's
    documents in columns ``c·D … c·D + D − 1``)."""
    C, V, K = init_phi.shape
    D, N = tok_v.shape
    rows = torch.arange(C, device=tok_v.device).repeat_interleave(D)  # (C·D,)
    tv = tok_v.long().repeat(C, 1) + (V * rows)[:, None]
    zbar = _test_loop(tv, mask.repeat(C, 1), init_phi.reshape(C * V, K),
                      sweep_phi.reshape(C * V, K), alpha_beta[rows], it, thinning,
                      init_uniforms=init_uniforms, sweep_uniforms=sweep_uniforms,
                      generator=generator)
    return zbar.view(C, D, K)


def chain_scores(zbar: np.ndarray, eta: np.ndarray, xi: float) -> np.ndarray:
    """Label probabilities Φ(η_c·z̄_c − ξ) of every chain, averaged over the
    chains: z̄ (C, D, K) and η (C, L, K) give (D, L).  HSLDA's topics are
    not identifiable across chains, so the chains are pooled in the
    probabilities, not in φ or η."""
    mean_a = np.matmul(zbar, eta.transpose(0, 2, 1)) - np.float32(xi)
    return norm_cdf(torch.from_numpy(mean_a)).numpy().mean(axis=0)


class HSLDA:
    """Hierarchically supervised LDA with a probit label cascade, on
    ``device`` (CUDA unless the caller passes ``"cpu"``)."""

    def __init__(
        self,
        docs: Sequence[Sequence[str]],
        labs: Sequence[Sequence[str]],
        labelset: Sequence[str],
        k: int = 15,
        alpha_prime: float = 1.0,
        alpha: float = 1.0,
        gamma: float = 1.0,
        mu: float = 0.0,
        sigma: float = 1.0,
        xi: float = 0.0,
        seed: int = 0,
        device=None,
    ):
        self.device = torch.device("cuda" if device is None else device)
        self.K = int(k)
        self.aprime = float(alpha_prime)
        self.alpha = float(alpha)
        self.gamma = float(gamma)
        self.mu = float(mu)
        self.sigma = float(sigma)
        self.xi = float(xi)

        # root '' at id 0 (reference HSLDA.py:86-87; see module docstring)
        self.labelmap: Dict[str, int] = build_labelmap(labelset, root="")
        self.lablist = list(self.labelmap.keys())
        self.L = len(self.labelmap)

        # growing vocabulary over token instances (HSLDA.py:102,162-169)
        self.w_to_v: Dict[str, int] = {}
        docs_ids = [[self._term_to_id(t) for t in doc] for doc in docs]
        self.v_to_w = {v: w for w, v in self.w_to_v.items()}
        self.V = len(self.w_to_v)
        self.D = len(docs)

        tok_v, mask = encode_instances(docs_ids)
        self.n_tokens = int(mask.sum())
        self.tok_v = self._t(tok_v, torch.int32)
        self.mask = self._t(mask, torch.int32)
        lab_mask = binarize_labels(labs, self.labelmap)
        self.labs = self._t(lab_mask, torch.float32)
        # compact positive-label layout for the opt=2 Φ coupling
        ids, valid = compact_labels(lab_mask)
        self._lab_pos_ids = self._t(ids, torch.int64)
        self._lab_pos_valid = self._t(valid, torch.float32)

        # label-tree parent map (HSLDA.py:139-142)
        self.child_to_parent = {
            self.labelmap[x]: self.labelmap.get(x[:-1], 0)
            for x in labelset if x in self.labelmap
        }

        # Stirling table in log space, sized to the longest document
        max_n = int(mask.sum(axis=1).max()) + 2
        table = stirling_table(max(max_n, 8))
        with np.errstate(divide="ignore"):
            self._stirling_logs = self._t(np.log(table), torch.float32)

        self.ph: Optional[np.ndarray] = None  # thinned (K, V) φ̂
        self.th: Optional[np.ndarray] = None  # thinned (D, K) z̄
        self._avg_s = 0
        self._cycles_done = 0
        self._sweeps: Dict[int, HSLDASweep] = {}
        self._cycle: Optional[CycleStep] = None  # the training runners, made at first use
        self._save: Optional[SaveStep] = None
        self._means = None  # (ph, th) as the save runner's means last gave them
        self.seed = int(seed)
        self._gen = torch.Generator(device=self.device)
        self._gen.manual_seed(self.seed)
        self._init_state()

    def _init_state(self) -> None:
        """Priors and the initial state (HSLDA.py:109-137), drawn from the
        model's generator in the JAX constructor's order."""
        gen = self._gen
        self.eta = self.mu + torch.randn((self.L, self.K), generator=gen, device=self.device)
        g = torch._standard_gamma(torch.full((self.K,), self.aprime, device=self.device),
                                  generator=gen)
        self.beta = g / g.sum()
        g = torch._standard_gamma((self.alpha * self.beta).expand(self.D, self.K).contiguous(),
                                  generator=gen)
        theta0 = g / torch.clamp(g.sum(dim=1, keepdim=True), min=1e-38)
        c = hslda_init_counts(self.tok_v, self.mask, theta0, self.V, generator=gen)
        # the sweep's state: z position-major, updated in place by every sweep
        self._z_t = c.z.T.contiguous()
        self._n_dk, self._n_vk, self._n_k = c.n_dk, c.n_vk, c.n_k
        self._n_d = torch.clamp(self.mask.sum(dim=1), min=1).to(torch.float32)
        zbar = self._n_dk.to(torch.float32) / self._n_d[:, None]
        self.a, _ = a_block(zbar, self.eta, self.labs, generator=gen)

    def __getstate__(self):
        # a captured CUDA graph does not pickle; the runners are made again
        # at first use, from η, a, β and the means
        state = self.__dict__.copy()
        state.update(_sweeps={}, _cycle=None, _save=None, _means=None)
        return state

    def _t(self, x, dtype) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x), device=self.device).to(dtype)

    def _term_to_id(self, term: str) -> int:
        tid = self.w_to_v.get(term)
        if tid is None:
            tid = len(self.w_to_v)
            self.w_to_v[term] = tid
        return tid

    # ----------------------------------------------------------------- state

    @property
    def counts(self) -> HSLDACounts:
        """The count state; ``z`` doc-major (D, N), a copy."""
        return HSLDACounts(z=self._z_t.T.contiguous(), n_dk=self._n_dk, n_vk=self._n_vk,
                           n_k=self._n_k)

    @counts.setter
    def counts(self, c: HSLDACounts) -> None:
        # in place: a captured graph reads these very tensors; a state of
        # another shape is refused
        _load_into((self._z_t, self._n_dk, self._n_vk, self._n_k), (c.z.T, *c[1:]))

    def z_sweep(self, opt: int) -> HSLDASweep:
        """The model's sweep for coupling ``opt``, made at first use."""
        opt = int(opt)
        if opt not in self._sweeps:
            ids = valid = None
            if opt == 2:
                ids, valid = self._lab_pos_ids, self._lab_pos_valid
            self._sweeps[opt] = HSLDASweep(self._z_t, self._n_dk, self._n_vk, self._n_k,
                                           self.tok_v, self.mask, self.labs, self.gamma,
                                           self.xi, opt, self.V, ids, valid)
        return self._sweeps[opt]

    def cycle_step(self) -> CycleStep:
        """The model's cycle runner (:class:`CycleStep` over the model's
        count tensors), made at first use and kept for the model's life.
        ``eta``, ``a`` and ``beta`` are its static tensors from then on; ones
        set from elsewhere (a checkpoint, a converted state) are told apart
        by identity and copied in."""
        params = (self.eta, self.a, self.beta)
        if self._cycle is None:
            self._cycle = CycleStep(
                self._z_t, self._n_dk, self._n_vk, self._n_k, self.tok_v, self.mask,
                self.labs, *params, self._stirling_logs, self.mu, self.sigma, self.aprime,
                self.alpha, self.gamma, self.xi, self.V, lab_pos_ids=self._lab_pos_ids,
                lab_pos_valid=self._lab_pos_valid)
        else:
            self._cycle.load(*params)
        self.eta, self.a, self.beta = self._cycle.params
        return self._cycle

    def train_cycle(self, opt: int = 1, noise: Optional[CycleNoise] = None) -> None:
        """One blocked-Gibbs cycle on the model's state (:meth:`cycle_step`)."""
        self.cycle_step()(opt, self._gen, noise=noise)
        self._cycles_done += 1

    # ------------------------------------------------------------------ train

    def get_zbar(self) -> np.ndarray:
        n_d = np.maximum(self.mask.sum(dim=1).cpu().numpy(), 1)
        return self._n_dk.cpu().numpy() / n_d[:, None]

    def get_ph(self) -> np.ndarray:
        n_kv = self._n_vk.cpu().numpy().T  # (K, V)
        den = n_kv.sum(axis=1, keepdims=True)
        return n_kv / np.maximum(den, 1)

    def _estimates(self):
        """The save's current (φ̂ (K, V) unsmoothed, (z̄ (D, K),))."""
        n_kv = self._n_vk.to(torch.float32).T
        cur_ph = n_kv / torch.clamp(n_kv.sum(dim=1, keepdim=True), min=1.0)
        return cur_ph, (self._n_dk.to(torch.float32) / self._n_d[:, None],)

    def _save_step(self) -> SaveStep:
        """The model's save runner (``ops/gibbs.SaveStep`` over φ̂ and z̄),
        made at first use and kept for the model's life."""
        if self._save is None:
            f32 = dict(dtype=torch.float32, device=self.device)
            self._save = SaveStep(torch.zeros((self.K, self.V), **f32),
                                  [torch.zeros((self.D, self.K), **f32)])
            self._means = None
        return self._save

    def run_training(self, it: int = 25, thinning: int = 5, opt: int = 1,
                     continue_avg: bool = False) -> None:
        """Blocked-Gibbs cycles with thinned φ̂/z̄ averaging (HSLDA.py:312-333).

        The means fold in at every ``thinning``-th cycle, in float32, with
        the save index in device scalars as JAX traces it; the trailing ``it
        % thinning`` cycles run unsaved.  ``continue_avg=True`` carries the
        means across calls (chunked or resumed training); the default
        restarts them, as the reference's per-call counter does.  Each cycle
        is one :class:`CycleStep` call and each save one ``SaveStep`` call,
        so on a card a model's second call replays graphs only.
        """
        it, thinning = int(it), int(thinning)
        run, save = self.cycle_step(), self._save_step()
        s = 0
        if continue_avg and self.ph is not None:
            s = int(self._avg_s)
            if self._means is None or self._means[0] is not self.ph \
                    or self._means[1] is not self.th:
                save.load(torch.as_tensor(self.ph), [torch.as_tensor(self.th)])
        # without continue_avg the first save overwrites the means
        for i in range(it):
            run(opt, self._gen)
            self._cycles_done += 1
            if (i + 1) % thinning == 0:
                s += 1
                save(s, self._estimates)
        self._avg_s = s
        if s:
            self.ph = save.ph_hat.to("cpu", copy=True).numpy()
            self.th = save.th_hat[0].to("cpu", copy=True).numpy()
            self._means = (self.ph, self.th)

    # ------------------------------------------------------------------- test

    def _encode_test(self, newdocs: Sequence[Sequence[str]]):
        ids = [[self.w_to_v[t] for t in doc if t in self.w_to_v] for doc in newdocs]
        tok_v, mask = encode_instances(ids)
        return self._t(tok_v, torch.int32), self._t(mask, torch.int32)

    def run_tests(self, newdocs: Sequence[Sequence[str]], it: int = 250,
                  s: int = 25) -> np.ndarray:
        """Label probabilities Φ(η·z̄ − ξ) for a batch of held-out documents
        (reference run_test/run_tests, HSLDA.py:346-394), all at once.  Φ is
        :func:`~..ops.sampling.norm_cdf`, precise in the left tail as the
        reference's float64 ``norm.cdf`` is; the JAX package's ½(1 + erf)
        in float32 ties the scores of labels far below ξ."""
        with annotate("predict.prepare"):
            tok_v, mask = self._encode_test(newdocs)
            ph = self.ph if self.ph is not None else self.get_ph()
            init_phi = self._t(np.ascontiguousarray(ph.T), torch.float32)  # (V, K)
            sweep = self._n_vk.cpu().numpy().astype(np.float64) + self.gamma  # (V, K)
            sweep = sweep / sweep.sum(axis=0, keepdims=True)
            sweep_phi = self._t(sweep, torch.float32)
        zbar = _test_loop(tok_v, mask, init_phi, sweep_phi, self.alpha * self.beta,
                          it=int(it), thinning=int(s), generator=self._gen)
        with annotate("predict.scores"):
            return chain_scores(zbar.cpu().numpy()[None], self.eta.cpu().numpy()[None],
                                self.xi)

    def run_test(self, newdoc, it: int = 250, s: int = 25) -> np.ndarray:
        return self.run_tests([newdoc], it=it, s=s)[0]

    # ------------------------------------------------------------ diagnostics

    def display_topics(self, n: int = 10) -> List[List[str]]:
        ph = self.ph if self.ph is not None else self.get_ph()
        top_v = np.argsort(-ph)[:, :n]
        return [[self.v_to_w[int(v)] for v in top] for top in top_v]

    def label_predictions(self, probs: np.ndarray):
        with annotate("predict.rank"):
            return sorted(zip(probs.tolist(), self.lablist))[::-1]
