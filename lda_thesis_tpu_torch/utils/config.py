"""Typed run configuration (replaces the reference's optparse flag soup).

Copy of ``lda_thesis_tpu/utils/config.py``.  Mirrors the reference CLI
surface (SURVEY.md C20: ``-f -d -i -s -l -u -a -b -p``,
evaluate_LabeledLDA.py:110-128) as dataclasses with the same defaults
and the same ``thinning == 0 -> thinning = iters`` rule
(evaluate_LabeledLDA.py:130-131), plus framework extras (seed, mesh shape).
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Optional

__all__ = ["GibbsConfig", "RunConfig"]


@dataclass
class GibbsConfig:
    """Sampler hyperparameters shared by all model families."""

    iters: int = 150
    thinning: int = 0  # 0 -> iters (reference rule)
    alpha: float = 0.1
    beta: float = 0.01
    seed: int = 0

    def __post_init__(self) -> None:
        if self.thinning == 0:
            self.thinning = self.iters
        if self.iters <= 0:
            raise ValueError("iters must be positive")
        if self.alpha <= 0 or self.beta <= 0:
            raise ValueError("alpha/beta priors must be positive")


@dataclass
class RunConfig:
    """Full train/eval pipeline configuration."""

    file: str = ""
    depth: int = 3
    label_mode: str = "truncate"  # or "prefix" (CascadeLDA/HSLDA)
    lower: float = 0.0  # df-pruning thresholds (reference -l/-u)
    upper: float = 1.0
    gibbs: GibbsConfig = field(default_factory=GibbsConfig)
    test_iters: Optional[int] = None  # None -> gibbs.iters
    test_thinning: Optional[int] = None
    pickle: bool = False
    n_chains: int = 1
    n_data_shards: int = 1

    def __post_init__(self) -> None:
        if self.label_mode not in ("truncate", "prefix"):
            raise ValueError(f"bad label_mode: {self.label_mode!r}")
        if not (0 <= self.lower <= 1 and 0 < self.upper <= 1):
            raise ValueError("pruning thresholds must lie in [0, 1]")
        if self.test_iters is None:
            self.test_iters = self.gibbs.iters
        if self.test_thinning is None:
            self.test_thinning = self.gibbs.thinning

    def to_dict(self) -> dict:
        return asdict(self)
