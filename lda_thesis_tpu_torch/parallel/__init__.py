"""Multi-device execution layer on ``torch.distributed``.

Counterpart of ``lda_thesis_tpu/parallel/``:

* **data axis**: documents sharded across ranks; each chain's topic-word
  table replicas merged by an ``all_reduce`` of deltas after each sweep or
  merge block (AD-LDA, Newman et al. '09: exact within a shard, stale
  across shards within a block, exact again after each merge);
* **chains axis**: independent Gibbs chains over ranks and, within a rank,
  as a leading batch axis of one kernel launch; pooled estimators average
  over chains.

``DistributedLabeledLDA`` (:mod:`.trainer`) and ``DistributedHSLDA``
(:mod:`.hslda_trainer`, over :mod:`.hslda_sharded`) are the trainers.
"""

from .bootstrap import (
    Mesh,
    chains_for,
    initialize_distributed,
    is_distributed,
    make_global_mesh,
)
from .sharded import (
    ShardedLDAState,
    make_mesh,
    make_sharded_train_step,
    pooled_phi,
    shard_corpus,
)
from .hslda_trainer import DistributedHSLDA
from .trainer import DistributedLabeledLDA

__all__ = [
    "DistributedHSLDA",
    "DistributedLabeledLDA",
    "Mesh",
    "ShardedLDAState",
    "chains_for",
    "initialize_distributed",
    "is_distributed",
    "make_global_mesh",
    "make_mesh",
    "make_sharded_train_step",
    "pooled_phi",
    "shard_corpus",
]
