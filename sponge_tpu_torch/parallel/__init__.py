"""Data-parallel distribution over a ``torch.distributed`` process group:
the mesh, the sharded permutation and transcript, the sharded Merkle trees.

Counterpart of ``sponge_tpu/parallel/``.  One process drives one device;
every sharded function takes and returns the rank's local slice of the lane
axis.
"""

from .merkle import (
    sharded_merkle_root,
    sharded_merkle_root_jive,
    sharded_merkle_root_wide,
    sharded_merkle_verify_batch,
)
from .mesh import DATA_AXIS, batch_sharding, leaf_sharding, make_mesh, replicated
from .sharded import sharded_permute_fn, sharded_state, sharded_transcript_fn

__all__ = [
    "DATA_AXIS",
    "batch_sharding",
    "leaf_sharding",
    "make_mesh",
    "replicated",
    "sharded_merkle_root",
    "sharded_merkle_root_jive",
    "sharded_merkle_root_wide",
    "sharded_merkle_verify_batch",
    "sharded_permute_fn",
    "sharded_state",
    "sharded_transcript_fn",
]
