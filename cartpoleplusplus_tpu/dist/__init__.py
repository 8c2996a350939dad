"""Distributed execution: mesh, shardings, collectives, multi-host runtime.

Reference counterpart: NONE — rebcabin/cartpoleplusplus is a single-process
single-host program with no parallelism or communication backend of any
kind (SURVEY.md §1 distributed row, §5). This layer is the NEW capability
required by BASELINE config 5: "8192 envs sharded over 2+ hosts feeding
an on-device DDPG-style actor-learner via collectives" (BASELINE.json:11).

The communication backend is XLA collectives, which XLA lowers to NCCL
over NVLink between the GPUs of a host — psum/all-gather inserted by the
SPMD partitioner from sharding annotations, or written explicitly under
shard_map; `jax.distributed.initialize` is the multi-host runtime. There
is nothing to wrap by hand: the mesh + NamedSharding layout IS the
backend.

Parallelism taxonomy for this workload (documented non-goals, SURVEY.md
§2b): the only axis that exists is the env batch -> pure data parallelism.
TP/PP/SP/EP/CP/ring-attention are inapplicable — the models are ~100k-param
MLPs (replicated far below a single device's memory) and the only sequence axis
is rollout time, which is sequential by definition (lax.scan).
"""

from .mesh import (
    DATA_AXIS,
    initialize_multihost,
    make_mesh,
    replicated_sharding,
    batch_sharding,
    shard_batch_tree,
)
from .shardmap import (make_shardmap_evaluate, make_shardmap_train_scan,
                       make_shardmap_train_step, state_partition_specs)
from .train import (make_distributed_train_scan, make_distributed_train_step,
                    shard_agent_state, scaling_report)

__all__ = [
    "DATA_AXIS",
    "initialize_multihost",
    "make_mesh",
    "replicated_sharding",
    "batch_sharding",
    "shard_batch_tree",
    "make_distributed_train_scan",
    "make_distributed_train_step",
    "make_shardmap_evaluate",
    "make_shardmap_train_scan",
    "make_shardmap_train_step",
    "state_partition_specs",
    "shard_agent_state",
    "scaling_report",
]
