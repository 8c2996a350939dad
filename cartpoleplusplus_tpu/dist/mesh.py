"""Mesh construction + sharding rules for the env/replay batch axis.

The layout recipe (scaling-book style): pick a mesh, annotate shardings on
program inputs, let the SPMD partitioner insert collectives, profile.
For this workload one named axis suffices:

  * 'data' — all devices of all hosts, flat. Env state, observations,
    replay buffers and OU-noise shard on their leading (num_envs) axis;
    network params and optimizer states are replicated. The learner
    minibatch gradient then needs exactly one psum per update (inserted
    by XLA when a replicated output is computed from sharded inputs),
    which XLA hands to NCCL. NVLink joins the GPUs of a host all to
    all, so the mesh follows the algorithm alone: one flat axis.

Multi-host determinism: per-env PRNG seeds are a pure function of the
GLOBAL env index (env/cartpole.py::derive_env_seeds), so trajectories are
bitwise independent of the mesh shape or host count.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

DATA_AXIS = "data"


def initialize_multihost(coordinator_address: str | None = None,
                         num_processes: int | None = None,
                         process_id: int | None = None) -> None:
    """Bring up the multi-host runtime (one JAX process per host).

    Thin wrapper over `jax.distributed.initialize`. Without a cluster
    manager the three arguments must be given (coordinator
    `host:port`, process count, this process's id). Skip it entirely
    for single-process runs, which drive every local GPU.
    """
    jax.distributed.initialize(coordinator_address=coordinator_address,
                               num_processes=num_processes,
                               process_id=process_id)


def make_mesh(devices=None) -> Mesh:
    """1-D ('data',) mesh over the given (default: all) devices."""
    devices = np.asarray(devices if devices is not None else jax.devices())
    return Mesh(devices.reshape(-1), (DATA_AXIS,))


def batch_sharding(mesh: Mesh) -> NamedSharding:
    """Shard the leading (num_envs) axis over 'data'."""
    return NamedSharding(mesh, P(DATA_AXIS))


def replicated_sharding(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


def shard_batch_tree(tree, mesh: Mesh):
    """Place every array leaf with its leading axis sharded on 'data'.

    Scalar leaves (replay cursors, step counters, PRNG keys) replicate.
    """
    bs, rep = batch_sharding(mesh), replicated_sharding(mesh)

    def place(x):
        x = jax.numpy.asarray(x)
        return jax.device_put(x, bs if x.ndim >= 1 and
                              x.shape[0] % mesh.size == 0 and x.shape[0] > 1
                              else rep)

    return jax.tree.map(place, tree)
