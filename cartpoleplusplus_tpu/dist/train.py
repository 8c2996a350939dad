"""Distributed actor-learner execution + scaling measurement.

The train step itself needs NO rewrite for multi-chip: every agent's
`train_step` is a pure function, so distribution is purely a placement
question. `shard_agent_state` lays out the initial state (env/replay/noise
batch-sharded, params/opt replicated) and `jax.jit` compiles one SPMD
program in which the SPMD partitioner inserts the learner's gradient psum
and keeps all env stepping chip-local — the design BASELINE config 5 asks
for (BASELINE.json:11).
"""

from __future__ import annotations

import functools
import time

import jax

from .mesh import (
    batch_sharding,
    make_mesh,
    replicated_sharding,
    shard_batch_tree,
)

# Agent-state fields whose leading axis is the (sharded) env batch.
_BATCH_FIELDS = frozenset({"replay", "env_state", "obs", "noise"})


def _leaf_placements(state, mesh):
    """NamedSharding pytree mirroring shard_agent_state's placement rule
    (batch-field array leaves with a shardable leading axis on 'data',
    everything else replicated) without moving any data."""
    bs, rep = batch_sharding(mesh), replicated_sharding(mesh)

    def batch_leaf(x):
        x = jax.numpy.asarray(x)
        return (bs if x.ndim >= 1 and x.shape[0] > 1
                and x.shape[0] % mesh.size == 0 else rep)

    out = {}
    for name, value in state._asdict().items():
        out[name] = jax.tree.map(
            batch_leaf if name in _BATCH_FIELDS else lambda _: rep, value)
    return type(state)(**out)


def shard_agent_state(state, mesh):
    """Place an agent TrainState on the mesh: batch fields sharded on
    'data', parameters / optimizer / scalars replicated."""
    return jax.tree.map(
        lambda x, s: jax.device_put(jax.numpy.asarray(x), s),
        state, _leaf_placements(state, mesh))


def make_distributed_train_step(agent, mesh, state_template=None,
                                capture: bool = False):
    """Jitted SPMD train_step. Use with a state from `shard_agent_state`.

    When `state_template` is given, the OUTPUT state shardings are pinned
    to the same placement rule the input uses, so the layout is stable
    across steps by construction (donation then reuses buffers
    in-place) rather than by trusting the partitioner to round-trip it.
    Metric outputs stay unconstrained (a None subtree) — the partitioner
    picks; capture=True threads the rollout chunk through as
    metrics["traj"] for the event-log sink.
    """
    step = functools.partial(agent.train_step, capture=capture)
    if state_template is None:
        return jax.jit(step, donate_argnums=(0,))
    out_shardings = (_leaf_placements(state_template, mesh), None)
    return jax.jit(step, donate_argnums=(0,), out_shardings=out_shardings)


def make_distributed_train_scan(agent, mesh, num_calls: int,
                                state_template=None,
                                capture: bool = False):
    """`num_calls` SPMD train steps as ONE jitted dispatch (the mesh
    twin of agents/common.py::make_train_scan — same dispatch-cost
    amortization, same stacked time-major metrics). Output state
    shardings are pinned exactly as in make_distributed_train_step; the
    scan carry keeps the same placement on every iteration, so the
    partitioner compiles one program with stable layouts throughout."""
    step = functools.partial(agent.train_step, capture=capture)

    def scanned(st):
        def body(c, _):
            c, m = step(c)
            return c, m

        return jax.lax.scan(body, st, None, length=num_calls)

    if state_template is None:
        return jax.jit(scanned, donate_argnums=(0,))
    out_shardings = (_leaf_placements(state_template, mesh), None)
    return jax.jit(scanned, donate_argnums=(0,),
                   out_shardings=out_shardings)


def measure_rollout_rate(env, num_steps: int = 256, repeats: int = 3,
                         mesh=None, seed: int = 0) -> float:
    """env-steps/s of the pure rollout loop with state sharded on `mesh`
    (default: all devices)."""
    from ..bench.harness import build_rollout

    mesh = mesh if mesh is not None else make_mesh()
    run = build_rollout(env, num_steps)
    state, _ = jax.jit(env.reset)(seed)
    state = shard_batch_tree(state, mesh)
    state, acc = jax.block_until_ready(run(state))
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, acc = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    return env.num_envs * num_steps / best


def scaling_report(make_env, num_steps: int = 256) -> dict:
    """Throughput on 1 device vs all devices, with per-device env count
    held constant (weak scaling — the config-5 shape: more hosts, more
    envs). Returns rates and the scaling efficiency vs linear."""
    devices = jax.devices()
    n = len(devices)
    env1 = make_env(num_envs_scale=1)
    rate1 = measure_rollout_rate(env1, num_steps,
                                 mesh=make_mesh(devices[:1]))
    if n == 1:
        return {"devices": 1, "rate_1dev": rate1, "rate_ndev": rate1,
                "efficiency": 1.0}
    envn = make_env(num_envs_scale=n)
    raten = measure_rollout_rate(envn, num_steps, mesh=make_mesh(devices))
    return {
        "devices": n,
        "rate_1dev": rate1,
        "rate_ndev": raten,
        "efficiency": raten / (n * rate1),
    }
