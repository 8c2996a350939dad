"""shard_map actor-learner: device-local replay sampling, one pmean.

The plain-jit distributed path (dist/train.py) lets the SPMD partitioner
place every op — correct, but the learner's uniform replay sampling
gathers minibatch rows across devices each update. This module expresses
the intended communication pattern explicitly with `shard_map`:

  * each shard rolls out ITS envs and inserts into ITS replay shard
    (zero communication — the (num_envs, capacity) layout guarantees it),
  * each shard samples batch_size/num_shards transitions LOCALLY
    (decorrelated per-shard PRNG via axis_index),
  * the only collectives are the per-update gradient/loss `pmean`s
    (two for DDPG's actor+critic, one for DQN/NAF) plus one metrics
    pmean per train step — all-reduces that XLA hands to NCCL over
    NVLink. Rollout and replay traffic is zero.

Parameter updates stay identical across shards because every shard
applies the same pmean'd gradient with the same replicated optimizer
state (asserted in tests/test_dist.py).

Usage (DDPG, the flagship — other agents follow the same recipe once
given dist_axis support):

    mesh = make_mesh()
    env_global = CartPole3D(params, num_envs=B)
    agent_global = DDPG(env_global, cfg)             # for init only
    state = shard_agent_state(agent_global.init(0), mesh)

    env_local = CartPole3D(params, num_envs=B // mesh.size)
    agent_local = DDPG(env_local, cfg, dist_axis=DATA_AXIS,
                       num_shards=mesh.size)
    step = make_shardmap_train_step(agent_local, mesh, state)
    state, metrics = step(state)
"""

from __future__ import annotations

import jax
from jax.sharding import PartitionSpec as P

try:  # jax >= 0.8
    from jax import shard_map
except ImportError:  # pragma: no cover
    from jax.experimental.shard_map import shard_map

from .mesh import DATA_AXIS
from .train import _BATCH_FIELDS


def state_partition_specs(state, mesh):
    """PartitionSpec pytree for an agent state: array leaves of batch
    fields shard on ('data',) along their leading axis; scalar leaves
    (ring cursors, counters) and non-batch fields replicate — mirroring
    mesh.shard_batch_tree's placement rule."""

    def leaf_spec(x):
        x = jax.numpy.asarray(x)
        if x.ndim >= 1 and x.shape[0] > 1 and x.shape[0] % mesh.size == 0:
            return P(DATA_AXIS)
        return P()

    specs = {}
    for name, value in state._asdict().items():
        if name in _BATCH_FIELDS:
            specs[name] = jax.tree.map(leaf_spec, value)
        else:
            specs[name] = jax.tree.map(lambda _: P(), value)
    return type(state)(**specs)


def _shard_setup(local_agent, mesh, state_template):
    """Shared validation for the shard_map entry points: returns the
    partition specs for the state."""
    if local_agent.dist_axis != DATA_AXIS:
        raise ValueError("local_agent must be built with dist_axis='data'")
    if local_agent.num_shards != mesh.size:
        raise ValueError(f"local_agent.num_shards={local_agent.num_shards} "
                         f"!= mesh.size={mesh.size}")
    return state_partition_specs(state_template, mesh)


def make_shardmap_evaluate(local_agent, mesh, state_template,
                           num_steps: int, seed: int = 0):
    """Sharded deterministic-policy evaluation: each shard rolls out ITS
    envs under the greedy policy and the completed-episode histogram is
    psum'd, so eval scales with the mesh instead of running on the
    global SPMD agent (the reference's 'watch the trained agent' loop
    had one env; here eval is the same batched scan as training).

    Two properties make this the exact twin of the unsharded
    agent.evaluate:
      * env identity — each shard resets its slice with
        index_offset = axis_index * local_num_envs, so per-env pushes
        key on the GLOBAL env index (the layout-independence invariant,
        tests/test_dist.py) and the episode set matches the global run;
      * the policy comes from the LOCAL agent, which reads the
        replicated params of the training state directly.
    Integer episode stats match the unsharded eval exactly; reward_mean
    to fp summation order."""
    specs = _shard_setup(local_agent, mesh, state_template)
    local_b = local_agent.env.num_envs

    def ev(state):
        from ..agents.common import evaluate_policy
        offset = jax.lax.axis_index(DATA_AXIS) * local_b
        return evaluate_policy(
            local_agent.env, local_agent.greedy_policy(state), seed,
            num_steps, index_offset=offset, axis_name=DATA_AXIS)

    kwargs = dict(mesh=mesh, in_specs=(specs,), out_specs=P())
    try:
        fn = shard_map(ev, check_vma=False, **kwargs)
    except TypeError:  # pre-0.8 fallback uses check_rep
        fn = shard_map(ev, check_rep=False, **kwargs)
    return jax.jit(fn)


def make_shardmap_train_step(local_agent, mesh, state_template,
                             capture: bool = False):
    """Jitted shard_map train step.

    local_agent: built with the PER-SHARD env (num_envs/mesh.size) and
    `dist_axis=DATA_AXIS, num_shards=mesh.size`.
    state_template: a GLOBAL agent state (from the global-size agent's
    init + shard_agent_state) used to derive partition specs.
    capture=True additionally returns the rollout chunk in
    metrics["traj"]: each shard contributes its own envs' time-major
    (obs, action, reward, done) slabs, stitched on the batch axis by the
    (None, 'data') out_specs — the event-log sink then sees the same
    global layout the SPMD path produces.
    """
    specs = _shard_setup(local_agent, mesh, state_template)

    def step(state):
        state, metrics = local_agent.train_step(state, capture=capture)
        # Split the (per-shard, batch-sharded) trajectory from the
        # (replicated) scalar metrics: they need different out_specs.
        traj = metrics.pop("traj") if capture else None
        return state, metrics, traj

    # Trajectories are time-major: axis 0 = rollout step, axis 1 = the
    # sharded env batch.
    traj_specs = (P(None, DATA_AXIS),) * 4 if capture else None
    kwargs = dict(mesh=mesh, in_specs=(specs,),
                  out_specs=(specs, P(), traj_specs))
    try:
        body = shard_map(step, check_vma=False, **kwargs)
    except TypeError:  # pre-0.8 fallback uses check_rep
        body = shard_map(step, check_rep=False, **kwargs)
    jitted = jax.jit(body, donate_argnums=(0,))

    def wrapped(state):
        state, metrics, traj = jitted(state)
        if capture:
            metrics["traj"] = traj
        return state, metrics

    return wrapped


def make_shardmap_train_scan(local_agent, mesh, num_calls: int,
                             state_template, capture: bool = False):
    """`num_calls` shard_map train steps as ONE jitted dispatch — the
    chunked-dispatch twin of agents.common.make_train_scan for the
    explicit-communication learner (same contract: stacked time-major
    metrics, metrics["traj"][k] = rollout chunk k when capture=True).

    The `lax.scan` runs INSIDE the shard_map body, so per-shard rollout
    and replay stay device-local across all K train steps and the only
    collectives remain the per-update gradient pmeans (+ one metrics
    pmean per step) — chunking changes the dispatch count, not the
    communication pattern. Trajectories gain a leading scan axis, so
    their out_specs shard axis 2 (the env batch) instead of axis 1.
    """
    specs = _shard_setup(local_agent, mesh, state_template)

    def body(state):
        def one(c, _):
            c, m = local_agent.train_step(c, capture=capture)
            traj = m.pop("traj") if capture else None
            return c, (m, traj)

        state, (metrics, traj) = jax.lax.scan(one, state, None,
                                              length=num_calls)
        return state, metrics, traj

    traj_specs = (P(None, None, DATA_AXIS),) * 4 if capture else None
    kwargs = dict(mesh=mesh, in_specs=(specs,),
                  out_specs=(specs, P(), traj_specs))
    try:
        fn = shard_map(body, check_vma=False, **kwargs)
    except TypeError:  # pre-0.8 fallback uses check_rep
        fn = shard_map(body, check_rep=False, **kwargs)
    jitted = jax.jit(fn, donate_argnums=(0,))

    def wrapped(state):
        state, metrics, traj = jitted(state)
        if capture:
            metrics["traj"] = traj
        return state, metrics

    return wrapped
