"""Distributed-layer tests on the 8-virtual-device CPU mesh (conftest.py).

Reference counterpart: none — the reference is single-process (SURVEY.md
§1); these tests validate the NEW capability of BASELINE config 5
(8192 envs sharded over hosts feeding a DDPG learner via collectives),
scaled down to virtual devices per SURVEY.md §4.
"""


import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu.dist import (
    make_distributed_train_step,
    make_mesh,
    shard_agent_state,
    shard_batch_tree,
    batch_sharding,
)
from cartpoleplusplus_tpu.physics.params import continuous_params


def _rollout_checksum(num_envs, mesh):
    """Deterministic rollout reduced to per-env sums, gathered to host."""
    env = CartPole3D(CartPoleParams(), num_envs=num_envs)
    state, _ = jax.jit(env.reset)(0)
    state = shard_batch_tree(state, mesh)

    def policy(obs, key):
        return (jnp.arange(obs.shape[0], dtype=jnp.int32) % 5)

    def run(state):
        state, (obs, action, reward, done) = env.rollout(state, policy, 32)
        return jnp.sum(obs, axis=(0, 2)), jnp.sum(reward, 0), state

    obs_sum, rew_sum, _ = jax.jit(run)(state)
    return np.asarray(obs_sum), np.asarray(rew_sum)


def test_sharding_layout_independence():
    """Per-env results are bitwise identical on 1-device vs 8-device
    meshes (SURVEY.md §7 hard part 5: seeds from global env index)."""
    devs = jax.devices()
    assert len(devs) >= 8, "conftest must provide 8 virtual devices"
    obs1, rew1 = _rollout_checksum(32, make_mesh(devs[:1]))
    obs8, rew8 = _rollout_checksum(32, make_mesh(devs[:8]))
    np.testing.assert_array_equal(rew1, rew8)
    np.testing.assert_allclose(obs1, obs8, rtol=1e-6)


@pytest.mark.parametrize("n", [2, 8])
def test_ddpg_sharded_train_step(n):
    mesh = make_mesh(jax.devices()[:n])
    env = CartPole3D(continuous_params(), num_envs=8 * n)
    agent = DDPG(env, DDPGConfig(hidden=(32, 32), rollout_steps=2,
                                 updates_per_step=2, batch_size=32,
                                 replay_capacity_per_env=32,
                                 warmup_env_steps=0))
    state = shard_agent_state(agent.init(0), mesh)
    # Batch fields really are sharded over the mesh.
    assert state.obs.sharding.num_devices == n
    step = make_distributed_train_step(agent, mesh)
    for _ in range(2):
        state, metrics = step(state)
    assert np.isfinite(float(metrics["critic_loss"]))
    # Params stay replicated (one copy per device, identical).
    leaf = jax.tree.leaves(state.actor)[0]
    assert leaf.sharding.is_fully_replicated


@pytest.mark.slow
def test_graft_entry_contract():
    """The entry()/dryrun_multichip contract runs on the virtual device
    mesh."""
    import importlib.util
    import os
    spec = importlib.util.spec_from_file_location(
        "__graft_entry__", os.path.join(os.path.dirname(
            os.path.dirname(os.path.abspath(__file__))),
            "__graft_entry__.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    fn, args = mod.entry()
    out = jax.jit(fn)(*args)
    jax.block_until_ready(out)
    mod.dryrun_multichip(8)


def test_scaling_report_runs():
    """The weak-scaling harness executes on the virtual mesh (rates are
    meaningless on CPU; this validates the measurement path itself)."""
    from cartpoleplusplus_tpu.dist import scaling_report

    def make_env(num_envs_scale):
        return CartPole3D(CartPoleParams(), num_envs=16 * num_envs_scale)

    rep = scaling_report(make_env, num_steps=4)
    assert rep["devices"] == len(jax.devices())
    assert rep["rate_1dev"] > 0 and rep["rate_ndev"] > 0
    assert rep["efficiency"] > 0


def test_shardmap_ddpg_train_step():
    """shard_map learner (chip-local sampling + one pmean): runs on the
    8-device mesh, params stay replicated-identical across shards, and a
    second step continues from the donated state."""
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_train_step)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = continuous_params()
    cfg = DDPGConfig(hidden=(16,), rollout_steps=2, updates_per_step=2,
                     batch_size=64, replay_capacity_per_env=16,
                     warmup_env_steps=0)
    env_g = CartPole3D(params, num_envs=8 * n)
    agent_g = DDPG(env_g, cfg)
    state = shard_agent_state(agent_g.init(0), mesh)

    env_l = CartPole3D(params, num_envs=8)
    agent_l = DDPG(env_l, cfg, dist_axis=DATA_AXIS, num_shards=n)
    assert agent_l.local_batch_size == 8
    step = make_shardmap_train_step(agent_l, mesh, state)
    for _ in range(2):
        state, metrics = step(state)
    assert np.isfinite(float(metrics["critic_loss"]))
    assert np.isfinite(float(metrics["reward_mean"]))
    # Replicated params: every device holds the identical copy.
    leaf = jax.tree.leaves(state.actor)[0]
    shards = [np.asarray(leaf.addressable_data(i)) for i in range(n)]
    for sh in shards[1:]:
        np.testing.assert_array_equal(shards[0], sh)
    # Env/replay stayed sharded.
    assert state.obs.sharding.num_devices == n


@pytest.mark.slow
def test_shardmap_train_scan_matches_loop():
    """Chunked dispatch under the shard_map learner: scanning K train
    steps inside the shard_map body computes bitwise the same state as
    K sequential shard_map dispatches, and the captured trajectory
    stacks to the same chunks (stitched on the env axis)."""
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_train_scan,
                                           make_shardmap_train_step)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = continuous_params()
    cfg = DDPGConfig(hidden=(16,), rollout_steps=2, updates_per_step=2,
                     batch_size=64, replay_capacity_per_env=16,
                     warmup_env_steps=0)
    env_g = CartPole3D(params, num_envs=8 * n)
    agent_g = DDPG(env_g, cfg)
    env_l = CartPole3D(params, num_envs=8)
    agent_l = DDPG(env_l, cfg, dist_axis=DATA_AXIS, num_shards=n)

    st_a = shard_agent_state(agent_g.init(0), mesh)
    st_b = shard_agent_state(agent_g.init(0), mesh)
    scan2 = make_shardmap_train_scan(agent_l, mesh, 2, st_a, capture=True)
    step = make_shardmap_train_step(agent_l, mesh, st_b, capture=True)

    st_a, ms = scan2(st_a)
    st_b, m1 = step(st_b)
    traj1 = m1.pop("traj")
    st_b, m2 = step(st_b)
    traj2 = m2.pop("traj")

    for la, lb in zip(jax.tree.leaves(st_a.actor),
                      jax.tree.leaves(st_b.actor)):
        np.testing.assert_array_equal(np.asarray(la), np.asarray(lb))
    np.testing.assert_array_equal(
        np.asarray(ms["critic_loss"]),
        np.asarray([m1["critic_loss"], m2["critic_loss"]]))
    traj = ms.pop("traj")
    for stacked, (a, b) in zip(traj, zip(traj1, traj2)):
        assert stacked.shape == (2,) + a.shape
        np.testing.assert_array_equal(np.asarray(stacked[0]),
                                      np.asarray(a))
        np.testing.assert_array_equal(np.asarray(stacked[1]),
                                      np.asarray(b))


@pytest.mark.parametrize("agent_spec", ["dqn", "naf"])
def test_shardmap_dqn_naf_train_step(agent_spec):
    """The shard_map recipe generalizes beyond the flagship: DQN and NAF
    run with chip-local sampling + pmean'd gradients on the 8-device
    mesh with replicated-identical parameters."""
    from cartpoleplusplus_tpu.agents import DQN, DQNConfig, NAF, NAFConfig
    from cartpoleplusplus_tpu.dist import DATA_AXIS, make_shardmap_train_step

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    if agent_spec == "dqn":
        cls, cfg_cls, params = DQN, DQNConfig, CartPoleParams()
    else:
        cls, cfg_cls, params = NAF, NAFConfig, continuous_params()
    cfg = cfg_cls(hidden=(16,), rollout_steps=2, updates_per_step=1,
                  batch_size=64, replay_capacity_per_env=16,
                  warmup_env_steps=0)
    state = shard_agent_state(
        cls(CartPole3D(params, num_envs=8 * n), cfg).init(0), mesh)
    agent_l = cls(CartPole3D(params, num_envs=8), cfg,
                  dist_axis=DATA_AXIS, num_shards=n)
    step = make_shardmap_train_step(agent_l, mesh, state)
    state, metrics = step(state)
    assert np.isfinite(float(metrics["loss"]))
    leaf = jax.tree.leaves(state[0])[0]
    shards = [np.asarray(leaf.addressable_data(i)) for i in range(n)]
    for sh in shards[1:]:
        np.testing.assert_array_equal(shards[0], sh)


def test_exploration_noise_layout_independent():
    """Agent exploration is a counter-PRNG function of (per-env seed,
    global step): after one train_step from identical inits, the rolled
    env states match bitwise between single-device jit and 8-device
    shard_map (only learner minibatch sampling may differ)."""
    from cartpoleplusplus_tpu.dist import DATA_AXIS, make_shardmap_train_step

    n = 8
    params = continuous_params()
    cfg = DDPGConfig(hidden=(16,), rollout_steps=3, updates_per_step=1,
                     batch_size=64, replay_capacity_per_env=16,
                     warmup_env_steps=1000)  # skip updates: isolate rollout
    env_g = CartPole3D(params, num_envs=8 * n)
    agent_g = DDPG(env_g, cfg)
    st0 = agent_g.init(0)
    ref_state, _ = jax.jit(agent_g.train_step)(
        jax.tree.map(jnp.copy, st0))

    mesh = make_mesh(jax.devices()[:n])
    st_sharded = shard_agent_state(jax.tree.map(jnp.copy, st0), mesh)
    agent_l = DDPG(CartPole3D(params, num_envs=8), cfg,
                   dist_axis=DATA_AXIS, num_shards=n)
    step = make_shardmap_train_step(agent_l, mesh, st_sharded)
    sm_state, _ = step(st_sharded)

    np.testing.assert_array_equal(np.asarray(ref_state.env_state.phys.pos),
                                  np.asarray(sm_state.env_state.phys.pos))
    np.testing.assert_array_equal(np.asarray(ref_state.env_state.phys.s),
                                  np.asarray(sm_state.env_state.phys.s))
    np.testing.assert_array_equal(np.asarray(ref_state.noise),
                                  np.asarray(sm_state.noise))


def test_lrpg_sampling_batch_slot_independent():
    """LRPG's Gumbel-max softmax sampling is a counter-PRNG function of
    (per-env seed, step): the same env presented in any batch slicing
    draws the identical action (jax.random.categorical with a threaded
    key violated this — the draw depended on batch position)."""
    from cartpoleplusplus_tpu.agents import LRPG, LRPGConfig

    env = CartPole3D(CartPoleParams(), num_envs=64)
    agent = LRPG(env, LRPGConfig(hidden=(16,)))
    st = agent.init(0)
    seeds = st.env_state.env_seed
    t = jnp.int32(5)
    a_full = agent.act(st.params, st.obs, seeds, t)
    a_lo = agent.act(st.params, st.obs[:32], seeds[:32], t)
    a_hi = agent.act(st.params, st.obs[32:], seeds[32:], t)
    np.testing.assert_array_equal(
        np.asarray(a_full),
        np.concatenate([np.asarray(a_lo), np.asarray(a_hi)]))


@pytest.mark.slow
def test_shardmap_lrpg_matches_single_device():
    """LRPG under shard_map matches the single-device agent on the union
    window: the window statistics (returns baseline, advantage
    mean/std) pmean to the global values and the gradient pmeans, with
    replicated-identical params."""
    from cartpoleplusplus_tpu.agents import LRPG, LRPGConfig
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_train_step)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = CartPoleParams()
    cfg = LRPGConfig(hidden=(16, 16), rollout_steps=2)

    # Single-device reference on the global env.
    ag_g = LRPG(CartPole3D(params, num_envs=8 * n), cfg)
    st_g = ag_g.init(0)
    step_g = ag_g.make_train_step()
    for _ in range(3):
        st_g, m_g = step_g(st_g)

    tol = dict(rtol=2e-4, atol=1e-5)
    st = shard_agent_state(
        LRPG(CartPole3D(params, num_envs=8 * n), cfg).init(0), mesh)
    agent_l = LRPG(CartPole3D(params, num_envs=8), cfg,
                   dist_axis=DATA_AXIS, num_shards=n)
    step = make_shardmap_train_step(agent_l, mesh, st)
    for _ in range(3):
        st, metrics = step(st)
    for lx, lg in zip(jax.tree.leaves(st.params),
                      jax.tree.leaves(st_g.params)):
        np.testing.assert_allclose(np.asarray(lx), np.asarray(lg), **tol)
    np.testing.assert_allclose(float(st.baseline), float(st_g.baseline),
                               **tol)
    np.testing.assert_allclose(float(metrics["loss"]), float(m_g["loss"]),
                               **tol)
    # Params stay bitwise-identical across shards.
    leaf = jax.tree.leaves(st.params)[0]
    shards = [np.asarray(leaf.addressable_data(i)) for i in range(n)]
    for sh in shards[1:]:
        np.testing.assert_array_equal(shards[0], sh)


@pytest.mark.slow
def test_shardmap_evaluate_matches_global():
    """Sharded eval (dist/shardmap.py::make_shardmap_evaluate) is the
    exact twin of the global agent.evaluate: each shard resets its env
    slice with GLOBAL env identities (reset index_offset =
    axis_index * local_b) and the completed-episode histogram is psum'd.
    Integer episode statistics must match the unsharded eval EXACTLY
    (any off-by-one in env identity or a flipped done would change the
    histogram); reward_mean to fp summation order."""
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_evaluate)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = continuous_params()
    cfg = DDPGConfig(hidden=(16, 16), rollout_steps=2, updates_per_step=1,
                     batch_size=64, replay_capacity_per_env=16,
                     warmup_env_steps=0)
    env_g = CartPole3D(params, num_envs=8 * n)
    agent_g = DDPG(env_g, cfg)
    st_g = agent_g.init(0)
    # A couple of train steps so the policy is not the init weights.
    step_g = agent_g.make_train_step()
    for _ in range(2):
        st_g, _ = step_g(st_g)
    ref = {k: float(v) for k, v in jax.jit(
        agent_g.evaluate, static_argnums=(1, 2))(st_g, 30, 0).items()}

    agent_l = DDPG(CartPole3D(params, num_envs=8), cfg,
                   dist_axis=DATA_AXIS, num_shards=n)
    st_l = shard_agent_state(st_g, mesh)
    got = {k: float(v) for k, v in make_shardmap_evaluate(
        agent_l, mesh, st_l, 30, 0)(st_l).items()}

    assert set(got) == set(ref)
    for k in ("episodes", "mean_episode_length", "median_episode_length",
              "max_episode_length"):
        assert got[k] == ref[k], (k, got[k], ref[k])
    np.testing.assert_allclose(got["reward_mean"], ref["reward_mean"],
                               rtol=1e-6)
    np.testing.assert_allclose(got["done_frac"], ref["done_frac"],
                               rtol=1e-6)


def test_shardmap_dqn_learns():
    """Multi-device LEARNING, not just parity (VERDICT r3 item 6 /
    BASELINE config 5): DQN trained entirely through the shard_map
    learner on the 8-device mesh — chip-local rollout + replay, gradient
    pmean — must beat the random baseline >=2x on the exact
    completed-episode statistics, evaluated through the SHARDED eval
    path. Budget mirrors tests/test_learning.py::test_dqn_learns_discrete
    (same recipe, 64 envs -> 8 per shard); a dropped collective or a
    per-shard lr/batch scaling bug collapses this to ~random."""
    from cartpoleplusplus_tpu.agents import DQN, DQNConfig, RandomAgent
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_evaluate,
                                           make_shardmap_train_scan)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = CartPoleParams()
    cfg = DQNConfig(hidden=(64, 64), rollout_steps=16,
                    updates_per_step=8, batch_size=128,
                    replay_capacity_per_env=512, lr=5e-4,
                    eps_decay_env_steps=1200, eps_end=0.05,
                    warmup_env_steps=32, sample="uniform")
    env_g = CartPole3D(params, num_envs=8 * n)
    state = shard_agent_state(DQN(env_g, cfg).init(0), mesh)
    agent_l = DQN(CartPole3D(params, num_envs=8), cfg,
                  dist_axis=DATA_AXIS, num_shards=n)

    k = 5  # 25 dispatches x 5 scanned train steps = 2000 per-env steps
    scan = make_shardmap_train_scan(agent_l, mesh, k, state)
    for _ in range((2000 // 16) // k):
        state, _ = scan(state)
    stats = {key: float(v) for key, v in make_shardmap_evaluate(
        agent_l, mesh, state, 400, 7)(state).items()}

    rand = {key: float(v) for key, v in jax.jit(
        RandomAgent(env_g).evaluate, static_argnums=(1,))(
            jax.random.PRNGKey(7), 400).items()}
    assert stats["episodes"] > 0
    assert stats["mean_episode_length"] > 2.0 * rand["mean_episode_length"], (
        f"sharded greedy {stats['mean_episode_length']:.1f} vs random "
        f"{rand['mean_episode_length']:.1f} — shard_map learner did not "
        "learn (collective / per-shard scaling regression?)")


# --- pixels x distributed composition (VERDICT r4 item 3) -------------------
#
# Config 4 (pixels) and config 5 (sharded training) were never composed
# before round 5: a sharded pixel train step exercises the quantized
# shard-aligned ring, the render path and the uint8 obs
# stack under both the SPMD partitioner and shard_map bodies.

def _pixel_cfg():
    from cartpoleplusplus_tpu.env.pixels import RenderConfig
    return RenderConfig(width=16, height=16, grayscale=True,
                        obs_uint8=True, frame_diff=True,
                        frame_diff_gain=4.0)


def test_pixel_rollout_layout_independent():
    """Pixel observations are bitwise identical on 1-device vs 8-device
    meshes: rendering is a pure function of phys state, and per-env
    randomness is keyed by global env index (CLAUDE.md invariant)."""
    def checksum(mesh):
        env = CartPole3D(CartPoleParams(), num_envs=16, obs_mode="pixels",
                         render_config=_pixel_cfg())
        state, _ = jax.jit(env.reset)(0)
        state = shard_batch_tree(state, mesh)

        def policy(obs, key):
            return (jnp.arange(obs.shape[0], dtype=jnp.int32) % 5)

        def run(state):
            state, (obs, action, reward, done) = env.rollout(
                state, policy, 8)
            return (jnp.sum(obs.astype(jnp.int32), axis=(0, 2, 3, 4)),
                    jnp.sum(reward, 0))

        obs_sum, rew_sum = jax.jit(run)(state)
        return np.asarray(obs_sum), np.asarray(rew_sum)

    devs = jax.devices()
    obs1, rew1 = checksum(make_mesh(devs[:1]))
    obs8, rew8 = checksum(make_mesh(devs[:8]))
    np.testing.assert_array_equal(rew1, rew8)
    np.testing.assert_array_equal(obs1, obs8)


@pytest.mark.slow
def test_spmd_pixel_ddpg_train_step():
    """Sharded pixel-DDPG under the SPMD partitioner: quantized ring +
    render + conv learner all shard on the env axis; params replicate."""
    mesh = make_mesh(jax.devices()[:8])
    env = CartPole3D(continuous_params(), num_envs=64, obs_mode="pixels",
                     render_config=_pixel_cfg())
    agent = DDPG(env, DDPGConfig(hidden=(32, 32), rollout_steps=2,
                                 updates_per_step=2, batch_size=32,
                                 replay_capacity_per_env=8,
                                 warmup_env_steps=0))
    assert agent.replay.quantize_obs
    state = shard_agent_state(agent.init(0), mesh)
    assert state.obs.sharding.num_devices == 8
    assert state.replay.obs.dtype == jnp.uint8
    step = make_distributed_train_step(agent, mesh)
    for _ in range(2):
        state, metrics = step(state)
    assert np.isfinite(float(metrics["critic_loss"]))
    assert jax.tree.leaves(state.actor)[0].sharding.is_fully_replicated


def test_shardmap_pixel_ddpg_train_step():
    """Sharded pixel-DDPG through the shard_map learner (chip-local
    quantized ring + render per shard, one gradient pmean): params stay
    bitwise-replicated across shards, env/replay stay sharded."""
    from cartpoleplusplus_tpu.dist import (DATA_AXIS,
                                           make_shardmap_train_step)

    n = 8
    mesh = make_mesh(jax.devices()[:n])
    params = continuous_params()
    cfg = DDPGConfig(hidden=(32, 32), rollout_steps=2, updates_per_step=2,
                     batch_size=32, replay_capacity_per_env=8,
                     warmup_env_steps=0)
    rcfg = _pixel_cfg()
    env_g = CartPole3D(params, num_envs=8 * n, obs_mode="pixels",
                       render_config=rcfg)
    state = shard_agent_state(DDPG(env_g, cfg).init(0), mesh)
    env_l = CartPole3D(params, num_envs=8, obs_mode="pixels",
                       render_config=rcfg)
    agent_l = DDPG(env_l, cfg, dist_axis=DATA_AXIS, num_shards=n)
    step = make_shardmap_train_step(agent_l, mesh, state)
    for _ in range(2):
        state, metrics = step(state)
    assert np.isfinite(float(metrics["critic_loss"]))
    assert np.isfinite(float(metrics["reward_mean"]))
    leaf = jax.tree.leaves(state.actor)[0]
    shards = [np.asarray(leaf.addressable_data(i)) for i in range(n)]
    for sh in shards[1:]:
        np.testing.assert_array_equal(shards[0], sh)
    assert state.replay.obs.sharding.num_devices == n
