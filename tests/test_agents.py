"""Agent-layer tests: replay semantics + one fused train_step per agent.

Reference counterpart for coverage (SURVEY.md §4): the reference had no
test suite; its de-facto smoke test was the random-action baseline. Here
every trainer family (random, LRPG, DQN, NAF, DDPG) gets a smoke +
learning-signal test on a small batch, and the replay buffer is checked
against its documented ring semantics.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu.agents import (
    DDPG, DDPGConfig, DQN, DQNConfig, LRPG, LRPGConfig, NAF, NAFConfig,
    RandomAgent, ReplayBuffer,
)
from cartpoleplusplus_tpu.physics.params import continuous_params

SMALL = dict(hidden=(32, 32), rollout_steps=4, updates_per_step=2,
             batch_size=32, replay_capacity_per_env=64, warmup_env_steps=4)


def _check_finite(metrics):
    for k, v in metrics.items():
        assert np.all(np.isfinite(np.asarray(v))), f"{k} not finite: {v}"


# --- replay ------------------------------------------------------------------

def test_replay_ring_and_sample():
    rb = ReplayBuffer(num_envs=4, capacity_per_env=8, obs_dim=3,
                      discrete=True)
    rs = rb.init()
    add = jax.jit(rb.add)
    # Write 11 steps -> wraps the 8-slot ring.
    for t in range(11):
        obs = jnp.full((4, 3), float(t))
        action = jnp.full((4,), t % 5, jnp.int32)
        reward = jnp.full((4,), float(t))
        done = jnp.zeros((4,), bool)
        rs = add(rs, obs, action, reward, done)
    assert int(rs.cursor) == 11 % 8
    assert int(rs.filled) == 8
    # Slot content: slot i holds the latest t with t % 8 == i.
    np.testing.assert_allclose(np.asarray(rs.reward[0]),
                               [8, 9, 10, 3, 4, 5, 6, 7])
    obs, action, reward, next_obs, done = rb.sample(
        rs, jax.random.PRNGKey(0), 256)
    # next_obs must be chronologically reward+1 for every sampled row
    # (no episode boundaries in this stream).
    np.testing.assert_allclose(np.asarray(next_obs[:, 0]),
                               np.asarray(reward) + 1.0)
    # The newest slot (t=10) has no successor and must never be sampled.
    assert not np.any(np.asarray(reward) == 10.0)


def test_replay_trajectory_add_matches_loop():
    rb = ReplayBuffer(num_envs=2, capacity_per_env=16, obs_dim=2,
                      action_dim=2, discrete=False)
    t, b = 5, 2
    key = jax.random.PRNGKey(1)
    obs = jax.random.normal(key, (t, b, 2))
    act = jax.random.normal(key, (t, b, 2))
    rew = jax.random.normal(key, (t, b))
    done = jax.random.bernoulli(key, 0.3, (t, b))
    rs_loop = rb.init()
    for i in range(t):
        rs_loop = rb.add(rs_loop, obs[i], act[i], rew[i], done[i])
    rs_traj = rb.add_trajectory(rb.init(), obs, act, rew, done)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b),
                 rs_loop, rs_traj)


def test_replay_trajectory_fast_path_matches_loop():
    """Chunk-length-divides-capacity inserts take the single-slice fast
    path; contents must equal the per-step loop bit for bit, including
    across the ring wrap."""
    rb = ReplayBuffer(num_envs=2, capacity_per_env=8, obs_dim=2,
                      action_dim=2, discrete=False)
    t, b = 4, 2
    rs_loop, rs_fast = rb.init(), rb.init()
    key = jax.random.PRNGKey(3)
    for chunk in range(3):  # 12 rows through an 8-slot ring: wraps
        k = jax.random.fold_in(key, chunk)
        obs = jax.random.normal(k, (t, b, 2))
        act = jax.random.normal(k, (t, b, 2))
        rew = jax.random.normal(k, (t, b))
        done = jax.random.bernoulli(k, 0.3, (t, b))
        for i in range(t):
            rs_loop = rb.add(rs_loop, obs[i], act[i], rew[i], done[i])
        rs_fast = jax.jit(rb.add_trajectory)(rs_fast, obs, act, rew, done)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b),
                 rs_loop, rs_fast)


def test_replay_sample_columns_semantics():
    """Column sampling returns real transitions: next_obs is the
    chronologically next slot for every returned row, rows span all
    envs, and trimming handles batch_size not a multiple of num_envs."""
    rb = ReplayBuffer(num_envs=4, capacity_per_env=8, obs_dim=1,
                      discrete=True)
    rs = rb.init()
    for t in range(8):
        rs = rb.add(rs, jnp.full((4, 1), float(t)),
                    jnp.zeros((4,), jnp.int32), jnp.full((4,), float(t)),
                    jnp.zeros((4,), bool))
    for bs in (4, 8, 6):
        obs, action, reward, next_obs, done = jax.jit(
            rb.sample_columns, static_argnums=2)(
            rs, jax.random.PRNGKey(1), bs)
        assert obs.shape == (bs, 1)
        np.testing.assert_allclose(np.asarray(next_obs[:, 0]),
                                   np.asarray(obs[:, 0]) + 1.0)
        np.testing.assert_allclose(np.asarray(reward),
                                   np.asarray(obs[:, 0]))


def test_replay_trajectory_misaligned_cursor_falls_back():
    """A bare add() desyncs the cursor from the chunk length; the cond
    fallback must keep semantics identical to the per-step loop."""
    rb = ReplayBuffer(num_envs=2, capacity_per_env=8, obs_dim=2,
                      action_dim=2, discrete=False)
    t, b = 4, 2
    key = jax.random.PRNGKey(4)
    obs = jax.random.normal(key, (t, b, 2))
    act = jax.random.normal(key, (t, b, 2))
    rew = jax.random.normal(key, (t, b))
    done = jax.random.bernoulli(key, 0.3, (t, b))
    rs_loop = rb.add(rb.init(), obs[0], act[0], rew[0], done[0])
    rs_fast = rb.add(rb.init(), obs[0], act[0], rew[0], done[0])
    for i in range(t):
        rs_loop = rb.add(rs_loop, obs[i], act[i], rew[i], done[i])
    rs_fast = jax.jit(rb.add_trajectory)(rs_fast, obs, act, rew, done)
    jax.tree.map(lambda a, b: np.testing.assert_allclose(a, b),
                 rs_loop, rs_fast)


# --- agents ------------------------------------------------------------------

def test_random_agent_smoke():
    env = CartPole3D(CartPoleParams(), num_envs=16)
    stats = jax.jit(RandomAgent(env).evaluate, static_argnums=(1,))(
        jax.random.PRNGKey(0), 64)
    _check_finite(stats)
    assert float(stats["episodes"]) > 0  # random policy must fail sometimes


@pytest.mark.parametrize("agent_cls,cfg_cls,params", [
    (DQN, DQNConfig, CartPoleParams()),
    (DDPG, DDPGConfig, continuous_params()),
    (NAF, NAFConfig, continuous_params()),
])
def test_replay_agent_train_steps(agent_cls, cfg_cls, params):
    env = CartPole3D(params, num_envs=8)
    fields = set(cfg_cls.__dataclass_fields__)
    agent = agent_cls(env, cfg_cls(**{k: v for k, v in SMALL.items()
                                      if k in fields}))
    st = agent.init(0)
    step = agent.make_train_step()
    for _ in range(3):
        st, metrics = step(st)
    _check_finite(metrics)
    assert int(metrics["env_steps"]) == 12
    # Warmup passed -> losses are real numbers from actual updates.
    loss_key = "loss" if "loss" in metrics else "critic_loss"
    assert np.isfinite(float(metrics[loss_key]))


def test_lrpg_train_step():
    env = CartPole3D(CartPoleParams(), num_envs=8)
    agent = LRPG(env, LRPGConfig(hidden=(32, 32), rollout_steps=8))
    st = agent.init(0)
    step = agent.make_train_step()
    for _ in range(2):
        st, metrics = step(st)
    _check_finite(metrics)


def test_ddpg_actions_bounded_and_deterministic():
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(hidden=(32, 32)))
    st = agent.init(0)
    a1 = agent.act(st.actor, st.obs)
    a2 = agent.act(st.actor, st.obs)
    np.testing.assert_array_equal(np.asarray(a1), np.asarray(a2))
    assert np.all(np.abs(np.asarray(a1)) <= 1.0)


# --- evaluation accounting ---------------------------------------------------

def test_episode_length_hist_hand_patterns():
    """Exact per-episode accounting on hand-constructed done patterns
    (VERDICT round 1: the old steps/episodes ratio over-counted censored
    tails). Env 0 finishes episodes of length 2 and 3 then a censored
    tail; env 1 finishes one length-1 and one length-4 episode; env 2
    never finishes (fully censored)."""
    from cartpoleplusplus_tpu.agents.common import (
        episode_length_hist, episode_stats_from_hist)
    done = jnp.array([
        #  env0   env1   env2
        [False,  True, False],   # t=1
        [True,  False, False],   # t=2
        [False, False, False],   # t=3
        [False, False, False],   # t=4
        [True,   True, False],   # t=5: env0 len-3, env1 len-4
        [False, False, False],   # censored tails
    ])
    hist = np.asarray(episode_length_hist(done, cap=10))
    expect = np.zeros(11, np.int32)
    expect[2] = 1   # env0 first episode
    expect[3] = 1   # env0 second
    expect[1] = 1   # env1 first
    expect[4] = 1   # env1 second
    np.testing.assert_array_equal(hist, expect)
    stats = episode_stats_from_hist(jnp.asarray(hist))
    assert int(stats["episodes"]) == 4
    np.testing.assert_allclose(float(stats["mean_episode_length"]), 2.5)
    assert int(stats["median_episode_length"]) == 2
    assert int(stats["max_episode_length"]) == 4
    # Empty histogram: zeros, not NaNs.
    empty = episode_stats_from_hist(jnp.zeros(11, jnp.int32))
    assert int(empty["episodes"]) == 0
    assert float(empty["mean_episode_length"]) == 0.0


def test_evaluate_policy_exact_invariants():
    """evaluate_policy's episode count equals the total number of dones
    (every done completes exactly one episode; censored tails excluded
    from the length stats)."""
    from cartpoleplusplus_tpu.agents.common import evaluate_policy
    env = CartPole3D(CartPoleParams(), num_envs=16)
    agent = RandomAgent(env)
    num_steps = 64
    stats = jax.jit(lambda k: evaluate_policy(
        env, agent.policy, k, num_steps, needs_key=True))(
        jax.random.PRNGKey(0))
    episodes = int(stats["episodes"])
    assert episodes > 0
    np.testing.assert_allclose(
        float(stats["done_frac"]) * num_steps * env.num_envs, episodes,
        rtol=1e-5)
    assert 1.0 <= float(stats["mean_episode_length"]) <= 200.0
    assert (stats["median_episode_length"]
            <= stats["max_episode_length"])


def test_dqn_epsilon_no_decay_guard():
    """eps_decay_env_steps=0 must yield a finite constant epsilon, not
    0/0 (round-1 advisor finding)."""
    env = CartPole3D(CartPoleParams(), num_envs=4)
    agent = DQN(env, DQNConfig(hidden=(16,), eps_decay_env_steps=0))
    for steps in (0, 100):
        eps = float(agent.epsilon(jnp.int32(steps)))
        assert np.isfinite(eps)
        np.testing.assert_allclose(eps, agent.cfg.eps_end, rtol=1e-6)


def test_dqn_no_divergence():
    """Sanity: TD loss stays bounded over training on the real env (the
    real learning assertion lives in test_learning.py)."""
    env = CartPole3D(CartPoleParams(), num_envs=16)
    agent = DQN(env, DQNConfig(hidden=(32, 32), rollout_steps=8,
                               updates_per_step=4, batch_size=64,
                               replay_capacity_per_env=256,
                               warmup_env_steps=8))
    st = agent.init(0)
    step = agent.make_train_step()
    losses = []
    for _ in range(30):
        st, metrics = step(st)
        losses.append(float(metrics["loss"]))
    early = np.mean(losses[2:8])
    late = np.mean(losses[-6:])
    assert np.isfinite(late)
    assert late < early * 5.0  # no divergence


@pytest.mark.slow
def test_ddpg_from_pixels_smoke():
    """BASELINE config 4: DDPG on rendered frames (conv nets, uint8
    replay). Tiny shapes; one fused train step must run and be finite."""
    from cartpoleplusplus_tpu.env import RenderConfig
    env = CartPole3D(continuous_params(), num_envs=4,
                     obs_mode="pixels",
                     render_config=RenderConfig(width=16, height=16))
    agent = DDPG(env, DDPGConfig(hidden=(16,), rollout_steps=2,
                                 updates_per_step=1, batch_size=8,
                                 replay_capacity_per_env=8,
                                 warmup_env_steps=0))
    st = agent.init(0)
    assert st.replay.obs.dtype == jnp.uint8  # quantized frame storage
    step = agent.make_train_step()
    st, metrics = step(st)
    _check_finite(metrics)
    # Round-trip through the quantized replay stays within 1/255.
    obs, _, _, _, _ = agent.replay.sample(st.replay, jax.random.PRNGKey(0), 8)
    assert obs.dtype == jnp.float32
    assert float(obs.max()) <= 1.0 and float(obs.min()) >= 0.0


def test_ddpg_bfloat16_compute():
    """dtype="bfloat16" (the tensor-core half dtype) trains finitely: params stay
    fp32, network compute runs in bf16."""
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(hidden=(32,), rollout_steps=2,
                                 updates_per_step=1, batch_size=16,
                                 replay_capacity_per_env=16,
                                 warmup_env_steps=0, dtype="bfloat16"))
    st = agent.init(0)
    assert jax.tree.leaves(st.actor)[0].dtype == jnp.float32  # fp32 params
    step = agent.make_train_step()
    for _ in range(2):
        st, metrics = step(st)
    _check_finite(metrics)
    a = agent.act(st.actor, st.obs)
    assert a.dtype == jnp.float32 and np.all(np.abs(np.asarray(a)) <= 1.0)


@pytest.mark.slow
def test_presample_matches_sequential_sampling():
    """The learner's hoisted K-minibatch presample (agents/common.py::
    replay_presample, one vmapped gather before the update scan) draws
    bitwise the batches that per-key sampling inside the scan would
    have drawn — the latency optimization must not change what the
    learner trains on."""
    from cartpoleplusplus_tpu.agents.common import (replay_presample,
                                                    replay_sampler)

    env = CartPole3D(continuous_params(), num_envs=16)
    agent = DDPG(env, DDPGConfig(hidden=(32,), rollout_steps=8,
                                 batch_size=24,  # not a multiple of B:
                                 replay_capacity_per_env=32,  # trim path
                                 warmup_env_steps=0))
    st = agent.init(0)
    st, _ = agent.train_step(st)
    keys = jax.random.split(jax.random.PRNGKey(11), 5)
    for mode in ("column", "uniform"):
        pre = replay_presample(agent.replay, mode, 24, 1, None)
        one = replay_sampler(agent.replay, mode, 24, 1, None)
        stacked = pre(st, keys)
        for i in range(len(keys)):
            seq = one(st.replay, keys[i])
            got = jax.tree.map(lambda x: x[i], stacked)
            for a, b in zip(seq, got):
                assert a.shape == b.shape and bool((a == b).all()), mode


def test_ddpg_actor_grad_critic_pre_variant():
    """actor_grad_critic="pre" (actor gradient through the pre-update
    critic, decoupling the two backward passes) trains finitely and
    moves the actor."""
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(hidden=(32,), rollout_steps=4,
                                 updates_per_step=2, batch_size=16,
                                 replay_capacity_per_env=16,
                                 warmup_env_steps=0,
                                 actor_grad_critic="pre"))
    st = agent.init(0)
    a0 = jax.tree.leaves(st.actor)[0].copy()
    step = agent.make_train_step()
    for _ in range(3):
        st, metrics = step(st)
    _check_finite(metrics)
    assert not np.allclose(np.asarray(jax.tree.leaves(st.actor)[0]),
                           np.asarray(a0))


def test_ddpg_polyak_per_step_cadence():
    """polyak_cadence="per_step" applies one compounded target pull
    1-(1-tau)^K outside the update scan; the compounded rate is exactly
    K successive per-update polyaks toward a fixed online net, and
    training under the cadence stays finite and moves the targets."""
    from cartpoleplusplus_tpu.models import polyak

    # Identity on a fixed online net.
    tgt = {"w": jnp.ones((4,)) * 2.0}
    online = {"w": jnp.full((4,), 10.0)}
    tau, k = 0.01, 16
    seq = tgt
    for _ in range(k):
        seq = polyak(seq, online, tau)
    once = polyak(tgt, online, 1.0 - (1.0 - tau) ** k)
    np.testing.assert_allclose(np.asarray(seq["w"]), np.asarray(once["w"]),
                               rtol=1e-6)

    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(hidden=(32,), rollout_steps=4,
                                 updates_per_step=3, batch_size=16,
                                 replay_capacity_per_env=16,
                                 warmup_env_steps=0,
                                 polyak_cadence="per_step"))
    st = agent.init(0)
    t0 = jax.tree.leaves(st.critic_target)[0].copy()
    step = agent.make_train_step()
    for _ in range(3):
        st, metrics = step(st)
    _check_finite(metrics)
    assert not np.allclose(np.asarray(jax.tree.leaves(st.critic_target)[0]),
                           np.asarray(t0))


def test_presample_columns_bitwise_matches_vmapped_sampling():
    """ReplayBuffer.presample_columns (one gather per ring buffer) must
    produce bitwise the batches of vmap(sample_columns) over the K
    update keys — the contract that lets the fast path replace the
    vmapped one under any learner (docs/design.md §8e)."""
    rb = ReplayBuffer(num_envs=16, capacity_per_env=32, obs_dim=6,
                      action_dim=2, discrete=False)
    rs = rb.init()
    add = jax.jit(rb.add)
    rng = np.random.RandomState(0)
    for t in range(40):  # wraps the ring
        rs = add(rs,
                 jnp.asarray(rng.randn(16, 6), jnp.float32),
                 jnp.asarray(rng.rand(16, 2), jnp.float32),
                 jnp.asarray(rng.rand(16), jnp.float32),
                 jnp.asarray(rng.rand(16) < 0.2))
    keys = jax.random.split(jax.random.PRNGKey(7), 5)
    batch = 32  # 2 whole columns
    fast = jax.jit(lambda r, k: rb.presample_columns(r, k, batch))(rs, keys)
    slow = jax.jit(jax.vmap(lambda r, k: rb.sample_columns(r, k, batch),
                            in_axes=(None, 0)))(rs, keys)
    for f, s in zip(fast, slow):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(s))


def test_presample_uniform_bitwise_matches_vmapped_sampling():
    """ReplayBuffer.presample_uniform (one flat gather per buffer) must
    produce bitwise the batches of vmap(sample) over the K update keys."""
    rb = ReplayBuffer(num_envs=8, capacity_per_env=16, obs_dim=4,
                      discrete=True)
    rs = rb.init()
    add = jax.jit(rb.add)
    rng = np.random.RandomState(1)
    for t in range(20):
        rs = add(rs,
                 jnp.asarray(rng.randn(8, 4), jnp.float32),
                 jnp.asarray(rng.randint(0, 5, 8), jnp.int32),
                 jnp.asarray(rng.rand(8), jnp.float32),
                 jnp.asarray(rng.rand(8) < 0.2))
    keys = jax.random.split(jax.random.PRNGKey(9), 4)
    fast = jax.jit(lambda r, k: rb.presample_uniform(r, k, 24))(rs, keys)
    slow = jax.jit(jax.vmap(lambda r, k: rb.sample(r, k, 24),
                            in_axes=(None, 0)))(rs, keys)
    for f, s in zip(fast, slow):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(s))


@pytest.mark.parametrize("agent_cls,cfg_cls,params", [
    (DQN, DQNConfig, CartPoleParams()),
    (DDPG, DDPGConfig, continuous_params()),
    (NAF, NAFConfig, continuous_params()),
    (LRPG, LRPGConfig, CartPoleParams()),
])
def test_train_scan_matches_loop(agent_cls, cfg_cls, params):
    """make_train_scan(K) is bitwise K sequential train steps: the same
    final state and the per-step metrics stacked time-major (the chunked
    dispatch changes WHEN work is enqueued, never what is computed)."""
    env = CartPole3D(params, num_envs=8)
    fields = set(cfg_cls.__dataclass_fields__)
    agent = agent_cls(env, cfg_cls(**{k: v for k, v in SMALL.items()
                                      if k in fields}))
    k = 3
    st_loop = agent.init(0)
    step = agent.make_train_step()
    loop_metrics = []
    for _ in range(k):
        st_loop, m = step(st_loop)
        loop_metrics.append(m)

    st_scan, ms = agent.make_train_scan(k)(agent.init(0))

    for a, b in zip(jax.tree.leaves(st_loop), jax.tree.leaves(st_scan)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for i, m in enumerate(loop_metrics):
        for key, v in m.items():
            np.testing.assert_array_equal(
                np.asarray(v), np.asarray(ms[key][i]), err_msg=key)


def test_updates_per_step_zero_is_rollout_only():
    """updates_per_step=0 is the rollout-only decomposition cadence:
    the learner phase is skipped entirely — params unchanged, zero (not
    NaN) losses, rollout/replay still advance."""
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(hidden=(16, 16), rollout_steps=2,
                                 updates_per_step=0, batch_size=8,
                                 replay_capacity_per_env=8,
                                 warmup_env_steps=0))
    st = agent.init(0)
    actor0 = jax.tree.map(np.asarray, st.actor)
    st, m = agent.make_train_step()(st)
    assert float(m["critic_loss"]) == 0.0
    assert float(m["actor_loss"]) == 0.0
    assert np.isfinite(float(m["reward_mean"]))
    assert int(st.replay.filled) == 2
    for a, b in zip(jax.tree.leaves(actor0), jax.tree.leaves(st.actor)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.slow
def test_train_scan_capture_matches_loop_chunks():
    """capture=True under the scan stacks per-call rollout chunks that
    are bitwise the chunks K sequential capture=True calls produce —
    what the event-log sink consumes under chunked dispatch."""
    env = CartPole3D(continuous_params(), num_envs=8)
    agent = DDPG(env, DDPGConfig(**SMALL))
    k = 3
    st = agent.init(0)
    step = agent.make_train_step(capture=True)
    loop_chunks = []
    for _ in range(k):
        st, m = step(st)
        loop_chunks.append(m.pop("traj"))

    _, ms = agent.make_train_scan(k, capture=True)(agent.init(0))
    stacked = ms.pop("traj")   # tuple of (k, T, B, ...) stacked arrays
    for i, chunk in enumerate(loop_chunks):
        for field_scan, field_loop in zip(stacked, chunk):
            np.testing.assert_array_equal(np.asarray(field_scan[i]),
                                          np.asarray(field_loop))


@pytest.mark.slow
def test_ddpg_lr_decay_schedule():
    """lr_decay_env_steps wires a linear optax schedule into both
    optimizers (gradient-step keyed) and trains finitely."""
    import math

    from cartpoleplusplus_tpu.physics.params import continuous_params

    env = CartPole3D(continuous_params(), num_envs=32)
    cfg = dict(hidden=(16, 16), rollout_steps=4, updates_per_step=2,
               batch_size=32, replay_capacity_per_env=16,
               warmup_env_steps=0)
    ag_d = DDPG(env, DDPGConfig(lr_decay_env_steps=8, **cfg))
    ag_c = DDPG(env, DDPGConfig(**cfg))
    st = ag_d.init(0)
    step = jax.jit(ag_d.train_step)
    for _ in range(6):
        st, m = step(st)
    assert int(st.critic_opt[0].count) == 12
    assert math.isfinite(float(m["critic_loss"]))
    # Decayed-lr params diverge from the constant-lr run (same seed).
    st_c = ag_c.init(0)
    step_c = jax.jit(ag_c.train_step)
    for _ in range(6):
        st_c, _ = step_c(st_c)
    leaves = zip(jax.tree.leaves(st.critic), jax.tree.leaves(st_c.critic))
    assert any(float(jnp.max(jnp.abs(a - b))) > 0 for a, b in leaves)


def test_pixel_presample_storage_dtype_matches_decoded():
    """Quantized (pixel) replay presampling returns STORAGE-dtype (uint8)
    frames (round-4 throughput fix — agents/common.py::replay_presample);
    decoding them must reproduce the decode=True batches exactly, and the
    encoders' own uint8 handling (x * 1/255) is that same decode."""
    from cartpoleplusplus_tpu.agents.replay import ReplayBuffer

    rng = np.random.default_rng(3)
    buf = ReplayBuffer(num_envs=8, capacity_per_env=16,
                       obs_shape=(6, 6, 2), action_dim=2, discrete=False,
                       quantize_obs=True)
    rs = buf.init()
    for t in range(20):
        obs = jnp.asarray(rng.random((8, 6, 6, 2)), jnp.float32)
        act = jnp.asarray(rng.random((8, 2)), jnp.float32)
        rew = jnp.asarray(rng.random(8), jnp.float32)
        done = jnp.asarray(rng.random(8) < 0.1)
        rs = buf.add(rs, obs, act, rew, done)

    keys = jax.random.split(jax.random.PRNGKey(5), 4)
    for fn, bs in ((buf.presample_uniform, 32),
                   (buf.presample_columns, 8)):
        raw = fn(rs, keys, bs, decode=False)
        dec = fn(rs, keys, bs, decode=True)
        assert raw[0].dtype == jnp.uint8 and raw[3].dtype == jnp.uint8
        assert raw[0].shape == dec[0].shape  # frame-shaped either way
        np.testing.assert_array_equal(
            np.asarray(raw[0].astype(jnp.float32)
                       * jnp.float32(1.0 / 255.0)),
            np.asarray(dec[0]))
        np.testing.assert_array_equal(
            np.asarray(raw[3].astype(jnp.float32)
                       * jnp.float32(1.0 / 255.0)),
            np.asarray(dec[3]))
        for i in (1, 2, 4):
            np.testing.assert_array_equal(np.asarray(raw[i]),
                                          np.asarray(dec[i]))


@pytest.mark.slow
def test_presample_columns_any_batch_matches_sample_columns():
    """presample_columns with batch_size NOT a multiple of num_envs
    (round-4 generalization: one modular take_along_axis replaces the
    per-update random-offset trim) is bitwise jax.vmap(sample_columns)
    over the same keys — the pixel preset shape (batch 256 < 512 envs)
    now takes the one-gather path instead of the vmapped fallback."""
    from cartpoleplusplus_tpu.agents.replay import ReplayBuffer

    rng = np.random.default_rng(11)
    buf = ReplayBuffer(num_envs=8, capacity_per_env=32, obs_dim=5,
                       action_dim=2, discrete=False)
    rs = buf.init()
    for _ in range(40):
        rs = buf.add(rs,
                     jnp.asarray(rng.random((8, 5)), jnp.float32),
                     jnp.asarray(rng.random((8, 2)), jnp.float32),
                     jnp.asarray(rng.random(8), jnp.float32),
                     jnp.asarray(rng.random(8) < 0.1))
    keys = jax.random.split(jax.random.PRNGKey(9), 5)
    for bs in (3, 8, 12, 20, 24):
        got = buf.presample_columns(rs, keys, bs)
        want = jax.vmap(lambda k: buf.sample_columns(rs, k, bs))(keys)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


@pytest.mark.slow
def test_pixel_train_step_has_no_ring_copies():
    """The compiled pixel train step must not materialize full-ring
    copies (round-4: the cursor-alignment lax.cond in add_trajectory
    made XLA copy the multi-GB uint8 ring twice per train step — fixed
    by the agents asserting alignment statically via aligned=True).
    Pins the HLO: any reappearing ring-shaped copy op is a throughput
    regression of ~4.5 ms/step at production pixel scale."""
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.env import RenderConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    rcfg = RenderConfig(width=24, height=24, grayscale=True,
                        obs_uint8=True)
    env = CartPole3D(continuous_params(), num_envs=16, obs_mode="pixels",
                     render_config=rcfg)
    for warmup in (0, 64):   # static bypass AND the gated-cond path
        agent = DDPG(env, DDPGConfig(hidden=(32, 32), rollout_steps=8,
                                     updates_per_step=4, batch_size=16,
                                     replay_capacity_per_env=64,
                                     warmup_env_steps=warmup))
        st = agent.init(0)
        txt = jax.jit(agent.train_step,
                      donate_argnums=(0,)).lower(st).compile().as_text()
        import numpy as _np
        ring = f"u8[16,64,{int(_np.prod(agent.env.obs_shape))}]"
        assert ring in txt, f"ring shape {ring} not found — update test"
        copies = [ln for ln in txt.splitlines()
                  if "copy(" in ln and ring in ln]
        conds = [ln for ln in txt.splitlines()
                 if "conditional(" in ln and ring in ln]
        # The add_trajectory cursor-alignment cond used to route the
        # ring through BOTH branches (4 copies incl. layout changes);
        # CPU's conservative copy-insertion still emits <=2 same-layout
        # defensive copies for the donated param, so pin: no ring-shaped
        # conditional, and no more than 2 plain copies.
        assert not conds, f"warmup={warmup}: ring routed through cond"
        assert len(copies) <= 2, (
            f"warmup={warmup}: {len(copies)} full-ring copy op(s) in the "
            f"compiled train step: {copies[:3]}")


@pytest.mark.slow
def test_presample_columns_pixel_slices_match_sample_columns():
    """Quantized rings fetch columns via unrolled dynamic slices instead
    of jnp.take (a take can lower to a sweep of the whole ring); the
    slice path must stay bitwise
    jax.vmap(sample_columns) at both multiple and non-multiple batch
    sizes."""
    from cartpoleplusplus_tpu.agents.replay import ReplayBuffer

    rng = np.random.default_rng(21)
    buf = ReplayBuffer(num_envs=8, capacity_per_env=32,
                       obs_shape=(4, 4, 2), action_dim=2, discrete=False,
                       quantize_obs=True)
    rs = buf.init()
    for _ in range(48):
        rs = buf.add(rs,
                     jnp.asarray(rng.random((8, 4, 4, 2)), jnp.float32),
                     jnp.asarray(rng.random((8, 2)), jnp.float32),
                     jnp.asarray(rng.random(8), jnp.float32),
                     jnp.asarray(rng.random(8) < 0.1))
    keys = jax.random.split(jax.random.PRNGKey(2), 6)
    for bs in (8, 6, 20):
        got = buf.presample_columns(rs, keys, bs)
        want = jax.vmap(lambda k: buf.sample_columns(rs, k, bs))(keys)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_block_sampling_semantics_and_presample_bitwise():
    """Block sampling (round 5 — the pixel-preset fetch-traffic fix):
    (a) every sampled row is a REAL transition — (obs, next_obs) are
    chronologically adjacent inserts of the same env and the env block
    is aligned; (b) presample_block is bitwise vmap(sample_block);
    (c) batch sizes that do not divide num_envs are rejected."""
    import pytest as _pytest

    rb = ReplayBuffer(num_envs=16, capacity_per_env=8, obs_dim=2,
                      action_dim=2, discrete=False)
    rs = rb.init()
    add = jax.jit(rb.add)
    # obs encodes (env, insert index) so adjacency is checkable.
    for t in range(13):   # wraps the 8-slot ring
        obs = jnp.stack([jnp.arange(16, dtype=jnp.float32),
                         jnp.full((16,), t, jnp.float32)], -1)
        rs = add(rs, obs, jnp.zeros((16, 2)),
                 jnp.full((16,), t, jnp.float32),
                 jnp.zeros((16,), bool))
    for key in [jax.random.PRNGKey(i) for i in range(5)]:
        obs, action, reward, next_obs, done = jax.jit(
            lambda r, k: rb.sample_block(r, k, 4))(rs, key)
        envs = np.asarray(obs[:, 0])
        # Aligned contiguous env block.
        assert envs[0] % 4 == 0
        np.testing.assert_array_equal(envs, envs[0] + np.arange(4))
        # next_obs is the chronologically NEXT insert of the same env.
        np.testing.assert_array_equal(np.asarray(next_obs[:, 0]), envs)
        np.testing.assert_array_equal(np.asarray(next_obs[:, 1]),
                                      np.asarray(obs[:, 1]) + 1)
        np.testing.assert_array_equal(np.asarray(reward),
                                      np.asarray(obs[:, 1]))
    keys = jax.random.split(jax.random.PRNGKey(3), 6)
    fast = jax.jit(lambda r, k: rb.presample_block(r, k, 8))(rs, keys)
    slow = jax.jit(jax.vmap(lambda r, k: rb.sample_block(r, k, 8),
                            in_axes=(None, 0)))(rs, keys)
    for f, s in zip(fast, slow):
        np.testing.assert_array_equal(np.asarray(f), np.asarray(s))
    with _pytest.raises(ValueError):
        rb.sample_block(rs, jax.random.PRNGKey(0), 5)
    with _pytest.raises(ValueError):
        rb.presample_block(rs, keys, 32)  # batch > num_envs


@pytest.mark.slow
def test_frozen_target_update_scan_matches_update_once():
    """The per_step-polyak XLA learner hoists the TD-target pass out of
    the update scan: y for all K minibatches in ONE batched
    target-net pass. Under per_step semantics the targets are frozen
    across the scan, so this must match scanning _update_once (which
    recomputes y per update from the same frozen targets) to f32
    batched-matmul tolerance."""
    import types

    from cartpoleplusplus_tpu.agents.common import (gated_update_scan,
                                                    replay_presample)
    from cartpoleplusplus_tpu.physics.params import continuous_params

    env = CartPole3D(continuous_params(), num_envs=32)
    cfg = DDPGConfig(hidden=(32, 32), rollout_steps=4, updates_per_step=3,
                     batch_size=32, replay_capacity_per_env=16,
                     warmup_env_steps=0, polyak_cadence="per_step")
    a_new = DDPG(env, cfg)
    a_ref = DDPG(env, cfg)

    def old_path(self, st, ready, presample):
        return gated_update_scan(
            st, self._update_once, self.cfg.updates_per_step, ready,
            {"critic_loss": jnp.float32(0.0),
             "actor_loss": jnp.float32(0.0)}, presample=presample)

    a_ref._frozen_target_update_scan = types.MethodType(old_path, a_ref)
    st_n = a_new.init(0)
    st_r = a_ref.init(0)
    for _ in range(3):
        st_n, m_n = jax.jit(a_new.train_step)(st_n)
        st_r, m_r = jax.jit(a_ref.train_step)(st_r)
    for field in ("actor", "critic", "actor_target", "critic_target"):
        for x, y in zip(jax.tree.leaves(getattr(st_n, field)),
                        jax.tree.leaves(getattr(st_r, field))):
            np.testing.assert_allclose(np.asarray(x), np.asarray(y),
                                       atol=2e-5, rtol=2e-5)
    np.testing.assert_allclose(float(m_n["critic_loss"]),
                               float(m_r["critic_loss"]), rtol=1e-4)
