"""Shared actor-learner building blocks (DDPG / DQN / NAF / LRPG).

The fused train_step of every replay agent has the same skeleton —
rollout scan, replay insert, warmup-gated K-update scan — factored here so
the per-agent files contain only their algorithm (losses, action
selection, target updates).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

# Counter-PRNG stream tags for agent exploration noise (utils/prng.py;
# env-side tags live in env/compute.py). Exploration is a pure function of
# (per-env seed, global step) so trajectories are sharding-independent.
TAG_OU_X = 0x41
TAG_OU_Y = 0x42
TAG_EPS_GATE = 0x43
TAG_EPS_ACT = 0x44
TAG_NAF_X = 0x45
TAG_NAF_Y = 0x46
TAG_PG_GUMBEL = 0x47  # LRPG categorical sampling (action index salts it)


def make_train_scan(agent, num_calls: int, capture: bool = False):
    """`num_calls` train steps as ONE jitted dispatch.

    Each jitted call carries a fixed per-dispatch cost (Python arg
    processing + runtime enqueue), which at fast cadences is the same
    order as the work itself. Scanning K train steps inside one jit
    amortizes that constant K-fold without changing any semantics:
    train_step is a pure (state) -> (state, metrics) function, so
    `lax.scan` over it computes bitwise the same states as K sequential
    calls
    (tests/test_agents.py::test_train_scan_matches_loop).

    Metrics come back stacked time-major: metrics[k] is train step k's
    dict (so callers keep their per-step logging cadence by iterating
    rows). With capture=True the stacked metrics carry
    metrics["traj"][k] = rollout chunk k; concatenating on the time axis
    reproduces the unchunked trajectory for the event-log sink.
    """
    step = functools.partial(agent.train_step, capture=capture)

    def scanned(st):
        def body(c, _):
            c, m = step(c)
            return c, m

        return jax.lax.scan(body, st, None, length=num_calls)

    return jax.jit(scanned, donate_argnums=(0,))


def local_batch(global_batch: int, num_shards: int) -> int:
    """Per-shard learner minibatch under shard_map (config batch sizes
    are GLOBAL)."""
    return max(global_batch // num_shards, 1)


def as_key(key):
    """Accept an int seed or a PRNG key."""
    return jax.random.PRNGKey(key) if isinstance(key, int) else key


def run_rollout(env, act_fn, env_state, obs, keys):
    """Scan `len(keys)` env-steps with `act_fn(obs, key) -> action`.

    Returns (env_state, obs, traj) with traj = time-major
    (obs, action, reward, done). The reference's per-step Python agent
    loop, as one scan.
    """

    def body(carry, key):
        st, o = carry
        action = act_fn(o, key)
        st, o_next, reward, done, _ = env.step(st, action)
        return (st, o_next), (o, action, reward, done)

    (env_state, obs), traj = jax.lax.scan(body, (env_state, obs), keys)
    return env_state, obs, traj


def gated_update_scan(st, upd_body, num_updates: int, ready,
                     zero_metrics, presample=None):
    """Warmup-gated learner phase: split st.rng, scan `upd_body(state,
    x)` over `num_updates` inputs and average its metrics — or skip
    entirely (returning `zero_metrics`) until `ready` (replay warmup).
    st must carry a `rng` field.

    Without `presample`, x is a PRNG key and the body samples its own
    minibatch. With `presample(s, keys) -> stacked batches`, all
    `num_updates` minibatches are gathered as ONE vectorized op before
    the scan and x is a batch: the K sequential update iterations are a
    serial chain of small dependent ops, and hoisting the replay
    sampling off that critical path is free parallelism — the batches
    are bitwise what the in-scan sampling would have drawn (jax.random
    is vmap-invariant, and the replay contents don't change during the
    update phase)."""

    if num_updates <= 0:   # rollout-only cadence (decomposition probes)
        return st, zero_metrics

    def do(s):
        rng, k = jax.random.split(s.rng)
        s = s._replace(rng=rng)
        keys = jax.random.split(k, num_updates)
        xs = keys if presample is None else presample(s, keys)
        s, metrics = jax.lax.scan(upd_body, s, xs)
        return s, jax.tree.map(jnp.mean, metrics)

    # Static True (warmup disabled) skips the cond entirely — no
    # identity branch for XLA to satisfy with copies of the carried
    # state (replay buffers are the big operand).
    if ready is True:
        return do(st)
    return jax.lax.cond(ready, do, lambda s: (s, zero_metrics), st)


def replay_sampler(replay, sample_mode: str, batch_size: int,
                   num_shards: int, dist_axis, decode: bool = True):
    """Per-key minibatch draw fn(replay_state, key) -> batch, with the
    per-shard decorrelation fold applied under shard_map."""
    sample_fn = {"column": replay.sample_columns,
                 "block": replay.sample_block}.get(sample_mode,
                                                   replay.sample)
    bs = local_batch(batch_size, num_shards)

    def one(rs, key):
        if dist_axis is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(dist_axis))
        return sample_fn(rs, key, bs, decode=decode)

    return one


def replay_presample(replay, sample_mode: str, batch_size: int,
                     num_shards: int, dist_axis):
    """Build the `presample` hook for gated_update_scan over a
    ReplayBuffer: vmap the per-key minibatch draw over the K update
    keys (same per-shard decorrelation fold as the in-body sampling).

    Quantized (pixel) buffers presample in STORAGE dtype (decode=False):
    the K x batch frame stack stays uint8 (4x smaller than decoded f32)
    and the pixel encoders consume uint8 directly, applying the same
    1/255 scaling _decode_obs would (models/nets.py) — numerically
    identical in f32 nets. Without presampling, pixels would run K
    sequential in-scan gathers against the multi-GB ring on the serial
    critical path of the update phase.

    Without a shard fold the K draws collapse into ONE gather per ring
    buffer instead of K vmapped slice/gather chains, bitwise the same
    batches: ReplayBuffer.presample_columns for whole-column batches
    (batch % num_envs == 0), presample_uniform for the uniform mode."""
    decode = not replay.quantize_obs
    bs = local_batch(batch_size, num_shards)
    if dist_axis is None:
        if sample_mode == "column":
            return lambda s, keys: replay.presample_columns(
                s.replay, keys, bs, decode=decode)
        if sample_mode == "block":
            return lambda s, keys: replay.presample_block(
                s.replay, keys, bs, decode=decode)
        if sample_mode == "uniform":
            return lambda s, keys: replay.presample_uniform(
                s.replay, keys, bs, decode=decode)
    one = replay_sampler(replay, sample_mode, batch_size, num_shards,
                         dist_axis, decode=decode)
    return lambda s, keys: jax.vmap(one, in_axes=(None, 0))(s.replay, keys)


def episode_length_hist(done, cap: int):
    """Histogram of COMPLETED-episode lengths from a time-major (T, B)
    done matrix: hist[L] = number of episodes that finished after exactly
    L env-steps. A per-env step counter is carried over the scan and its
    value lands in the histogram the step its env reports done; the
    trailing censored window of every env contributes nothing. Episodes
    are aligned with t=0 (env.reset starts everyone fresh)."""
    b = done.shape[1]

    def body(carry, done_t):
        c, hist = carry
        c = c + 1
        hist = hist.at[jnp.minimum(c, cap)].add(done_t.astype(jnp.int32))
        c = jnp.where(done_t, 0, c)
        return (c, hist), None

    (_, hist), _ = jax.lax.scan(
        body,
        (jnp.zeros((b,), jnp.int32), jnp.zeros((cap + 1,), jnp.int32)),
        done)
    return hist


def episode_stats_from_hist(hist):
    """Episode statistics from a length histogram (hist[L] = number of
    COMPLETED episodes of exactly L env-steps). All-device; returns
    mean/median/max over completed episodes plus the count. Empty
    histogram (no completed episode) yields zeros, not NaNs."""
    n = jnp.sum(hist)
    lengths = jnp.arange(hist.shape[0], dtype=jnp.float32)
    total = jnp.sum(hist.astype(jnp.float32) * lengths)
    mean = total / jnp.maximum(n.astype(jnp.float32), 1.0)
    max_len = jnp.max(jnp.where(hist > 0, jnp.arange(hist.shape[0]), 0))
    # Median = first length at which the cumulative count crosses half
    # of the total (argmax returns the FIRST True).
    cum = jnp.cumsum(hist)
    median = jnp.argmax(2 * cum >= n).astype(jnp.int32)
    return {
        "episodes": n,
        "mean_episode_length": mean,
        "median_episode_length": median,
        "max_episode_length": max_len,
    }


def evaluate_policy(env, policy_fn, key, num_steps: int,
                    needs_key: bool = False, index_offset=0,
                    axis_name: str | None = None):
    """Policy evaluation over the batched env: `num_steps` steps with
    masked auto-reset, reduced to EXACT per-episode statistics on device.

    policy_fn(obs) -> action (deterministic), or policy_fn(obs, key) when
    `needs_key` (stochastic baselines). Per-env step counters are carried
    through the scan and each counter value lands in a length histogram
    the step its env finishes — so mean/median/max are over *completed*
    episodes only; the trailing censored window of every env is discarded
    (the reference's per-episode Python loop got this for free; the
    earlier steps/episodes ratio here over-counted truncated tails).
    Nothing but scalars and the (max_episode_steps+1,) histogram is
    materialized — no O(T*B) trajectory stacking.

    Sharded evaluation (dist/shardmap.py::make_shardmap_evaluate): when
    `axis_name` is set the caller runs this inside shard_map over the
    PER-SHARD env; `index_offset` gives each shard's envs their GLOBAL
    identities (same episodes as the unsharded run), and the completed-
    episode histogram / reward / done totals are psum'd so every shard
    returns the GLOBAL statistics. Integer stats match the unsharded
    eval exactly (the histogram sum is exact); reward_mean differs only
    by fp summation order.
    """
    k_env, k_pol = jax.random.split(as_key(key))
    state, obs0 = env.reset(k_env, index_offset=index_offset)
    b = env.num_envs

    def body(carry, _):
        st, obs, k = carry
        k, ka = jax.random.split(k)
        action = policy_fn(obs, ka) if needs_key else policy_fn(obs)
        st, obs, reward, done, _ = env.step(st, action)
        return (st, obs, k), (jnp.sum(reward), done)

    _, (rew_sums, done) = jax.lax.scan(
        body, (state, obs0, k_pol), None, length=num_steps)
    hist = episode_length_hist(done, env.params.max_episode_steps)
    rew_total = jnp.sum(rew_sums)
    done_total = jnp.sum(done.astype(jnp.float32))
    n_envs = jnp.float32(b)
    if axis_name is not None:
        hist = jax.lax.psum(hist, axis_name)
        rew_total = jax.lax.psum(rew_total, axis_name)
        done_total = jax.lax.psum(done_total, axis_name)
        n_envs = jax.lax.psum(n_envs, axis_name)
    stats = episode_stats_from_hist(hist)
    stats["reward_mean"] = rew_total / (jnp.float32(num_steps) * n_envs)
    stats["done_frac"] = done_total / (jnp.float32(num_steps) * n_envs)
    return stats
