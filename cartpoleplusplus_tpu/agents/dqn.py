"""DQN on the discrete 5-action env.

Reference counterpart: `dqn_cartpole.py` — a keras-rl `DQNAgent` fit on the
discrete env (SURVEY.md §2a/§3.4; BASELINE discrete configs
BASELINE.json:7-8).

Redesign: same fused actor-learner shape as ddpg.py — one jitted
`train_step` = epsilon-greedy rollout scan + replay insert + K TD(0)
updates with a Polyak (soft) target network. keras-rl's Python callback
loop is replaced by `lax.scan`.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..env import CartPole3D
from ..models import QNetMLP, VisualQNet, polyak
from ..utils.prng import hash_words, uniform
from .common import (TAG_EPS_ACT, TAG_EPS_GATE, as_key, gated_update_scan,
                     local_batch, make_train_scan, replay_presample,
                     replay_sampler, run_rollout)
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class DQNConfig:
    # Defaults are the tuned recipe: 40k per-env steps at 1024 envs
    # reaches eval mean episode length ~200/200 — the greedy policy
    # balances to the cap. The lever was the learning rate: larger
    # rates plateaued far below the cap (the TD target through the
    # soft target net tolerates little optimizer noise).
    hidden: tuple = (256, 256)
    lr: float = 5e-5
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    rollout_steps: int = 8
    updates_per_step: int = 8
    replay_capacity_per_env: int = 1024
    eps_start: float = 1.0
    eps_end: float = 0.02
    eps_decay_env_steps: int = 10000  # linear decay horizon (per-env steps)
    warmup_env_steps: int = 16
    double_dqn: bool = True
    dtype: str = "float32"
    sample: str = "column"           # replay sampling: column (fast) | uniform
    # Pixel-obs encoder: "conv" | "patch" (see DDPGConfig.encoder).
    encoder: str = "conv"
    # Conv-encoder channel widths (pixel obs only; see DDPGConfig).
    conv_features: tuple = (16, 32, 32)


class DQNState(NamedTuple):
    q: dict
    q_target: dict
    opt: tuple
    replay: ReplayState
    env_state: tuple
    obs: jax.Array
    rng: jax.Array
    env_steps: jax.Array


class DQN:
    def __init__(self, env: CartPole3D, config: DQNConfig = DQNConfig(),
                 dist_axis: str | None = None, num_shards: int = 1):
        """dist_axis / num_shards: set when train_step runs inside
        shard_map (dist/shardmap.py) with a PER-SHARD env — gradients and
        metrics pmean over the axis; per-shard PRNG decorrelates via
        axis_index; each shard samples batch_size/num_shards locally."""
        if not env.params.discrete_actions:
            raise ValueError("DQN needs the discrete env")
        self.env = env
        self.cfg = config
        self.dist_axis = dist_axis
        self.num_shards = num_shards
        dtype = jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32
        pixels = env.obs_mode == "pixels"
        if pixels:
            self.q_net = VisualQNet(num_actions=env.num_actions,
                                    hidden=config.hidden, dtype=dtype,
                                    encoder=config.encoder,
                                    features=tuple(config.conv_features))
        else:
            self.q_net = QNetMLP(num_actions=env.num_actions,
                                 hidden=config.hidden, dtype=dtype)
        self.replay = ReplayBuffer(
            num_envs=env.num_envs,
            capacity_per_env=config.replay_capacity_per_env,
            obs_shape=env.obs_shape, quantize_obs=pixels, discrete=True)
        if config.sample == "block":
            lb = local_batch(config.batch_size, max(self.num_shards, 1))
            if lb > env.num_envs or env.num_envs % lb:
                raise ValueError(
                    f"sample='block' needs the per-shard batch ({lb}) to "
                    f"divide num_envs ({env.num_envs}) — lower "
                    f"--<agent>.batch-size or use sample='column'")
        self.tx = optax.adam(config.lr)

    def init(self, key) -> DQNState:
        k_q, k_env, k_run = jax.random.split(as_key(key), 3)
        obs0 = jnp.zeros((1,) + self.env.obs_shape, jnp.float32)
        q = self.q_net.init(k_q, obs0)
        env_state, obs = self.env.reset(k_env)
        st = DQNState(
            q=q, q_target=jax.tree.map(jnp.copy, q), opt=self.tx.init(q),
            replay=self.replay.init(), env_state=env_state, obs=obs,
            rng=k_run, env_steps=jnp.int32(0))
        return st

    def epsilon(self, env_steps):
        c = self.cfg
        if c.eps_decay_env_steps <= 0:  # no decay horizon: constant floor
            return jnp.float32(c.eps_end)
        frac = jnp.clip(env_steps.astype(jnp.float32)
                        / c.eps_decay_env_steps, 0.0, 1.0)
        return c.eps_start + frac * (c.eps_end - c.eps_start)

    def act(self, q_params, obs, env_seed, t, eps):
        """Epsilon-greedy batched action; exploration is a counter-PRNG
        function of (per-env seed, global step) — sharding-independent."""
        qv = self.q_net.apply(q_params, obs)
        greedy = jnp.argmax(qv, axis=-1).astype(jnp.int32)
        rand = (hash_words(env_seed, t, TAG_EPS_ACT)
                % jnp.uint32(self.env.num_actions)).astype(jnp.int32)
        explore = uniform(0.0, 1.0, env_seed, t, TAG_EPS_GATE) < eps
        return jnp.where(explore, rand, greedy)

    def greedy_policy(self, st: DQNState):
        """Greedy policy fn(obs) -> action (epsilon = 0)."""
        return lambda o: jnp.argmax(self.q_net.apply(st.q, o),
                                    -1).astype(jnp.int32)

    def evaluate(self, st: DQNState, num_steps: int = 200, seed: int = 0):
        """Greedy-policy evaluation (epsilon = 0): episode stats."""
        from .common import evaluate_policy

        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps)

    def _loss(self, q, q_target, batch):
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        qn_t = self.q_net.apply(q_target, next_obs)
        if c.double_dqn:
            a_star = jnp.argmax(self.q_net.apply(q, next_obs), axis=-1)
            q_next = jnp.take_along_axis(qn_t, a_star[:, None], 1)[:, 0]
        else:
            q_next = jnp.max(qn_t, axis=-1)
        y = reward + c.gamma * (1.0 - done.astype(jnp.float32)) * q_next
        qv = self.q_net.apply(q, obs)
        q_sa = jnp.take_along_axis(qv, action[:, None], 1)[:, 0]
        return jnp.mean(optax.huber_loss(q_sa, jax.lax.stop_gradient(y)))

    def train_step(self, st: DQNState, capture: bool = False
                   ) -> tuple[DQNState, dict]:
        """Epsilon-greedy rollout + replay insert + K TD(0) updates, as
        one jit-able program."""
        c = self.cfg
        rng = st.rng
        eps = self.epsilon(st.env_steps)
        env_seed = st.env_state.env_seed

        env_state, obs, traj = run_rollout(
            self.env,
            lambda o, t: self.act(st.q, o, env_seed, t, eps),
            st.env_state, st.obs,
            st.env_steps + jnp.arange(c.rollout_steps, dtype=jnp.int32))
        # Pixel (quantized) rings insert AFTER the update phase so the
        # DUS is the ring's last use and XLA updates the multi-GB uint8
        # buffer in place (see agents/ddpg.py for the rationale).
        # State-obs rings keep insert-first:
        # their batch streams stay bitwise unchanged.
        late_insert = self.replay.quantize_obs

        def insert(s):
            return s._replace(replay=self.replay.add_trajectory(
                s.replay, *traj, aligned=True))

        if not late_insert:
            st = insert(st)
        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(env_state=env_state, obs=obs,
                         rng=rng, env_steps=env_steps)
        sampler = replay_sampler(self.replay, c.sample, c.batch_size,
                                 self.num_shards, self.dist_axis)

        def upd_body(s, batch):
            if not isinstance(batch, tuple):   # presample off: batch is
                batch = sampler(s.replay, batch)  # a PRNG key (pixels)
            loss, grad = jax.value_and_grad(self._loss)(
                s.q, s.q_target, batch)
            if self.dist_axis is not None:
                loss, grad = jax.lax.pmean((loss, grad), self.dist_axis)
            upd, opt = self.tx.update(grad, s.opt, s.q)
            q = optax.apply_updates(s.q, upd)
            s = s._replace(q=q, opt=opt,
                           q_target=polyak(s.q_target, q, c.tau))
            return s, loss

        ready = (True if c.warmup_env_steps <= 0
                 else env_steps >= c.warmup_env_steps)
        st, loss = gated_update_scan(
            st, upd_body, c.updates_per_step, ready, jnp.float32(0.0),
            presample=replay_presample(self.replay, c.sample,
                                       c.batch_size, self.num_shards,
                                       self.dist_axis))
        if late_insert:
            st = insert(st)

        metrics_extra = {"traj": traj} if capture else {}
        reward_mean = jnp.mean(traj[2])
        done_frac = jnp.mean(traj[3].astype(jnp.float32))
        if self.dist_axis is not None:
            reward_mean, done_frac = jax.lax.pmean(
                (reward_mean, done_frac), self.dist_axis)
        return st, {
            **metrics_extra,
            "loss": loss,
            "epsilon": eps,
            "reward_mean": reward_mean,
            "done_frac": done_frac,
            "env_steps": env_steps,
        }

    def make_train_step(self, capture: bool = False):
        """Jitted train_step with donated state. capture=True additionally
        returns the rollout chunk in metrics["traj"] (time-major
        (obs, action, reward, done)) for the event-log sink."""
        return jax.jit(functools.partial(self.train_step, capture=capture),
                       donate_argnums=(0,))

    def make_train_scan(self, num_calls: int, capture: bool = False):
        """`num_calls` train steps as ONE jitted dispatch (stacked
        metrics) — amortizes the per-call dispatch constant; see
        agents/common.py::make_train_scan."""
        return make_train_scan(self, num_calls, capture=capture)
