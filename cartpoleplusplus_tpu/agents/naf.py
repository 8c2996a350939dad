"""NAF (Normalized Advantage Function) continuous-control agent.

Reference counterpart: `naf_cartpole.py` — continuous Q-learning with a
quadratic advantage head A(s,a) = -1/2 (a-mu)^T P(s) (a-mu), target network
and replay (SURVEY.md §2a; reference mount empty this session).

Redesign: same fused actor-learner shape as ddpg.py; the
quadratic-advantage algebra lives in models/nets.py::NafNet. Exploration is
Gaussian noise on mu (the reference used OU/Gaussian variants).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..env import CartPole3D
from ..models import NafNet, polyak
from ..utils.prng import normal
from .common import (TAG_NAF_X, TAG_NAF_Y, as_key, gated_update_scan,
                     local_batch, make_train_scan, replay_presample,
                     run_rollout)
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class NAFConfig:
    # Defaults are the tuned recipe: with linear lr decay over 40k
    # per-env steps the quadratic-advantage learner no longer walks off
    # the solved policy late in training (with a constant lr, long runs
    # collapsed after an initially healthy phase). Its recipes sit near
    # a basin boundary where the choice of matmul arithmetic can reroute
    # a run (docs/design.md §16).
    hidden: tuple = (256, 256)
    lr: float = 5e-4
    gamma: float = 0.99
    tau: float = 0.01
    batch_size: int = 256
    rollout_steps: int = 8
    updates_per_step: int = 8
    replay_capacity_per_env: int = 1024
    noise_sigma: float = 0.2
    noise_sigma_min: float = 0.02    # floor after decay
    noise_sigma_decay_env_steps: int = 30000  # linear horizon (0 = constant)
    # NAF's advantage head is an unconstrained Cholesky factor L: its
    # entries (and so the Q curvature) can grow without bound, which
    # shows up as late-training divergence (done_frac spiking after an
    # initially healthy run). Global-norm gradient clipping bounds the
    # update magnitude through that head. 0 disables.
    max_grad_norm: float = 10.0
    warmup_env_steps: int = 16
    dtype: str = "float32"
    sample: str = "column"           # replay sampling: column (fast) | uniform
    # Linear lr decay to lr * lr_end_frac over a PER-ENV step horizon
    # (0 = constant) — same late-training-drift rationale as
    # DDPGConfig.lr_decay_env_steps; gradient-step keyed.
    lr_decay_env_steps: int = 40000
    lr_end_frac: float = 0.1
    # Pixel-obs encoder ("conv" | "patch"), ignored for state obs — the
    # reference attempted conv-NAF (SURVEY.md §2a NAF row); frames are
    # replayed quantized to uint8 like pixel-DDPG.
    encoder: str = "conv"
    # Conv-encoder channel widths (pixel obs only; see DDPGConfig).
    conv_features: tuple = (16, 32, 32)


class NAFState(NamedTuple):
    params: dict
    target: dict
    opt: tuple
    replay: ReplayState
    env_state: tuple
    obs: jax.Array
    rng: jax.Array
    env_steps: jax.Array


class NAF:
    def __init__(self, env: CartPole3D, config: NAFConfig = NAFConfig(),
                 dist_axis: str | None = None, num_shards: int = 1):
        """dist_axis / num_shards: set when train_step runs inside
        shard_map (dist/shardmap.py) with a PER-SHARD env — gradients and
        metrics pmean over the axis; per-shard PRNG decorrelates via
        axis_index; each shard samples batch_size/num_shards locally."""
        if env.params.discrete_actions:
            raise ValueError("NAF needs the continuous env")
        self.env = env
        self.cfg = config
        self.dist_axis = dist_axis
        self.num_shards = num_shards
        dtype = jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32
        pixels = env.obs_mode == "pixels"
        if pixels:
            from ..models import VisualNafNet
            self.net = VisualNafNet(action_dim=env.action_dim,
                                    hidden=config.hidden, dtype=dtype,
                                    encoder=config.encoder,
                                    features=tuple(config.conv_features))
        else:
            self.net = NafNet(action_dim=env.action_dim,
                              hidden=config.hidden, dtype=dtype)
        self.replay = ReplayBuffer(
            num_envs=env.num_envs,
            capacity_per_env=config.replay_capacity_per_env,
            obs_shape=env.obs_shape, quantize_obs=pixels,
            action_dim=env.action_dim, discrete=False)
        if config.sample == "block":
            lb = local_batch(config.batch_size, max(self.num_shards, 1))
            if lb > env.num_envs or env.num_envs % lb:
                raise ValueError(
                    f"sample='block' needs the per-shard batch ({lb}) to "
                    f"divide num_envs ({env.num_envs}) — lower "
                    f"--<agent>.batch-size or use sample='column'")
        lr = config.lr
        if config.lr_decay_env_steps > 0:
            lr = optax.linear_schedule(
                lr, lr * config.lr_end_frac,
                max(config.lr_decay_env_steps * config.updates_per_step
                    // max(config.rollout_steps, 1), 1))
        self.tx = (optax.chain(optax.clip_by_global_norm(
                       config.max_grad_norm), optax.adam(lr))
                   if config.max_grad_norm > 0.0
                   else optax.adam(lr))

    def init(self, key) -> NAFState:
        k_net, k_env, k_run = jax.random.split(as_key(key), 3)
        obs0 = jnp.zeros((1,) + self.env.obs_shape, jnp.float32)
        act0 = jnp.zeros((1, self.env.action_dim), jnp.float32)
        params = self.net.init(k_net, obs0, act0)
        env_state, obs = self.env.reset(k_env)
        st = NAFState(
            params=params, target=jax.tree.map(jnp.copy, params),
            opt=self.tx.init(params), replay=self.replay.init(),
            env_state=env_state, obs=obs, rng=k_run,
            env_steps=jnp.int32(0))
        return st

    def act(self, params, obs, env_seed=None, t=None, sigma=None):
        """mu(s), plus counter-PRNG Gaussian exploration when
        (env_seed, t) are given — sharding-independent."""
        _, mu = self.net.apply(params, obs)
        if env_seed is None:
            return mu
        s = self.cfg.noise_sigma if sigma is None else sigma
        eps = jnp.stack([normal(env_seed, t, TAG_NAF_X),
                         normal(env_seed, t, TAG_NAF_Y)],
                        axis=-1) * s
        return jnp.clip(mu + eps, -1.0, 1.0)

    def _sigma(self, env_steps):
        """Linearly decayed exploration scale (same schedule shape as
        DDPG._sigma) — evaluated once per train_step from env_steps, so
        it is a pure function of global progress, not sharding layout."""
        c = self.cfg
        if c.noise_sigma_decay_env_steps <= 0:
            return jnp.float32(c.noise_sigma)
        frac = jnp.clip(env_steps.astype(jnp.float32)
                        / c.noise_sigma_decay_env_steps, 0.0, 1.0)
        return c.noise_sigma + frac * (c.noise_sigma_min - c.noise_sigma)

    def greedy_policy(self, st: NAFState):
        """mu policy fn(obs) -> action (no exploration)."""
        return lambda o: self.act(st.params, o)

    def evaluate(self, st: NAFState, num_steps: int = 200, seed: int = 0):
        """mu-policy evaluation (no exploration): episode stats."""
        from .common import evaluate_policy

        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps)

    def _loss(self, params, target, batch):
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        v_next, _ = self.net.apply(target, next_obs)
        y = reward + c.gamma * (1.0 - done.astype(jnp.float32)) * v_next
        q, _, _ = self.net.apply(params, obs, action)
        return jnp.mean(jnp.square(q - jax.lax.stop_gradient(y)))

    def train_step(self, st: NAFState, capture: bool = False
                   ) -> tuple[NAFState, dict]:
        """Gaussian-exploration rollout + replay insert + K quadratic-
        advantage TD updates, as one jit-able program."""
        c = self.cfg
        rng = st.rng
        env_seed = st.env_state.env_seed
        sigma = self._sigma(st.env_steps)

        env_state, obs, traj = run_rollout(
            self.env,
            lambda o, t: self.act(st.params, o, env_seed, t, sigma),
            st.env_state, st.obs,
            st.env_steps + jnp.arange(c.rollout_steps, dtype=jnp.int32))
        # Pixel (quantized) rings insert AFTER the update phase so the
        # DUS is the ring's last use and XLA updates the multi-GB uint8
        # buffer in place (see agents/ddpg.py for the rationale); state
        # rings keep insert-first (bitwise-unchanged batch streams for
        # the promoted recipes).
        late_insert = self.replay.quantize_obs
        if not late_insert:
            st = st._replace(replay=self.replay.add_trajectory(
                st.replay, *traj, aligned=True))
        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(env_state=env_state, obs=obs,
                         rng=rng, env_steps=env_steps)

        def upd_body(s, batch):
            loss, grad = jax.value_and_grad(self._loss)(
                s.params, s.target, batch)
            if self.dist_axis is not None:
                loss, grad = jax.lax.pmean((loss, grad), self.dist_axis)
            upd, opt = self.tx.update(grad, s.opt, s.params)
            params = optax.apply_updates(s.params, upd)
            s = s._replace(params=params, opt=opt,
                           target=polyak(s.target, params, c.tau))
            return s, loss

        ready = (True if c.warmup_env_steps <= 0
                 else env_steps >= c.warmup_env_steps)
        st, loss = gated_update_scan(
            st, upd_body, c.updates_per_step, ready, jnp.float32(0.0),
            presample=replay_presample(self.replay, c.sample,
                                       c.batch_size, self.num_shards,
                                       self.dist_axis))
        if late_insert:
            st = st._replace(replay=self.replay.add_trajectory(
                st.replay, *traj, aligned=True))

        metrics_extra = {"traj": traj} if capture else {}
        reward_mean = jnp.mean(traj[2])
        done_frac = jnp.mean(traj[3].astype(jnp.float32))
        if self.dist_axis is not None:
            reward_mean, done_frac = jax.lax.pmean(
                (reward_mean, done_frac), self.dist_axis)
        return st, {
            **metrics_extra,
            "loss": loss,
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
