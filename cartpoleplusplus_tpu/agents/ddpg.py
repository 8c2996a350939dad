"""DDPG actor-learner — the framework's flagship agent.

Reference counterpart: `ddpg_cartpole.py` in rebcabin/cartpoleplusplus
(`ActorNetwork`, `CriticNetwork`, per-step TF session calls, host replay,
Polyak target updates, exploration noise — SURVEY.md §2a/§3.3; BASELINE
config 5 is "8192 envs sharded over 2+ hosts feeding an on-device
DDPG-style actor-learner via collectives", BASELINE.json:11;
reference mount empty this session).

Redesign (NOT a port of the TF-1.x graph):
  * The reference interleaves, per single env-step, 4 Python<->TF-C++
    session calls and ~15 Python<->Bullet calls, fully serially (SURVEY.md
    §3.3). Here ONE jitted `train_step` runs `rollout_steps` env-steps
    under `lax.scan` over the whole sharded env batch (actor forward fused
    into the scan body), inserts the chunk into the device-resident replay,
    then runs `updates_per_step` critic+actor+Polyak updates — zero host
    involvement.
  * Exploration: Ornstein-Uhlenbeck noise carried per env in the scan
    (matching the reference's OU process) or white Gaussian
    (`ou_theta=1, ou_sigma=sigma` degenerates appropriately).
  * Targets are pytree copies updated by `models.polyak`.
  * Under `dist.make_mesh` the env/replay batch axis is sharded on 'data';
    the learner's minibatch gradients reduce across devices via the psum
    XLA inserts for the replicated-param/sharded-batch layout.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..env import CartPole3D
from ..models import ActorMLP, CriticMLP, VisualActor, VisualCritic, polyak
from ..utils.prng import normal
from .common import (TAG_OU_X, TAG_OU_Y, as_key, gated_update_scan,
                     local_batch, make_train_scan, replay_presample)
from .replay import ReplayBuffer, ReplayState


@dataclasses.dataclass(frozen=True)
class DDPGConfig:
    # Defaults are the tuned recipe: 40k per-env steps at 1024 envs
    # reaches deterministic eval mean episode length 200/200 (pole
    # balanced to the cap).
    hidden: tuple = (256, 256)
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    gamma: float = 0.99
    tau: float = 0.01                # Polyak rate
    batch_size: int = 256            # learner minibatch
    rollout_steps: int = 8           # env-steps per train_step
    updates_per_step: int = 16       # gradient updates per train_step
    replay_capacity_per_env: int = 1024
    ou_theta: float = 0.15           # OU mean-reversion
    ou_sigma: float = 0.2            # OU noise scale
    ou_sigma_min: float = 0.02       # floor after decay
    ou_sigma_decay_env_steps: int = 20000  # linear decay horizon (0 = constant)
    warmup_env_steps: int = 16       # slots to fill before learning starts
    dtype: str = "float32"           # network compute dtype (or "bfloat16")
    sample: str = "column"           # replay sampling: column (fast) | uniform
    # Which critic the actor's gradient flows through: "updated" (the
    # critic AFTER this iteration's TD step — the round-1/2 semantics)
    # or "pre" (the critic the iteration started with). "pre" makes the
    # actor and critic backward passes data-independent, so XLA overlaps
    # them inside the serial-latency-bound update chain; both variants
    # are standard DDPG (the one-Adam-step critic difference is far
    # inside the TD error's noise floor).
    actor_grad_critic: str = "updated"
    # Polyak cadence: "per_update" (round-1/2 semantics: targets track
    # every gradient step) or "per_step" (targets frozen across the K
    # updates of one train_step, then moved once with the compounded
    # rate 1-(1-tau)^K — the same per-train_step pull, ~2*K fewer tiny
    # tree ops inside the serial update chain; equivalent to a target
    # update period of K gradient steps, standard in DQN-family code).
    polyak_cadence: str = "per_update"
    # Linear learning-rate decay horizon in PER-ENV env-steps (both
    # optimizers decay to lr * lr_end_frac over the horizon, then hold).
    # 0 = constant lr. Motivation: long pixel-DDPG runs regressed past
    # the OU-noise decay horizon: once exploration is at the floor, a
    # constant-lr learner keeps taking full-size steps on correlated
    # on-distribution batches and walks away from the good policy.
    # Scheduled on the gradient-step count (env-step horizon converted
    # via updates_per_step / rollout_steps).
    lr_decay_env_steps: int = 0
    lr_end_frac: float = 0.1
    # Pixel-obs encoder: "conv" (3x3-stride-2 stack, the reference-shaped
    # default) or "patch" (non-overlapping patch embedding,
    # models/nets.py::PatchEncoder). Ignored for state observations.
    encoder: str = "conv"
    # Conv-encoder channel widths (pixel obs only); (16, 32, 32) is the
    # reference-shaped default.
    conv_features: tuple = (16, 32, 32)


class DDPGState(NamedTuple):
    actor: dict
    critic: dict
    actor_target: dict
    critic_target: dict
    actor_opt: tuple
    critic_opt: tuple
    replay: ReplayState
    env_state: tuple          # EnvState
    obs: jax.Array            # (B, obs_dim) current observation
    noise: jax.Array          # (B, act_dim) OU noise state
    rng: jax.Array            # PRNG key
    env_steps: jax.Array      # () int32 — env-steps taken (per env)


class DDPG:
    """Pure-function DDPG agent over a batched CartPole3D."""

    def __init__(self, env: CartPole3D, config: DDPGConfig = DDPGConfig(),
                 dist_axis: str | None = None, num_shards: int = 1):
        """dist_axis / num_shards: set when train_step runs inside
        shard_map over `num_shards` devices (dist/shardmap.py) — env must
        then be the PER-SHARD env, gradients pmean over the axis, each
        shard samples batch_size/num_shards locally, and per-shard PRNG
        streams decorrelate via axis_index."""
        if env.params.discrete_actions:
            raise ValueError("DDPG needs the continuous env "
                             "(CartPoleParams(discrete_actions=False))")
        self.env = env
        self.cfg = config
        self.dist_axis = dist_axis
        self.num_shards = num_shards
        dtype = jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32
        pixels = env.obs_mode == "pixels"
        if pixels:
            # Reference's pixel-obs DDPG: conv stack in front of both nets
            # (BASELINE config 4); frames replayed quantized to uint8.
            self.actor_net = VisualActor(action_dim=env.action_dim,
                                         hidden=config.hidden, dtype=dtype,
                                         encoder=config.encoder,
                                         features=tuple(
                                             config.conv_features))
            self.critic_net = VisualCritic(hidden=config.hidden, dtype=dtype,
                                           encoder=config.encoder,
                                           features=tuple(
                                               config.conv_features))
        else:
            self.actor_net = ActorMLP(action_dim=env.action_dim,
                                      hidden=config.hidden, dtype=dtype)
            self.critic_net = CriticMLP(hidden=config.hidden, dtype=dtype)
        self.replay = ReplayBuffer(
            num_envs=env.num_envs,
            capacity_per_env=config.replay_capacity_per_env,
            obs_shape=env.obs_shape,
            quantize_obs=pixels,
            action_dim=env.action_dim,
            discrete=False)
        if config.sample == "block":
            lb = local_batch(config.batch_size, max(self.num_shards, 1))
            if lb > env.num_envs or env.num_envs % lb:
                raise ValueError(
                    f"sample='block' needs the per-shard batch ({lb}) to "
                    f"divide num_envs ({env.num_envs}) — lower "
                    f"--<agent>.batch-size or use sample='column'")
        self.actor_tx = optax.adam(self._lr(config.actor_lr))
        self.critic_tx = optax.adam(self._lr(config.critic_lr))

    # --- init ---------------------------------------------------------------
    def init(self, key) -> DDPGState:
        k_actor, k_critic, k_env, k_run = jax.random.split(as_key(key), 4)
        obs0 = jnp.zeros((1,) + self.env.obs_shape, jnp.float32)
        act0 = jnp.zeros((1, self.env.action_dim), jnp.float32)
        actor = self.actor_net.init(k_actor, obs0)
        critic = self.critic_net.init(k_critic, obs0, act0)
        env_state, obs = self.env.reset(k_env)
        st = DDPGState(
            actor=actor,
            critic=critic,
            actor_target=jax.tree.map(jnp.copy, actor),
            critic_target=jax.tree.map(jnp.copy, critic),
            actor_opt=self.actor_tx.init(actor),
            critic_opt=self.critic_tx.init(critic),
            replay=self.replay.init(),
            env_state=env_state,
            obs=obs,
            noise=jnp.zeros((self.env.num_envs, self.env.action_dim),
                            jnp.float32),
            rng=k_run,
            env_steps=jnp.int32(0),
        )
        return st

    @property
    def local_batch_size(self) -> int:
        """Per-shard learner minibatch (cfg.batch_size is GLOBAL)."""
        return local_batch(self.cfg.batch_size, self.num_shards)

    # --- acting -------------------------------------------------------------
    def act(self, actor_params, obs, noise=None):
        """Deterministic action, plus OU exploration noise if given."""
        a = self.actor_net.apply(actor_params, obs)
        if noise is not None:
            a = jnp.clip(a + noise, -1.0, 1.0)
        return a

    def _sigma(self, env_steps):
        c = self.cfg
        if c.ou_sigma_decay_env_steps <= 0:
            return jnp.float32(c.ou_sigma)
        frac = jnp.clip(env_steps.astype(jnp.float32)
                        / c.ou_sigma_decay_env_steps, 0.0, 1.0)
        return c.ou_sigma + frac * (c.ou_sigma_min - c.ou_sigma)

    def _ou_step(self, noise, env_seed, t, sigma=None):
        """OU update with counter-based normals keyed by (env seed, global
        step) — exploration is bitwise independent of sharding layout."""
        c = self.cfg
        eps = jnp.stack([normal(env_seed, t, TAG_OU_X),
                         normal(env_seed, t, TAG_OU_Y)], axis=-1)
        s = c.ou_sigma if sigma is None else sigma
        return noise + c.ou_theta * (0.0 - noise) + s * eps

    # --- learning -----------------------------------------------------------
    def _critic_loss(self, critic, actor_target, critic_target, batch):
        obs, action, reward, next_obs, done = batch
        c = self.cfg
        a_next = self.actor_net.apply(actor_target, next_obs)
        q_next = self.critic_net.apply(critic_target, next_obs, a_next)
        y = reward + c.gamma * (1.0 - done.astype(jnp.float32)) * q_next
        q = self.critic_net.apply(critic, obs, action)
        return jnp.mean(jnp.square(q - jax.lax.stop_gradient(y)))

    def _actor_loss(self, actor, critic, obs):
        a = self.actor_net.apply(actor, obs)
        return -jnp.mean(self.critic_net.apply(critic, obs, a))

    def _sample(self, replay, key):
        """One learner minibatch (device-local under shard_map: the key is
        decorrelated by axis_index, and the gradient pmean is then the
        ONLY cross-device traffic of the whole update)."""
        if self.dist_axis is not None:
            key = jax.random.fold_in(key, jax.lax.axis_index(self.dist_axis))
        sample_fn = {"column": self.replay.sample_columns,
                     "block": self.replay.sample_block}.get(
            self.cfg.sample, self.replay.sample)
        return sample_fn(replay, key, self.local_batch_size)

    def _update_once(self, st: DDPGState, batch) -> tuple[DDPGState, dict]:
        c = self.cfg
        if not isinstance(batch, tuple):   # presample off: batch is a key
            batch = self._sample(st.replay, batch)
        closs, cgrad = jax.value_and_grad(self._critic_loss)(
            st.critic, st.actor_target, st.critic_target, batch)
        if self.dist_axis is not None:
            closs, cgrad = jax.lax.pmean((closs, cgrad), self.dist_axis)
        cupd, copt = self.critic_tx.update(cgrad, st.critic_opt, st.critic)
        critic = optax.apply_updates(st.critic, cupd)

        actor_critic = st.critic if c.actor_grad_critic == "pre" else critic
        aloss, agrad = jax.value_and_grad(self._actor_loss)(
            st.actor, actor_critic, batch[0])
        if self.dist_axis is not None:
            aloss, agrad = jax.lax.pmean((aloss, agrad), self.dist_axis)
        aupd, aopt = self.actor_tx.update(agrad, st.actor_opt, st.actor)
        actor = optax.apply_updates(st.actor, aupd)

        st = st._replace(actor=actor, critic=critic,
                         actor_opt=aopt, critic_opt=copt)
        if c.polyak_cadence == "per_update":
            st = st._replace(
                actor_target=polyak(st.actor_target, actor, c.tau),
                critic_target=polyak(st.critic_target, critic, c.tau))
        return st, {"critic_loss": closs, "actor_loss": aloss}

    def _frozen_target_update_scan(self, st: DDPGState, ready, presample):
        """per_step-polyak XLA learner with the TD targets hoisted OUT of
        the update scan: targets are frozen across the K updates (that is
        what per_step means), so y = r + gamma*(1-d)*Q'(s', mu'(s')) for
        ALL K presampled minibatches is ONE batched (K*B)-row pass
        through the target nets instead of K sequential ones on the
        serial update chain. Same y values as _update_once under
        per_step semantics; the win is largest for pixel nets, where
        each hoisted pass is a conv encoder."""
        c = self.cfg

        def do(s):
            rng, k = jax.random.split(s.rng)
            s = s._replace(rng=rng)
            keys = jax.random.split(k, c.updates_per_step)
            obs, action, reward, next_obs, done = presample(s, keys)
            kk, bs = reward.shape[:2]
            nobs = next_obs.reshape((kk * bs,) + next_obs.shape[2:])
            a_next = self.actor_net.apply(s.actor_target, nobs)
            q_next = self.critic_net.apply(s.critic_target, nobs, a_next)
            y = (reward.reshape(-1)
                 + c.gamma * (1.0 - done.reshape(-1).astype(jnp.float32))
                 * q_next).reshape(kk, bs)

            def body(s2, x):
                obs_b, act_b, y_b = x

                def closs_fn(critic):
                    q = self.critic_net.apply(critic, obs_b, act_b)
                    return jnp.mean(jnp.square(q - y_b))

                closs, cgrad = jax.value_and_grad(closs_fn)(s2.critic)
                if self.dist_axis is not None:
                    closs, cgrad = jax.lax.pmean((closs, cgrad),
                                                 self.dist_axis)
                cupd, copt = self.critic_tx.update(cgrad, s2.critic_opt,
                                                   s2.critic)
                critic = optax.apply_updates(s2.critic, cupd)
                actor_critic = (s2.critic if c.actor_grad_critic == "pre"
                                else critic)
                aloss, agrad = jax.value_and_grad(self._actor_loss)(
                    s2.actor, actor_critic, obs_b)
                if self.dist_axis is not None:
                    aloss, agrad = jax.lax.pmean((aloss, agrad),
                                                 self.dist_axis)
                aupd, aopt = self.actor_tx.update(agrad, s2.actor_opt,
                                                  s2.actor)
                actor = optax.apply_updates(s2.actor, aupd)
                s2 = s2._replace(actor=actor, critic=critic,
                                 actor_opt=aopt, critic_opt=copt)
                return s2, {"critic_loss": closs, "actor_loss": aloss}

            s, metrics = jax.lax.scan(body, s, (obs, action, y))
            return s, jax.tree.map(jnp.mean, metrics)

        zero = {"critic_loss": jnp.float32(0.0),
                "actor_loss": jnp.float32(0.0)}
        if ready is True:
            return do(st)
        return jax.lax.cond(ready, do, lambda s: (s, zero), st)

    def _lr(self, lr: float):
        """Constant lr, or the linear-decay optax schedule keyed on the
        gradient-step count."""
        c = self.cfg
        if c.lr_decay_env_steps <= 0:
            return lr
        return optax.linear_schedule(
            lr, lr * c.lr_end_frac,
            max(c.lr_decay_env_steps * c.updates_per_step
                // max(c.rollout_steps, 1), 1))

    def greedy_policy(self, st: DDPGState):
        """Deterministic policy fn(obs) -> action (no OU noise)."""
        return lambda o: self.act(st.actor, o)

    def evaluate(self, st: DDPGState, num_steps: int = 200, seed: int = 0):
        """Deterministic-actor evaluation (no OU noise): episode stats."""
        from .common import evaluate_policy

        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps)

    # --- the fused actor-learner step ---------------------------------------
    def train_step(self, st: DDPGState, capture: bool = False
                   ) -> tuple[DDPGState, dict]:
        """rollout_steps env-steps + replay insert + updates_per_step
        gradient updates, as one jit-able program."""
        c = self.cfg
        rng = st.rng
        sigma = self._sigma(st.env_steps)

        def env_body(carry, t):
            env_state, obs, noise = carry
            noise = self._ou_step(noise, env_state.env_seed, t, sigma)
            action = jnp.clip(
                self.actor_net.apply(st.actor, obs) + noise,
                -1.0, 1.0)
            env_state, next_obs, reward, done, _ = self.env.step(
                env_state, action)
            # Reset the OU state of envs that finished (fresh episode).
            noise = jnp.where(done[:, None], 0.0, noise)
            return ((env_state, next_obs, noise),
                    (obs, action, reward, done))

        (env_state, obs, noise), traj = jax.lax.scan(
            env_body, (st.env_state, st.obs, st.noise),
            st.env_steps + jnp.arange(c.rollout_steps, dtype=jnp.int32))
        # Pixel (quantized) rings insert AFTER the update phase: the
        # minibatch gather then reads the pre-insert ring and this
        # step's DUS is the ring's LAST use, so XLA updates the
        # multi-GB uint8 buffer in place — with insert-then-sample the
        # gather kept the old ring value live and buffer assignment
        # rewrote the full ring every train step. Cost: the freshest
        # rollout_steps transitions enter the candidate set one step
        # later (draw odds per row
        # ~1/capacity — statistically nil; keep warmup_env_steps >=
        # rollout_steps, the default, so the first gated-on update
        # never sees the empty ring). State-obs rings keep the original
        # order: their gather consumes the DUS output directly, which
        # aliases fine, and the promoted recipes' batch streams stay
        # bitwise unchanged.
        late_insert = self.replay.quantize_obs

        def insert(s):
            return s._replace(replay=self.replay.add_trajectory(
                s.replay, *traj, aligned=True))

        if not late_insert:
            st = insert(st)
        env_steps = st.env_steps + c.rollout_steps
        st = st._replace(env_state=env_state, obs=obs,
                         noise=noise, rng=rng, env_steps=env_steps)

        ready = (True if c.warmup_env_steps <= 0
                 else env_steps >= c.warmup_env_steps)
        if c.polyak_cadence == "per_step" and c.updates_per_step > 0:
            st, losses = self._frozen_target_update_scan(
                st, ready, replay_presample(self.replay, c.sample,
                                            c.batch_size, self.num_shards,
                                            self.dist_axis))
        else:
            st, losses = gated_update_scan(
                st, self._update_once, c.updates_per_step, ready,
                {"critic_loss": jnp.float32(0.0),
                 "actor_loss": jnp.float32(0.0)},
                presample=replay_presample(self.replay, c.sample,
                                           c.batch_size, self.num_shards,
                                           self.dist_axis))
        if late_insert:
            st = insert(st)
        if c.polyak_cadence == "per_step":
            # Compounded pull: K per-update polyaks at rate tau move the
            # target by 1-(1-tau)^K toward a FIXED online net; applying
            # that once is the same total pull, outside the update scan.
            tau_eff = jnp.where(ready,
                                1.0 - (1.0 - c.tau) ** c.updates_per_step,
                                0.0)
            st = st._replace(
                actor_target=polyak(st.actor_target, st.actor, tau_eff),
                critic_target=polyak(st.critic_target, st.critic, tau_eff))

        metrics = dict(losses)
        if capture:
            metrics["traj"] = traj
        reward_mean = jnp.mean(traj[2])
        done_frac = jnp.mean(traj[3].astype(jnp.float32))
        if self.dist_axis is not None:
            reward_mean, done_frac = jax.lax.pmean(
                (reward_mean, done_frac), self.dist_axis)
        metrics["reward_mean"] = reward_mean
        metrics["done_frac"] = done_frac
        metrics["env_steps"] = env_steps
        return st, metrics

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
