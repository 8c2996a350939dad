"""Likelihood-ratio policy gradient (REINFORCE) on the discrete env.

Reference counterpart: `lrpg_cartpole.py` — a TF softmax policy trained
with the likelihood-ratio gradient over complete episodes (SURVEY.md §2a;
reference mount empty this session).

Redesign: on-policy batched rollouts under `lax.scan`; returns-
to-go are computed with a reverse scan that zeroes across the masked
auto-reset episode boundaries, so one fixed-length rollout window spans
many (partial) episodes across the 4096-env batch — the batched equivalent
of the reference's episode loop. A running-mean baseline reduces variance
(the reference's vanilla estimator is the baseline=0 special case).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple

import jax
import jax.numpy as jnp
import optax

from ..env import CartPole3D
from ..models import PolicyMLP
from ..utils.prng import gumbel
from .common import TAG_PG_GUMBEL, as_key, make_train_scan, run_rollout


@dataclasses.dataclass(frozen=True)
class LRPGConfig:
    hidden: tuple = (64, 64)
    lr: float = 3e-4
    gamma: float = 0.99
    rollout_steps: int = 32          # env-steps per update window
    baseline_rate: float = 0.05      # EMA rate for the scalar return baseline
    entropy_coef: float = 0.1   # strong: prevents softmax collapse (see _loss)
    dtype: str = "float32"
    # Pixel-obs encoder ("conv" | "patch"), ignored for state obs.
    encoder: str = "conv"
    # Conv-encoder channel widths (pixel obs only; see DDPGConfig).
    conv_features: tuple = (16, 32, 32)


class LRPGState(NamedTuple):
    params: dict
    opt: tuple
    baseline: jax.Array       # () float32 — EMA of returns
    env_state: tuple
    obs: jax.Array
    rng: jax.Array
    env_steps: jax.Array


def returns_to_go(reward, done, gamma: float, bootstrap):
    """Discounted returns over a time-major (T, B) window; the recursion
    stops at done flags (masked auto-reset boundaries)."""

    def body(carry, tr):
        r, d = tr
        g = r + gamma * carry * (1.0 - d.astype(jnp.float32))
        return g, g

    _, g = jax.lax.scan(body, bootstrap, (reward, done), reverse=True)
    return g


class LRPG:
    def __init__(self, env: CartPole3D, config: LRPGConfig = LRPGConfig(),
                 dist_axis: str | None = None, num_shards: int = 1):
        """dist_axis / num_shards: set when train_step runs inside
        shard_map (dist/shardmap.py) with a PER-SHARD env. The window
        statistics the update depends on (returns baseline, advantage
        mean/std) become GLOBAL via pmean, and the gradient pmeans over
        the axis, so the sharded math equals the single-device run on
        the union batch."""
        if not env.params.discrete_actions:
            raise ValueError("LRPG needs the discrete env")
        self.env = env
        self.cfg = config
        self.dist_axis = dist_axis
        self.num_shards = num_shards
        dtype = jnp.bfloat16 if config.dtype == "bfloat16" else jnp.float32
        if env.obs_mode == "pixels":
            # Pixel-observation LRPG: conv stack in front of the softmax
            # policy (the reference's shared conv helpers fed every
            # trainer's graph — SURVEY.md §2a). On-policy: the rollout
            # window holds the uint8 frames directly, no replay ring.
            from ..models import VisualPolicy
            self.net = VisualPolicy(num_actions=env.num_actions,
                                    hidden=config.hidden, dtype=dtype,
                                    encoder=config.encoder,
                                    features=tuple(config.conv_features))
        else:
            self.net = PolicyMLP(num_actions=env.num_actions,
                                 hidden=config.hidden, dtype=dtype)
        self.tx = optax.adam(config.lr)

    def init(self, key) -> LRPGState:
        k_net, k_env, k_run = jax.random.split(as_key(key), 3)
        obs0 = jnp.zeros((1,) + self.env.obs_shape, jnp.float32)
        params = self.net.init(k_net, obs0)
        env_state, obs = self.env.reset(k_env)
        st = LRPGState(params=params, opt=self.tx.init(params),
                       baseline=jnp.float32(0.0), env_state=env_state,
                       obs=obs, rng=k_run, env_steps=jnp.int32(0))
        return st

    def act(self, params, obs, env_seed, t):
        """Exact softmax sample via Gumbel-max over counter-PRNG draws:
        a pure function of (per-env seed, global step), so on-policy
        sampling is bitwise independent of batch slot and sharding (the
        CLAUDE.md randomness invariant — jax.random.categorical with a
        threaded key would make the draw depend on batch position)."""
        logits = self.net.apply(params, obs)
        g = jnp.stack([gumbel(env_seed, t, TAG_PG_GUMBEL, a)
                       for a in range(self.env.num_actions)], axis=-1)
        return jnp.argmax(logits + g, axis=-1).astype(jnp.int32)

    def greedy_policy(self, st: LRPGState):
        """Argmax policy fn(obs) -> action."""
        return lambda o: jnp.argmax(self.net.apply(st.params, o),
                                    -1).astype(jnp.int32)

    def evaluate(self, st: LRPGState, num_steps: int = 200, seed: int = 0):
        """Argmax-policy evaluation: episode stats."""
        from .common import evaluate_policy

        return evaluate_policy(self.env, self.greedy_policy(st), seed,
                               num_steps)

    def _loss(self, params, obs, action, advantage):
        logits = self.net.apply(params, obs)
        logp = jax.nn.log_softmax(logits)
        lp_a = jnp.take_along_axis(logp, action[..., None], -1)[..., 0]
        pg = -jnp.mean(lp_a * advantage)
        entropy = -jnp.mean(jnp.sum(jnp.exp(logp) * logp, axis=-1))
        return pg - self.cfg.entropy_coef * entropy

    def train_step(self, st: LRPGState, capture: bool = False
                   ) -> tuple[LRPGState, dict]:
        """On-policy rollout window + returns-to-go + one policy-gradient
        update, as one jit-able program."""
        c = self.cfg
        rng = st.rng
        env_seed = st.env_state.env_seed

        env_state, obs, (obs_t, act_t, rew_t, done_t) = run_rollout(
            self.env,
            lambda o, t: self.act(st.params, o, env_seed, t),
            st.env_state, st.obs,
            st.env_steps + jnp.arange(c.rollout_steps, dtype=jnp.int32))

        # Bootstrap the cut-off tail with the baseline (bias-variance
        # trade-off for the fixed window; exact at episode boundaries).
        g = returns_to_go(rew_t, done_t, c.gamma,
                          jnp.full((self.env.num_envs,), st.baseline))
        # Window statistics are GLOBAL under shard_map (equal shard
        # sizes make mean-of-shard-means the union mean), so the
        # sharded update equals the single-device update on the union
        # window.
        def gmean(x):
            m = jnp.mean(x)
            return (jax.lax.pmean(m, self.dist_axis)
                    if self.dist_axis is not None else m)

        g_mean = gmean(g)
        baseline = ((1.0 - c.baseline_rate) * st.baseline
                    + c.baseline_rate * g_mean)
        # Window-mean-centered, normalized advantages. Centering is what
        # prevents softmax collapse: an uncentered positive advantage
        # reinforces every sampled action, which locks the policy onto the
        # initially-likeliest one within a few updates (observed
        # empirically). The EMA baseline's only remaining role is the
        # returns bootstrap above.
        adv = g - g_mean
        adv = adv / (jnp.sqrt(gmean(adv * adv)) + 1e-6)

        loss, grad = jax.value_and_grad(self._loss)(
            st.params, obs_t, act_t, jax.lax.stop_gradient(adv))
        if self.dist_axis is not None:
            loss, grad = jax.lax.pmean((loss, grad), self.dist_axis)
        upd, opt = self.tx.update(grad, st.opt, st.params)
        params = optax.apply_updates(st.params, upd)

        st = LRPGState(params=params, opt=opt, baseline=baseline,
                       env_state=env_state, obs=obs, rng=rng,
                       env_steps=st.env_steps + c.rollout_steps)
        metrics = {
            "loss": loss,
            "return_mean": g_mean,
            "reward_mean": gmean(rew_t),
            "done_frac": gmean(done_t.astype(jnp.float32)),
            "env_steps": st.env_steps,
        }
        if capture:
            metrics["traj"] = (obs_t, act_t, rew_t, done_t)
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
