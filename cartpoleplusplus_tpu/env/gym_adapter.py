"""Single-env gym-style adapter — the reference's exact API shape.

Reference counterpart: `bullet_cartpole.py::BulletCartpole(gym.Env)` —
`reset() -> obs`, `step(a) -> (obs, reward, done, info)`, `render()`, gym
spaces, and the static `add_opts(parser)` hook trainers composed flags
with (SURVEY.md §1 L1; reference mount empty this session).

This is the migration shim for users of the reference: numpy in/out, one
env, same call shapes. The batched `CartPole3D` underneath still runs
jitted on device (a 1-env batch); for throughput use CartPole3D directly.
gym/gymnasium are not dependencies — `Discrete`/`Box` are duck-typed
stand-ins with the same attributes (n / low, high, shape) and `sample()`.
"""

from __future__ import annotations

import argparse

import jax
import numpy as np

from ..config import add_dataclass_args, from_args
from ..physics import CartPoleParams
from .cartpole import CartPole3D
from .pixels import RenderConfig, render


class Discrete:
    """gym.spaces.Discrete stand-in."""

    def __init__(self, n: int):
        self.n = n
        self.shape = ()
        self.dtype = np.int64

    def sample(self, rng=None):
        if rng is None:
            rng = np.random
        if hasattr(rng, "integers"):  # numpy Generator API
            return int(rng.integers(self.n))
        return int(rng.randint(self.n))

    def contains(self, x):
        return 0 <= int(x) < self.n


class Box:
    """gym.spaces.Box stand-in."""

    def __init__(self, low, high, shape, dtype=np.float32):
        self.low = np.full(shape, low, dtype)
        self.high = np.full(shape, high, dtype)
        self.shape = tuple(shape)
        self.dtype = dtype

    def sample(self, rng=None):
        if rng is None:
            rng = np.random
        # Unbounded dims sample standard normal (gym.Box convention);
        # bounded dims sample uniform.
        bounded = np.isfinite(self.low) & np.isfinite(self.high)
        lo = np.where(bounded, self.low, 0.0)
        hi = np.where(bounded, self.high, 1.0)
        u = rng.uniform(lo, hi)
        g = rng.standard_normal(self.shape) if hasattr(
            rng, "standard_normal") else rng.randn(*self.shape)
        return np.where(bounded, u, g).astype(self.dtype)

    def contains(self, x):
        x = np.asarray(x)
        return (x.shape == self.shape and np.all(x >= self.low)
                and np.all(x <= self.high))


class GymCartPole3D:
    """The reference's env class shape over the batched device env."""

    metadata = {"render.modes": ["rgb_array"]}

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 obs_mode: str = "pose_stack", seed: int = 0,
                 render_config: RenderConfig | None = None):
        # auto_reset=False: gym semantics — the caller sees the terminal
        # observation and resets explicitly (the reference's per-episode
        # Python reset).
        self._env = CartPole3D(params, num_envs=1, obs_mode=obs_mode,
                               auto_reset=False,
                               render_config=render_config)
        self._seed = seed
        self._episode = 0
        self._reset_fn = jax.jit(self._env.reset)
        self._step_fn = jax.jit(self._env.step)
        self._state = None
        if params.discrete_actions:
            self.action_space = Discrete(self._env.num_actions)
        else:
            self.action_space = Box(-1.0, 1.0, (self._env.action_dim,))
        if obs_mode == "pixels":
            self.observation_space = Box(0.0, 1.0, self._env.obs_shape)
        else:
            self.observation_space = Box(-np.inf, np.inf,
                                         (self._env.obs_size,))

    # the reference's flag-composition hook
    @staticmethod
    def add_opts(parser: argparse.ArgumentParser) -> None:
        """Contribute this env's flags to a composed argparse parser
        (reference: `BulletCartpole.add_opts`)."""
        add_dataclass_args(parser, CartPoleParams, prefix="env.")

    @staticmethod
    def from_opts(args: argparse.Namespace, **kw) -> "GymCartPole3D":
        return GymCartPole3D(from_args(CartPoleParams, args, prefix="env."),
                             **kw)

    def seed(self, seed: int):
        """Restart the reproducible episode sequence from `seed` — the
        next reset() matches a fresh env constructed with this seed."""
        self._seed = seed
        self._episode = 0

    def reset(self) -> np.ndarray:
        # A fresh episode: new derived seed per (seed, episode) so repeated
        # resets explore different initial pushes, reproducibly.
        self._state, obs = self._reset_fn(
            self._seed * 1_000_003 + self._episode)
        self._episode += 1
        return np.asarray(obs[0])

    def step(self, action):
        if self._state is None:
            raise RuntimeError("call reset() before step()")
        if self._env.params.discrete_actions:
            a = np.asarray([int(action)], np.int32)
        else:
            a = np.asarray(action, np.float32)[None]
        self._state, obs, reward, done, info = self._step_fn(self._state, a)
        info_out = {k: np.asarray(v)[0] for k, v in info.items()
                    if k != "terminal_obs"}
        return (np.asarray(obs[0]), float(reward[0]), bool(done[0]),
                info_out)

    def render(self, mode: str = "rgb_array") -> np.ndarray:
        """RGB frame from camera 0 (reference GUI/getCameraImage parity)."""
        if self._state is None:
            raise RuntimeError("call reset() before render()")
        cfg = self._env.render_config
        img = render(self._env.params, self._state.phys, cfg,
                     cfg.cameras[0])
        return (np.asarray(img[0]) * 255.0 + 0.5).astype(np.uint8)

    def close(self):
        pass

