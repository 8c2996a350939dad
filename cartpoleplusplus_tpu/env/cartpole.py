"""Vectorized 3D cart-pole environment — batched, jitted, device-resident.

Reference counterpart: `bullet_cartpole.py::BulletCartpole(gym.Env)` in
rebcabin/cartpoleplusplus — action mapping (discrete 5-way noop/+x/-x/+y/-y
or continuous (fx, fy)), action-repeat with several physics substeps per
repeat, random push perturbations, pose-stack observations in lieu of
velocities, tilt/position/length termination, +1-or-shaped reward, and
per-episode reset (mechanics per BASELINE.json:5-12).

Redesign (NOT a port):
  * the batch axis is built into every array — there is no per-env object,
    no Python in the hot path; `step` is one pure jittable function;
  * per-episode Python `reset()` becomes masked auto-reset
    (`tree.map(where(done, ...))`) inside the same jitted step;
  * the ~15 Python<->C++ pybullet crossings per env-step become zero:
    action map, substeps, pushes, obs assembly, termination, reward and
    reset fuse into one XLA program (and one GPU kernel in ops/);
  * randomness is a pure function of (per-env key, episode step), with
    per-env keys derived from the global env index — results are identical
    under any sharding layout (multi-host determinism).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

import numpy as np

from ..physics import (
    CartPoleParams,
    PhysState,
    pole_w,
    rest_state,
    run_substeps,
)
from ..utils.prng import hash_words
from . import compute
from .obs import (
    OBS_MODES,
    obs_size,
    pose_frame,
    stack_obs,
    state_obs,
)
from .pixels import RenderConfig, pixel_obs_shape, render_all_cameras

# Discrete action -> force direction table (noop, +x, -x, +y, -y).
# Reference: the 5-way discrete action space of `bullet_cartpole.py`.
# numpy (not jnp) so importing this module does not initialize the XLA
# backend — required for jax.distributed.initialize to be callable after
# importing the package (multi-host runtime).
_ACTION_TABLE = np.array(
    [[0.0, 0.0], [1.0, 0.0], [-1.0, 0.0], [0.0, 1.0], [0.0, -1.0]],
    dtype=np.float32,
)


class EnvState(NamedTuple):
    """Full per-env state pytree. Leaves have leading batch dim (B,)."""

    phys: PhysState       # physical coordinates
    steps: jax.Array      # (B,) int32 — steps elapsed in current episode
    env_seed: jax.Array   # (B,) uint32 — per-env PRNG seed (from global index)
    episode: jax.Array    # (B,) int32 — episode counter (salts per-episode RNG)


def to_seed(key) -> jnp.uint32:
    """Normalize an int seed or a jax PRNG key to a uint32 seed."""
    if isinstance(key, (int, np.integer)):
        return jnp.uint32(key & 0xFFFFFFFF)
    if hasattr(key, "dtype") and jnp.issubdtype(key.dtype, jax.dtypes.prng_key):
        key = jax.random.key_data(key)
    flat = jnp.asarray(key).astype(jnp.uint32).reshape(-1)
    return jax.lax.reduce(flat, jnp.uint32(0), jax.lax.bitwise_xor, (0,))


def derive_env_seeds(key, num_envs: int, index_offset=0) -> jax.Array:
    """Per-env seeds from (global seed, global env index) — independent of
    batch slot or sharding layout (SURVEY.md §7 hard part 5).

    index_offset shifts the env indices: a shard_map body resetting its
    LOCAL slice passes `axis_index * local_num_envs` so env i of shard s
    gets the seed of GLOBAL env s*local+i — the sharded reset is then
    bitwise-identical to slicing a global reset (tests/test_dist.py)."""
    idx = jnp.arange(num_envs, dtype=jnp.uint32)
    idx = idx + jnp.asarray(index_offset, jnp.uint32)
    return hash_words(to_seed(key), idx)


def reset_randomness(p: CartPoleParams, env_seed, episode):
    """Initial push force vector (..., 2); stack-wrapper over the shared
    componentwise source (env/compute.py — also used inside the Pallas
    kernel and by the numpy oracle harness)."""
    px, py = compute.reset_push_xy(p, env_seed, episode)
    return jnp.stack([px, py], axis=-1)


def push_randomness(p: CartPoleParams, env_seed, episode, step, repeat):
    """Mid-episode push force (..., 2); stack-wrapper over env/compute.py."""
    px, py = compute.push_xy(p, env_seed, episode, step, repeat)
    return jnp.stack([px, py], axis=-1)


def _reset_phys(p: CartPoleParams, env_seed, episode) -> PhysState:
    """Fresh episode state (any batch shape): upright rest pose + random
    push impulse (the reference applies a random force over the first
    substeps; the impulse through the mass matrix is the equivalent
    momentum transfer). Stack-wrapper over the shared componentwise source
    env/compute.py::reset_components, which the Pallas kernel evaluates
    verbatim — resets are identical in both paths by construction."""
    c = compute.reset_components(p, env_seed, episode)
    return PhysState(pos=jnp.stack(c[0:3], axis=-1),
                     vel=jnp.stack(c[3:6], axis=-1),
                     s=jnp.stack(c[6:8], axis=-1),
                     sd=jnp.stack(c[8:10], axis=-1))


def _map_action(p: CartPoleParams, action) -> jax.Array:
    """Agent action -> cart force (B, 2)."""
    if p.discrete_actions:
        return jnp.asarray(_ACTION_TABLE)[action] * p.action_force
    return jnp.clip(action, -1.0, 1.0) * p.action_force


def _termination(p: CartPoleParams, phys: PhysState, steps):
    """Wrapper over env/compute.py::termination_components (the shared
    kernel/env source); additionally splits tilt vs out-of-bounds for the
    info dict."""
    done_phys, too_long = compute.termination_components(
        p, phys.pos[..., 0], phys.pos[..., 1],
        phys.s[..., 0], phys.s[..., 1], steps)
    s2 = jnp.sum(phys.s * phys.s, axis=-1)
    tilted = s2 > p.tilt_s2_limit
    oob = done_phys & ~tilted
    return tilted, oob, too_long


def _reward(p: CartPoleParams, phys: PhysState, done_physical):
    """Wrapper over env/compute.py::reward_components (shared source)."""
    return compute.reward_components(
        p, phys.pos[..., 0], phys.pos[..., 1],
        phys.s[..., 0], phys.s[..., 1], done_physical)


class CartPole3D:
    """Functional batched env. All methods are pure and jit-friendly;
    `self` only carries static configuration (hashable params + ints).

    Usage:
        env = CartPole3D(CartPoleParams(), num_envs=4096)
        state, obs = jax.jit(env.reset)(jax.random.PRNGKey(0))
        state, obs, reward, done, info = jax.jit(env.step)(state, action)
    """

    def __init__(self, params: CartPoleParams = CartPoleParams(),
                 num_envs: int = 1, obs_mode: str = "pose_stack",
                 auto_reset: bool = True,
                 render_config: RenderConfig | None = None):
        if obs_mode not in OBS_MODES:
            raise ValueError(f"obs_mode must be one of {OBS_MODES}")
        self.params = params
        self.num_envs = num_envs
        self.obs_mode = obs_mode
        self.auto_reset = auto_reset
        self.render_config = (render_config if render_config is not None
                              else RenderConfig())

    # --- spaces ------------------------------------------------------------
    @property
    def num_actions(self) -> int:
        """5 for the discrete variant (reference's noop/+-x/+-y)."""
        return 5 if self.params.discrete_actions else 0

    @property
    def action_dim(self) -> int:
        """2 for the continuous variant (fx, fy in [-1, 1])."""
        return 0 if self.params.discrete_actions else 2

    @property
    def obs_size(self) -> int:
        """Flat observation length (pixels: product of obs_shape)."""
        if self.obs_mode == "pixels":
            h, w, c = self.obs_shape
            return h * w * c
        return obs_size(self.params, self.obs_mode)

    @property
    def obs_shape(self) -> tuple:
        """Per-env observation shape: (obs_size,) or (H, W, C) for pixels
        (repeat-window frames and cameras stacked on channels, mirroring
        the reference's frame stacking in lieu of velocities)."""
        if self.obs_mode == "pixels":
            return pixel_obs_shape(self.params, self.render_config)
        return (obs_size(self.params, self.obs_mode),)

    def render(self, phys: PhysState) -> jax.Array:
        """All-camera view of the current physical state:
        (B, H, W, 3 * num_cameras) float32 in [0, 1] (one plane per
        camera when grayscale). The batched counterpart of
        pybullet.getCameraImage: the analytic raycaster of
        env/pixels.py, which XLA fuses into one elementwise kernel."""
        return render_all_cameras(self.params, phys, self.render_config)

    # --- episode API ---------------------------------------------------------
    def reset(self, key, index_offset=0) -> tuple[EnvState, jax.Array]:
        """Fresh state for all envs. Per-env seeds are derived from the
        global env index so results are sharding-layout independent.
        index_offset: see derive_env_seeds — lets a per-shard env reset
        its slice with GLOBAL env identities inside shard_map."""
        b = self.num_envs
        env_seed = derive_env_seeds(key, b, index_offset)
        episode = jnp.zeros((b,), jnp.int32)
        phys = _reset_phys(self.params, env_seed, episode)
        state = EnvState(phys=phys, steps=jnp.zeros((b,), jnp.int32),
                         env_seed=env_seed, episode=episode)
        return state, self._initial_obs(phys)

    def _obs_frame(self, phys: PhysState) -> jax.Array:
        """One rendered obs frame, quantized to uint8 when configured
        (RenderConfig.obs_uint8 — 4x less HBM traffic through the
        stack/reset-select/replay pipeline)."""
        frame = self.render(phys)
        if self.render_config.obs_uint8:
            frame = jnp.clip(frame * 255.0 + 0.5, 0.0, 255.0).astype(
                jnp.uint8)
        return frame

    def _stack_diff_obs(self, frames) -> jax.Array:
        """Frame-difference pixel observation (RenderConfig.frame_diff):
        stack [latest frame, 0.5*(f_r - f_{r-1}) + 0.5 per consecutive
        pair] on channels — same shape as the raw R-frame stack, motion
        made explicit. `frames` are FLOAT [0, 1] renders (diffs must be
        computed before uint8 quantization); quantization, when
        configured, applies uniformly to every plane afterwards."""
        g = 0.5 * self.render_config.frame_diff_gain
        planes = [frames[-1]] + [jnp.clip(g * (b - a) + 0.5, 0.0, 1.0)
                                 for a, b in zip(frames[:-1], frames[1:])]
        if self.render_config.obs_uint8:
            planes = [jnp.clip(x * 255.0 + 0.5, 0.0, 255.0).astype(
                jnp.uint8) for x in planes]
        return stack_obs(planes)

    def _reset_obs_pixels(self) -> jax.Array:
        """(1, H, W, C*R) — the observation every freshly-reset env sees.

        The fresh-episode pose is deterministic: reset randomness enters
        through velocities only (env/compute.py::reset_components), and
        rendering reads only pos and s, so the reset observation is ONE
        constant image. Rendered here at batch 1 on the XLA path and
        broadcast through the auto-reset select — instead of
        re-rendering the whole post-reset batch, which cost 1 of the 4
        renders in every pixel-mode env-step."""
        phys1 = rest_state(self.params, batch_shape=(1,))
        frame = render_all_cameras(self.params, phys1, self.render_config)
        if self.render_config.frame_diff:  # diff planes: constant 0.5
            return self._stack_diff_obs(
                [frame] * self.params.action_repeats)
        if self.render_config.obs_uint8:
            frame = jnp.clip(frame * 255.0 + 0.5, 0.0, 255.0).astype(
                jnp.uint8)
        return stack_obs([frame] * self.params.action_repeats)

    def _initial_obs(self, phys: PhysState) -> jax.Array:
        if self.obs_mode == "state":
            return state_obs(self.params, phys)
        # Reference reset assembles the first obs by repeating the initial
        # pose (or frame) across the repeat window.
        if self.obs_mode == "pixels":
            if self.render_config.frame_diff:
                return self._stack_diff_obs(
                    [self.render(phys)] * self.params.action_repeats)
            frame = self._obs_frame(phys)
        else:
            frame = pose_frame(self.params, phys)
        return stack_obs([frame] * self.params.action_repeats)

    def step(self, state: EnvState, action):
        """One env-step: R action-repeats x S physics substeps, pose
        snapshot per repeat, termination, reward, masked auto-reset."""
        p = self.params
        force = _map_action(p, action)
        phys = state.phys

        frames = []
        for r in range(p.action_repeats):
            if p.push_prob_per_repeat > 0.0:
                push = push_randomness(p, state.env_seed, state.episode,
                                       state.steps, r)
            else:
                push = jnp.zeros_like(force)
            phys = run_substeps(p, phys, force, push, p.steps_per_repeat)
            if self.obs_mode == "pose_stack":
                frames.append(pose_frame(p, phys))
            elif self.obs_mode == "pixels":
                # frame_diff needs FLOAT frames (diffs precede uint8
                # quantization — _stack_diff_obs quantizes after).
                frames.append(self.render(phys)
                              if self.render_config.frame_diff
                              else self._obs_frame(phys))

        steps = state.steps + 1
        tilted, oob, too_long = _termination(p, phys, steps)
        done_physical = tilted | oob
        done = done_physical | too_long
        reward = _reward(p, phys, done_physical)

        if self.obs_mode == "state":
            terminal_obs = state_obs(p, phys)
        elif self.obs_mode == "pixels" and self.render_config.frame_diff:
            terminal_obs = self._stack_diff_obs(frames)
        else:
            terminal_obs = stack_obs(frames)

        info = {
            "terminal_obs": terminal_obs,
            "tilted": tilted,
            "out_of_bounds": oob,
            "truncated": too_long & ~done_physical,
            "steps": steps,
        }

        if self.auto_reset:
            episode = state.episode + done.astype(jnp.int32)
            fresh = _reset_phys(p, state.env_seed, episode)
            sel = lambda a, b: jnp.where(
                done.reshape(done.shape + (1,) * (a.ndim - 1)), a, b)
            phys = jax.tree.map(sel, fresh, phys)
            steps = jnp.where(done, 0, steps)
            new_state = EnvState(phys=phys, steps=steps,
                                 env_seed=state.env_seed, episode=episode)
            # The obs used to pick the NEXT action: post-reset for done envs.
            if self.obs_mode == "state":
                obs = state_obs(p, phys)
            else:
                if self.obs_mode == "pixels":
                    # One constant (1, H, W, C*R) image, broadcast —
                    # the reset pose is deterministic (see helper).
                    reset_obs = self._reset_obs_pixels()
                else:
                    reset_obs = self._initial_obs(phys)
                done_b = done.reshape(
                    done.shape + (1,) * (reset_obs.ndim - done.ndim))
                obs = jnp.where(done_b, reset_obs, terminal_obs)
        else:
            new_state = state._replace(phys=phys, steps=steps)
            obs = terminal_obs

        return new_state, obs, reward, done, info

    # --- rollout -------------------------------------------------------------
    def rollout(self, state: EnvState, policy_fn, length: int,
                policy_key=None):
        """Device-resident rollout: `length` env-steps under lax.scan.

        policy_fn(obs, key) -> action. Returns final state and stacked
        (obs, action, reward, done) trajectories, time-major.
        Reference counterpart: the Python `while not done: env.step(...)`
        agent loop — here the whole rollout is one XLA program.
        """
        p = self.params
        if policy_key is None:
            policy_key = jax.random.PRNGKey(0)
        obs0 = self._initial_obs(state.phys)

        def body(carry, _):
            st, obs, k = carry
            k, ka = jax.random.split(k)
            action = policy_fn(obs, ka)
            st, next_obs, reward, done, _ = self.step(st, action)
            return (st, next_obs, k), (obs, action, reward, done)

        (state, _, _), traj = jax.lax.scan(
            body, (state, obs0, policy_key), None, length=length)
        return state, traj


def make_step_fn(env: CartPole3D):
    """A jitted step with donated state (no per-step reallocation)."""
    return jax.jit(env.step, donate_argnums=(0,))
