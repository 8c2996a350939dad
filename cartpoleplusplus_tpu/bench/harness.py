"""Throughput benchmark harness.

Headline metric (BASELINE.json:2,5): env-steps/s per device at 4096 envs (one env-step = one full agent step: action map + action_repeats x
steps_per_repeat physics substeps + obs assembly + termination/reward +
masked auto-reset), plus 1-chip -> N-chip scaling efficiency.

The rollout is one jitted lax.scan; nothing leaves the device during timing.
Observations are computed every step (they are part of env.step's contract)
but reduced on device instead of materialized — a stored trajectory would
measure the memory system, not the engine. Every result names the device
it ran on.
"""

from __future__ import annotations

import time

import jax
import jax.numpy as jnp

from ..env import CartPole3D


def _cheap_actions(env: CartPole3D, t, b):
    """Deterministic, ~free action stream (exercises every action)."""
    if env.params.discrete_actions:
        return (t + jnp.arange(b, dtype=jnp.int32)) % 5
    phase = (t.astype(jnp.float32) * 0.37)[None] + jnp.arange(
        b, dtype=jnp.float32)[:, None]
    return jnp.sin(phase + jnp.array([0.0, 1.57])[None, :])


def build_rollout(env: CartPole3D, num_steps: int, donate: bool = True):
    """Jitted fn: state -> (state, checksum). Obs/reward reduced on device."""

    def run(state):
        def body(carry, t):
            st, acc = carry
            a = _cheap_actions(env, t, env.num_envs)
            st, obs, reward, done, _ = env.step(st, a)
            acc = acc + jnp.sum(reward) + jnp.sum(obs[..., 0])
            return (st, acc), None

        (state, acc), _ = jax.lax.scan(
            body, (state, jnp.float32(0.0)),
            jnp.arange(num_steps, dtype=jnp.int32))
        return state, acc

    return jax.jit(run, donate_argnums=(0,) if donate else ())


def measure_env_steps_per_sec(env: CartPole3D, num_steps: int = 512,
                              repeats: int = 8, seed: int = 0,
                              rollout=None) -> dict:
    """Compile, warm up once, then report the best-of-`repeats` rate."""
    run = rollout if rollout is not None else build_rollout(env, num_steps)
    state, _ = jax.jit(env.reset)(seed)

    t0 = time.perf_counter()
    state, acc = jax.block_until_ready(run(state))
    compile_and_first = time.perf_counter() - t0

    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        state, acc = jax.block_until_ready(run(state))
        best = min(best, time.perf_counter() - t0)
    checksum = float(acc)

    steps = env.num_envs * num_steps
    return {
        "env_steps_per_sec": steps / best,
        "substeps_per_sec": steps * env.params.substeps_per_step / best,
        "num_envs": env.num_envs,
        "num_steps": num_steps,
        "best_seconds": best,
        "compile_and_first_seconds": compile_and_first,
        "checksum": checksum,
        **device_info(),
    }


def device_info() -> dict:
    """The device a result was measured on, as JAX reports it."""
    d = jax.devices()[0]
    return {"backend": jax.default_backend(), "platform": d.platform,
            "device_kind": d.device_kind, "device_count": len(jax.devices())}
