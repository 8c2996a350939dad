"""Fused env rollout: T env-steps in one GPU kernel (Pallas through Triton).

Reference counterpart: Bullet's C++ `stepSimulation` inner loop — the
reference's native hot path (SURVEY.md §2). One `pallas_call` runs T
env-steps x R action repeats x S semi-implicit-Euler substeps, the
benchmark action map, pose-frame observation assembly,
termination/reward and masked auto-reset, with each env's 13-scalar
state held in registers for the whole window.

Layout: envs have no coupling, so the grid is one program per block of
128 envs (a power of two, as Triton requires), with one env per thread
(4 warps): the per-env step is a long dependent chain. On an H100, 32-,
64- and 128-env blocks at one env per thread timed within 2% of each
other, and two or more envs per thread were slower. Blocks run
in no order on the card's SMs, so nothing is carried between them: each
program loops over the T steps itself (`lax.fori_loop`) and writes its
envs' final state plus a per-env checksum column, which the wrapper
sums. A batch that is not a block multiple is padded to one; the
padded lanes run on a zero state and are sliced off before the sum.

Shared math: the kernel body calls the componentwise functions of
physics/dynamics.py, env/compute.py and utils/prng.py, so the kernel
and the XLA scan over env.step (`reference_rollout`) are the same
numerics by construction; tests/test_ops.py checks state parity in
interpret mode and chip_smoke.py on the card.

The benchmark action stream is a counter-PRNG function of
(env_seed, global step) — identical in the kernel and its twins.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from ..env.cartpole import EnvState
from ..env.compute import (
    frame_sum,
    push_xy,
    reset_components,
    reward_components,
    termination_components,
)
from ..physics import CartPoleParams
from ..physics.dynamics import substep_components
from ..utils.prng import hash_words, uniform

_TAG_BENCH_ACTION = 0x31
BLOCK_ENVS = 128


# --- componentwise building blocks (shared kernel <-> jnp twins) ------------

def bench_action_force(p: CartPoleParams, env_seed, t):
    """Deterministic pseudo-random benchmark action -> (fx, fy) forces.

    Discrete: uniform over the 5-way action set; continuous: uniform in
    the [-1, 1]^2 force box. Pure uint32 hashing — identical inside the
    kernel and in the jnp reference path.
    """
    if p.discrete_actions:
        idx = hash_words(env_seed, t, _TAG_BENCH_ACTION) % np.uint32(5)
        fx = ((idx == 1).astype(jnp.float32) - (idx == 2).astype(jnp.float32))
        fy = ((idx == 3).astype(jnp.float32) - (idx == 4).astype(jnp.float32))
        return fx * p.action_force, fy * p.action_force
    ax = uniform(-1.0, 1.0, env_seed, t, _TAG_BENCH_ACTION)
    ay = uniform(-1.0, 1.0, env_seed, t, _TAG_BENCH_ACTION + 1)
    return ax * p.action_force, ay * p.action_force


def _env_step_components(p: CartPoleParams, state, t):
    """One full env.step on component arrays. state is the 13-tuple
    (x, y, z, vx, vy, vz, sx, sy, sdx, sdy, steps, episode, seed_u32);
    returns (state', obs_sum, reward)."""
    (x, y, z, vx, vy, vz, sx, sy, sdx, sdy, steps, episode, seed) = state
    fx, fy = bench_action_force(p, seed, t)
    obs_acc = jnp.zeros_like(x)
    for r in range(p.action_repeats):
        if p.push_prob_per_repeat > 0.0:
            px, py = push_xy(p, seed, episode, steps, r)
        else:
            px = py = jnp.zeros_like(x)
        for _ in range(p.steps_per_repeat):
            (x, y, z, vx, vy, vz, sx, sy, sdx, sdy) = substep_components(
                p, x, y, z, vx, vy, vz, sx, sy, sdx, sdy, fx, fy, px, py)
        obs_acc = obs_acc + frame_sum(p, x, y, z, sx, sy)

    steps = steps + 1
    done_phys, too_long = termination_components(p, x, y, sx, sy, steps)
    done = done_phys | too_long
    reward = reward_components(p, x, y, sx, sy, done_phys)

    episode = episode + done.astype(jnp.int32)
    fresh = reset_components(p, seed, episode)
    cur = (x, y, z, vx, vy, vz, sx, sy, sdx, sdy)
    sel = tuple(jnp.where(done, f, c) for f, c in zip(fresh, cur))
    steps = jnp.where(done, 0, steps)
    return sel + (steps, episode, seed), obs_acc, reward


def _components(state: EnvState):
    ph = state.phys
    return (ph.pos[:, 0], ph.pos[:, 1], ph.pos[:, 2],
            ph.vel[:, 0], ph.vel[:, 1], ph.vel[:, 2],
            ph.s[:, 0], ph.s[:, 1], ph.sd[:, 0], ph.sd[:, 1],
            state.steps, state.episode, state.env_seed)


def _from_components(state: EnvState, comps) -> EnvState:
    phys = type(state.phys)(
        pos=jnp.stack(comps[0:3], axis=-1),
        vel=jnp.stack(comps[3:6], axis=-1),
        s=jnp.stack(comps[6:8], axis=-1),
        sd=jnp.stack(comps[8:10], axis=-1))
    return EnvState(phys=phys, steps=comps[10], episode=comps[11],
                    env_seed=state.env_seed)


# --- the Triton kernel -------------------------------------------------------

def _rollout_kernel(p: CartPoleParams, num_steps: int, *refs):
    """One block of envs for all T steps. refs: 13 state blocks in,
    12 state blocks + 1 per-env checksum column out."""
    ins, outs = refs[:13], refs[13:]

    def body(t, carry):
        st, acc = carry[:-1], carry[-1]
        st, obs_sum, reward = _env_step_components(
            p, st, t.astype(jnp.uint32))
        return tuple(st) + (acc + obs_sum + reward,)

    init = tuple(r[...] for r in ins)
    out = jax.lax.fori_loop(0, num_steps, body,
                            init + (jnp.zeros_like(init[0]),))
    for o, v in zip(outs[:12], out[:12]):   # out[12] is the seed
        o[...] = v
    outs[12][...] = out[13]


def rollout_block_envs(num_envs: int) -> tuple[int, int]:
    """(block, padded batch): the power-of-two env block the kernel runs
    and the batch rounded up to a whole number of blocks. A batch
    smaller than one block runs as one smaller power-of-two block."""
    blk = min(BLOCK_ENVS, 1 << max(num_envs - 1, 0).bit_length())
    return blk, -(-num_envs // blk) * blk


def pallas_rollout(env, num_steps: int, interpret: bool = False):
    """Jitted fn: EnvState -> (EnvState, checksum) running the fused
    Triton kernel. Any batch size: the env axis is padded to a block
    multiple and sliced back."""
    p = env.params
    b = env.num_envs
    blk, bp = rollout_block_envs(b)

    spec = pl.BlockSpec((blk,), lambda i: (i,))
    f32 = jax.ShapeDtypeStruct((bp,), jnp.float32)
    i32 = jax.ShapeDtypeStruct((bp,), jnp.int32)
    call = pl.pallas_call(
        functools.partial(_rollout_kernel, p, num_steps),
        out_shape=(f32,) * 10 + (i32, i32, f32),
        grid=(bp // blk,),
        in_specs=[spec] * 13,
        out_specs=(spec,) * 13,
        backend="triton",
        compiler_params=pltriton.CompilerParams(
            num_warps=max(blk // 32, 1), num_stages=1),  # one env/thread
        interpret=interpret,
        name="cartpole_rollout",
    )

    def run(state: EnvState):
        comps = [jnp.pad(c, (0, bp - b)) for c in _components(state)]
        out = call(*comps)
        new_state = _from_components(state, [o[:b] for o in out[:12]])
        return new_state, jnp.sum(out[12][:b])

    return jax.jit(run, donate_argnums=(0,))


# --- XLA twin ------------------------------------------------------------------

def reference_rollout(env, num_steps: int):
    """The same benchmark semantics through the public env.step path:
    identical action stream, checksum = sum(pre-reset obs frames) +
    sum(rewards). Used to prove kernel/XLA-path equivalence."""
    p = env.params

    def run(state: EnvState):
        def body(carry, t):
            st, acc = carry
            fx, fy = bench_action_force(p, st.env_seed, t.astype(jnp.uint32))
            if p.discrete_actions:
                # Invert the force map back to the discrete action index.
                a = (1 * (fx > 0) + 2 * (fx < 0) + 3 * (fy > 0)
                     + 4 * (fy < 0)).astype(jnp.int32)
            else:
                a = jnp.stack([fx, fy], -1) / p.action_force
            st, _, reward, _, info = env.step(st, a)
            frames = info["terminal_obs"].reshape(
                (env.num_envs, p.action_repeats, 14))
            acc = acc + jnp.sum(frames) + jnp.sum(reward)
            return (st, acc), None

        (state, acc), _ = jax.lax.scan(
            body, (state, jnp.float32(0.0)),
            jnp.arange(num_steps, dtype=jnp.int32))
        return state, acc

    return jax.jit(run, donate_argnums=(0,))
