"""Componentwise env math — THE single source shared by the XLA env path
and the fused rollout kernel.

Every function here operates on same-shaped component arrays (scalars,
(B,) vectors or per-program env blocks) using only elementwise jnp ops,
so the identical expressions serve three consumers:
  * env/cartpole.py (stacks components into pytrees/observations),
  * ops/fused_rollout.py (keeps components in registers in-kernel),
  * tests/oracle.py's numpy mirror (same formulas, float64 loop).
Keeping reset / push / observation / termination / reward logic in ONE
module is what makes "kernel == env.step" a structural property rather
than a test-enforced coincidence (tests/test_ops.py still enforces it).

Kernel constraint: constants must be numpy scalars (a Pallas kernel may
not capture device arrays).
"""

from __future__ import annotations

import jax.numpy as jnp

from ..physics import CartPoleParams
from ..physics.dynamics import pole_w
from ..utils.prng import uniform
from ..utils.quaternion import pole_quaternion

# Stream-separation tags for the counter-based PRNG (utils/prng.py).
TAG_RESET_ANGLE = 0x11
TAG_RESET_MAG = 0x12
TAG_PUSH_GATE = 0x21
TAG_PUSH_ANGLE = 0x22
TAG_PUSH_MAG = 0x23


# --- randomness -------------------------------------------------------------

def reset_push_xy(p: CartPoleParams, env_seed, episode):
    """Initial push force components: direction uniform on the circle,
    magnitude uniform in [0.2, 1] * initial_push_force. Pure function of
    (env_seed, episode). Reference: the random `applyExternalForce` after
    reset in `bullet_cartpole.py`."""
    ang = uniform(0.0, 2.0 * jnp.pi, env_seed, episode, TAG_RESET_ANGLE)
    mag = uniform(0.2, 1.0, env_seed, episode, TAG_RESET_MAG) \
        * p.initial_push_force
    return mag * jnp.cos(ang), mag * jnp.sin(ang)


def push_xy(p: CartPoleParams, env_seed, episode, steps, repeat):
    """Mid-episode push force for (env, step, repeat): zero with prob
    1 - push_prob_per_repeat, else uniform direction / magnitude."""
    gate = uniform(0.0, 1.0, env_seed, episode, steps, repeat, TAG_PUSH_GATE)
    ang = uniform(0.0, 2.0 * jnp.pi, env_seed, episode, steps, repeat,
                  TAG_PUSH_ANGLE)
    mag = uniform(0.0, 1.0, env_seed, episode, steps, repeat, TAG_PUSH_MAG) \
        * p.push_force
    on = jnp.where(gate < p.push_prob_per_repeat, 1.0, 0.0)
    return on * mag * jnp.cos(ang), on * mag * jnp.sin(ang)


# --- reset ------------------------------------------------------------------

def reset_components(p: CartPoleParams, env_seed, episode):
    """Fresh-episode state as the 10 components
    (x, y, z, vx, vy, vz, sx, sy, sdx, sdy): upright rest pose + the exact
    generalized impulse response to the initial push (the equivalent
    momentum transfer for the reference's force-over-a-few-substeps;
    physics/dynamics.py::apply_push_impulse is the pytree twin)."""
    px, py = reset_push_xy(p, env_seed, episode)
    tau = p.initial_push_duration
    jx = px * tau
    jy = py * tau
    mt, jc, kg, l = p.total_mass, p.coupling, p.pole_gen_inertia, p.half_length
    det = mt * kg - jc * jc
    dv_x = (kg - jc * l) * jx / det
    dsd_x = (mt * l - jc) * jx / det
    dv_y = (kg - jc * l) * jy / det
    dsd_y = (mt * l - jc) * jy / det
    zero = jnp.zeros_like(jx)
    z0 = jnp.full_like(jx, p.cart_rest_z - p.rest_penetration)
    return (zero, zero, z0, dv_x, dv_y, zero, zero, zero, dsd_x, dsd_y)


# --- observation ------------------------------------------------------------

def frame_components(p: CartPoleParams, x, y, z, sx, sy):
    """The 14 pose-frame components (cart pos3 + identity quat4, pole COM
    pos3 + quat4, pybullet (x,y,z,w) order) — the reference's
    `getBasePositionAndOrientation` snapshot per repeat."""
    w = pole_w(p, sx, sy)
    qx, qy, qz, qw = pole_quaternion(sx, sy, w)
    zero = jnp.zeros_like(sx)
    one = jnp.ones_like(sx)
    l = p.half_length
    return (x, y, z, zero, zero, zero, one,
            x + l * sx, y + l * sy, z + p.pivot_height + l * w,
            qx, qy, qz, qw)


def frame_sum(p: CartPoleParams, x, y, z, sx, sy):
    """Sum of all 14 frame components — forces the full obs computation
    while reducing on the fly (benchmark checksum; guards against DCE)."""
    comps = frame_components(p, x, y, z, sx, sy)
    acc = comps[0]
    for c in comps[1:]:
        acc = acc + c
    return acc


# --- termination / reward ---------------------------------------------------

def termination_components(p: CartPoleParams, x, y, sx, sy, steps):
    """(tilted-or-oob, too_long) boolean components; steps is the
    POST-increment episode step count."""
    s2 = sx * sx + sy * sy
    done_phys = (s2 > p.tilt_s2_limit) | (jnp.abs(x) > p.pos_limit) | (
        jnp.abs(y) > p.pos_limit)
    return done_phys, steps >= p.max_episode_steps


def reward_components(p: CartPoleParams, x, y, sx, sy, done_physical):
    """+1 per surviving step, or the shaped angle/position reward of the
    continuous variant (BASELINE config 3)."""
    if not p.reward_shaped:
        return jnp.where(done_physical, 0.0, 1.0)
    s2 = sx * sx + sy * sy
    d2 = x * x + y * y
    shaped = (1.0 - 0.5 * s2 / p.tilt_s2_limit
              - 0.5 * d2 / (p.pos_limit * p.pos_limit))
    return jnp.where(done_physical, 0.0, jnp.maximum(shaped, 0.0))
