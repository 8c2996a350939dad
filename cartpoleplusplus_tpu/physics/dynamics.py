"""Closed-form forward dynamics of the 3D cart-pole — the batched
replacement for Bullet's `stepSimulation` constraint/contact solve.

Reference counterpart: the Bullet C++ rigid-body pipeline invoked by
`pybullet.stepSimulation()` from `bullet_cartpole.py` in the reference
(semi-implicit Euler integration + joint constraint solve + ground contact,
per BASELINE.json:5).

Derivation (reduced coordinates — exact, no iterative solver):
  q = (x, y, z, ux, uy), the cart COM position and the horizontal components
  s = (ux, uy) of the pole's unit direction u (uz = w = sqrt(1-|s|^2) > 0).
  With Mt = M+m, J = m*l, K = m*l^2 + I_p, the Lagrangian is

    T = 1/2 Mt |v|^2 + J (v . u3d) + 1/2 K |u3d|^2,   u3d = (sdx, sdy, -sigma/w)
    V = Mt g z + m g l w,            sigma = s . sd

  Euler–Lagrange gives  M(q) qdd + c(q, qd) = Q  with

    M = [[Mt, 0, 0, J, 0],
         [0, Mt, 0, 0, J],
         [0, 0, Mt, -J ux/w, -J uy/w],
         [J, 0, -J ux/w, K(1+ux^2/w^2), K ux uy/w^2],
         [0, J, -J uy/w, K ux uy/w^2, K(1+uy^2/w^2)]]
    c_xy = 0
    c_z  = Mt g - J (|sd|^2/w + sigma^2/w^3)
    c_s  = K s (|sd|^2/w^2 + sigma^2/w^4) - m g l s / w

  Eliminating the (diagonal) cart block, the 2x2 Schur complement is
  (K - J^2/Mt)(I + s s^T / w^2), whose inverse is (I - s s^T)/(K - J^2/Mt)
  exactly (Sherman–Morrison with |s|^2 + w^2 = 1). The whole forward
  dynamics is therefore ~60 branch-free flops per env per substep — no
  matrix factorization, no iteration, ideal for wide SIMD hardware.

  Correctness is machine-checked against an independent autodiff-Lagrangian
  implementation (physics/lagrangian.py) in tests/test_dynamics.py, and the
  planar limit reproduces the classic textbook cart-pole equations.

All functions operate on same-shaped component arrays (scalars, (B,) or
(rows, 128) tiles) so the identical math serves the jnp scan path, the
numpy oracle (tests/oracle.py) and the Pallas fused kernel (ops/).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp

from .params import CartPoleParams


class PhysState(NamedTuple):
    """Batched physical state. All leaves share leading batch dims.

    pos: (..., 3) cart COM (x, y, z)
    vel: (..., 3) cart velocity
    s:   (..., 2) pole direction horizontal components (ux, uy)
    sd:  (..., 2) d/dt s
    """

    pos: jax.Array
    vel: jax.Array
    s: jax.Array
    sd: jax.Array


def rest_state(p: CartPoleParams, batch_shape=()) -> PhysState:
    """Upright equilibrium: cart at origin resting on the ground plane."""
    z0 = p.cart_rest_z - p.rest_penetration
    pos = jnp.zeros(batch_shape + (3,), jnp.float32).at[..., 2].set(z0)
    return PhysState(
        pos=pos,
        vel=jnp.zeros(batch_shape + (3,), jnp.float32),
        s=jnp.zeros(batch_shape + (2,), jnp.float32),
        sd=jnp.zeros(batch_shape + (2,), jnp.float32),
    )


def pole_w(p: CartPoleParams, sx, sy):
    """uz component, clamped away from the horizontal singularity."""
    return jnp.sqrt(jnp.maximum(1.0 - sx * sx - sy * sy, p.w_min * p.w_min))


def contact_normal_force(p: CartPoleParams, z, vz):
    """Penalty ground contact on the cart: stiff spring + damper, no adhesion."""
    pen = p.cart_rest_z - z
    in_contact = pen > 0.0
    f = p.contact_stiffness * pen - p.contact_damping * vz
    return jnp.where(in_contact, jnp.maximum(f, 0.0), 0.0)


def generalized_forces(p: CartPoleParams, z, vx, vy, vz, sdx, sdy,
                       fx, fy, push_x, push_y):
    """Assemble Q = (Qx, Qy, Qz, Qsx, Qsy).

    fx, fy: actuation force on the cart (mapped from the agent action).
    push_x, push_y: random horizontal perturbation force on the pole COM
    (reference: `pybullet.applyExternalForce` on the pole body).
    """
    fn = contact_normal_force(p, z, vz)
    qx = fx + push_x
    qy = fy + push_y
    # Coefficients are compile-time constants: zero-valued terms are gated
    # out at trace time (XLA cannot fold tanh(x)*0 under NaN semantics).
    if p.ground_friction != 0.0:
        # Smooth Coulomb friction on the cart while in contact.
        qx = qx - p.ground_friction * fn * jnp.tanh(vx / p.friction_vel_eps)
        qy = qy - p.ground_friction * fn * jnp.tanh(vy / p.friction_vel_eps)
    if p.linear_damping != 0.0:
        qx = qx - p.linear_damping * vx
        qy = qy - p.linear_damping * vy
    qz = fn
    # Horizontal push at the pole COM -> generalized tilt force l * push.
    qsx = p.half_length * push_x
    qsy = p.half_length * push_y
    if p.angular_damping != 0.0:
        qsx = qsx - p.angular_damping * sdx
        qsy = qsy - p.angular_damping * sdy
    return qx, qy, qz, qsx, qsy


def solve_accel(p: CartPoleParams, sx, sy, sdx, sdy, qx, qy, qz, qsx, qsy):
    """Closed-form M(q)^{-1} (Q - c): returns (ax, ay, az, asx, asy)."""
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    mgl = p.pole_mass * p.gravity * p.half_length
    w2 = jnp.maximum(1.0 - sx * sx - sy * sy, p.w_min * p.w_min)
    inv_w = jax.lax.rsqrt(w2)   # one rsqrt replaces sqrt + divide
    w = w2 * inv_w
    inv_w2 = inv_w * inv_w
    sigma = sx * sdx + sy * sdy
    sd2 = sdx * sdx + sdy * sdy
    # Bias terms.
    curv = sd2 * inv_w2 + sigma * sigma * inv_w2 * inv_w2  # |sd|^2/w^2 + sig^2/w^4
    c_z = mt * p.gravity - jc * (sd2 + sigma * sigma * inv_w2) * inv_w
    c_common = kg * curv - mgl * inv_w  # c_s = c_common * s
    # Reduced RHS for the tilt block: Q_s - c_s - B^T (Q_v - c_v) / Mt.
    rv_x = qx
    rv_y = qy
    rv_z = qz - c_z
    rhs_x = qsx - c_common * sx - (jc * rv_x - jc * sx * inv_w * rv_z) / mt
    rhs_y = qsy - c_common * sy - (jc * rv_y - jc * sy * inv_w * rv_z) / mt
    # Schur inverse is (I - s s^T) / (K - J^2/Mt) exactly.
    dot = sx * rhs_x + sy * rhs_y
    inv_den = 1.0 / p.schur_denom
    asx = (rhs_x - sx * dot) * inv_den
    asy = (rhs_y - sy * dot) * inv_den
    # Back-substitute the cart accelerations.
    ax = (rv_x - jc * asx) / mt
    ay = (rv_y - jc * asy) / mt
    az = (rv_z + jc * (sx * asx + sy * asy) * inv_w) / mt
    return ax, ay, az, asx, asy


def accel_components(p: CartPoleParams, z, vx, vy, vz, sx, sy, sdx, sdy,
                     fx, fy, push_x, push_y):
    """Force assembly + solve, on raw component arrays."""
    q = generalized_forces(p, z, vx, vy, vz, sdx, sdy, fx, fy, push_x, push_y)
    return solve_accel(p, sx, sy, sdx, sdy, *q)


def substep_components(p: CartPoleParams, x, y, z, vx, vy, vz, sx, sy, sdx, sdy,
                       fx, fy, push_x, push_y):
    """One semi-implicit Euler substep on component arrays.

    v_{t+1} = v_t + dt * a(q_t, v_t);  q_{t+1} = q_t + dt * v_{t+1}
    (matches Bullet's integrator family per BASELINE.json:5).
    """
    ax, ay, az, asx, asy = accel_components(
        p, z, vx, vy, vz, sx, sy, sdx, sdy, fx, fy, push_x, push_y)
    dt = p.dt
    vm = p.vel_max
    # Velocity clamp: a pure NaN-guard. Reachable trajectories stay orders
    # of magnitude below vel_max; without it, unphysical states pinned at
    # the |s| clamp with huge rates overflow fp32 within a few substeps.
    vx = jnp.clip(vx + dt * ax, -vm, vm)
    vy = jnp.clip(vy + dt * ay, -vm, vm)
    vz = jnp.clip(vz + dt * az, -vm, vm)
    sdx = jnp.clip(sdx + dt * asx, -vm, vm)
    sdy = jnp.clip(sdy + dt * asy, -vm, vm)
    x = x + dt * vx
    y = y + dt * vy
    z = z + dt * vz
    sx = sx + dt * sdx
    sy = sy + dt * sdy
    # Keep s inside the chart (|s| < 1). The clamp only activates far beyond
    # the termination tilt, so trajectories that matter are unaffected.
    n = jnp.sqrt(sx * sx + sy * sy)
    scale = jnp.minimum(1.0, p.s_norm_max / jnp.maximum(n, 1e-9))
    sx = sx * scale
    sy = sy * scale
    return x, y, z, vx, vy, vz, sx, sy, sdx, sdy


def substep(p: CartPoleParams, st: PhysState, force_xy, push_xy) -> PhysState:
    """Pytree wrapper over substep_components. force_xy/push_xy: (..., 2)."""
    x, y, z, vx, vy, vz, sx, sy, sdx, sdy = substep_components(
        p,
        st.pos[..., 0], st.pos[..., 1], st.pos[..., 2],
        st.vel[..., 0], st.vel[..., 1], st.vel[..., 2],
        st.s[..., 0], st.s[..., 1], st.sd[..., 0], st.sd[..., 1],
        force_xy[..., 0], force_xy[..., 1],
        push_xy[..., 0], push_xy[..., 1],
    )
    return PhysState(
        pos=jnp.stack([x, y, z], axis=-1),
        vel=jnp.stack([vx, vy, vz], axis=-1),
        s=jnp.stack([sx, sy], axis=-1),
        sd=jnp.stack([sdx, sdy], axis=-1),
    )


def run_substeps(p: CartPoleParams, st: PhysState, force_xy, push_xy,
                 n: int, unroll: int = 1) -> PhysState:
    """n substeps with constant applied forces (one action repeat).

    n is static. Uses lax.scan (the body is compiled once — XLA compile time
    of a fully unrolled chain grows superlinearly) with a tunable `unroll`
    for the hot path. Either way the whole repeat runs on-device with no
    per-substep dispatch — this deletes the reference's ~15 Python<->C++
    crossings per env-step.
    """
    if n == 1:
        return substep(p, st, force_xy, push_xy)

    def body(carry, _):
        return substep(p, carry, force_xy, push_xy), None

    st, _ = jax.lax.scan(body, st, None, length=n, unroll=unroll)
    return st


def apply_push_impulse(p: CartPoleParams, st: PhysState, push_xy,
                       tau: float) -> PhysState:
    """Exact generalized impulse response to a horizontal pole push.

    The reference applies a random force to the pole for a few substeps
    right after reset; an impulse F*tau through the mass matrix is the
    equivalent momentum transfer. At arbitrary pose the x/ux and y/uy pairs
    couple through the 2x2 block [[Mt, J], [J, K]] per axis at s=0; we apply
    it at the (upright) reset pose where this is exact.
    """
    jx = push_xy[..., 0] * tau
    jy = push_xy[..., 1] * tau
    mt, jc, kg = p.total_mass, p.coupling, p.pole_gen_inertia
    l = p.half_length
    det = mt * kg - jc * jc
    # [dv; dsd] = [[Mt, J],[J, K]]^-1 [j; l j]
    dv_x = (kg * jx - jc * l * jx) / det
    dsd_x = (-jc * jx + mt * l * jx) / det
    dv_y = (kg * jy - jc * l * jy) / det
    dsd_y = (-jc * jy + mt * l * jy) / det
    vel = st.vel.at[..., 0].add(dv_x).at[..., 1].add(dv_y)
    sd = st.sd.at[..., 0].add(dsd_x).at[..., 1].add(dsd_y)
    return st._replace(vel=vel, sd=sd)


def total_energy(p: CartPoleParams, st: PhysState):
    """T + V (including the contact spring energy) — for conservation tests."""
    sx, sy = st.s[..., 0], st.s[..., 1]
    sdx, sdy = st.sd[..., 0], st.sd[..., 1]
    w = pole_w(p, sx, sy)
    udz = -(sx * sdx + sy * sdy) / w
    u3 = jnp.stack([sdx, sdy, udz], axis=-1)
    v = st.vel
    t = (0.5 * p.total_mass * jnp.sum(v * v, -1)
         + p.coupling * jnp.sum(v * u3, -1)
         + 0.5 * p.pole_gen_inertia * jnp.sum(u3 * u3, -1))
    pen = jnp.maximum(p.cart_rest_z - st.pos[..., 2], 0.0)
    vpot = (p.total_mass * p.gravity * st.pos[..., 2]
            + p.pole_mass * p.gravity * p.half_length * w
            + 0.5 * p.contact_stiffness * pen * pen)
    return t + vpot
