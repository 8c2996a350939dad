"""Single-env CPU oracle: plain numpy, loop-per-substep, maximally readable.

This is the parity reference prescribed by BASELINE.json:7
("single-env discrete-action low-dim-state 3D cartpole episode, fixed seed
(CPU reference)") and SURVEY.md §4: the jitted batched device path must match
this implementation per step to float tolerance.

Randomness is injected (pre-drawn push vectors), so the oracle itself is
deterministic pure numpy; the test harness reproduces the env's draws via
the public helpers cartpoleplusplus_tpu.env.{reset,push}_randomness.

The physics here follows the same derivation as physics/dynamics.py but is
written independently in scalar form with explicit loops — see that module's
docstring for the equations of motion and their two further cross-checks
(autodiff Lagrangian, textbook planar limit).
"""

from __future__ import annotations

import math

import numpy as np

ACTION_DIRS = [(0.0, 0.0), (1.0, 0.0), (-1.0, 0.0), (0.0, 1.0), (0.0, -1.0)]


class OracleCartPole3D:
    """One env, numpy float32, mirrors CartPole3D(auto_reset=False)."""

    def __init__(self, p, init_impulse_xy, pushes=None):
        """p: CartPoleParams. init_impulse_xy: (2,) push impulse force (N).
        pushes: optional dict {(step, repeat): (px, py)} of mid-episode
        push forces; missing entries mean no push."""
        self.p = p
        self.init_impulse = np.asarray(init_impulse_xy, np.float64)
        self.pushes = pushes or {}

    # --- physics ------------------------------------------------------------
    def _accel(self, st, fx, fy, px, py):
        p = self.p
        x, y, z, vx, vy, vz, sx, sy, sdx, sdy = st
        mt = p.cart_mass + p.pole_mass
        jc = p.pole_mass * (p.pole_length / 2.0)
        ip = p.pole_mass * p.pole_length**2 / 12.0
        kg = p.pole_mass * (p.pole_length / 2.0) ** 2 + ip
        l = p.pole_length / 2.0
        g = p.gravity
        w = math.sqrt(max(1.0 - sx * sx - sy * sy, p.w_min * p.w_min))
        sigma = sx * sdx + sy * sdy
        sd2 = sdx * sdx + sdy * sdy

        # ground contact (penalty) + friction
        pen = p.cart_rest_z - z
        if pen > 0.0:
            fn = max(p.contact_stiffness * pen - p.contact_damping * vz, 0.0)
        else:
            fn = 0.0
        fric_x = p.ground_friction * fn * math.tanh(vx / p.friction_vel_eps)
        fric_y = p.ground_friction * fn * math.tanh(vy / p.friction_vel_eps)

        qx = fx + px - fric_x - p.linear_damping * vx
        qy = fy + py - fric_y - p.linear_damping * vy
        qz = fn
        qsx = l * px - p.angular_damping * sdx
        qsy = l * py - p.angular_damping * sdy

        # bias
        c_z = mt * g - jc * (sd2 + sigma * sigma / w**2) / w
        c_common = kg * (sd2 / w**2 + sigma * sigma / w**4) - p.pole_mass * g * l / w

        rv_x, rv_y, rv_z = qx, qy, qz - c_z
        rhs_x = qsx - c_common * sx - (jc * rv_x - jc * sx / w * rv_z) / mt
        rhs_y = qsy - c_common * sy - (jc * rv_y - jc * sy / w * rv_z) / mt
        den = kg - jc * jc / mt
        dot = sx * rhs_x + sy * rhs_y
        asx = (rhs_x - sx * dot) / den
        asy = (rhs_y - sy * dot) / den
        ax = (rv_x - jc * asx) / mt
        ay = (rv_y - jc * asy) / mt
        az = (rv_z + jc * (sx * asx + sy * asy) / w) / mt
        return ax, ay, az, asx, asy

    def _substep(self, st, fx, fy, px, py):
        p = self.p
        ax, ay, az, asx, asy = self._accel(st, fx, fy, px, py)
        x, y, z, vx, vy, vz, sx, sy, sdx, sdy = st
        dt, vm = p.dt, p.vel_max
        vx = np.clip(vx + dt * ax, -vm, vm)
        vy = np.clip(vy + dt * ay, -vm, vm)
        vz = np.clip(vz + dt * az, -vm, vm)
        sdx = np.clip(sdx + dt * asx, -vm, vm)
        sdy = np.clip(sdy + dt * asy, -vm, vm)
        x, y, z = x + dt * vx, y + dt * vy, z + dt * vz
        sx, sy = sx + dt * sdx, sy + dt * sdy
        n = math.sqrt(sx * sx + sy * sy)
        scale = min(1.0, p.s_norm_max / max(n, 1e-9))
        return [x, y, z, vx, vy, vz, sx * scale, sy * scale, sdx, sdy]

    # --- episode ------------------------------------------------------------
    def reset(self):
        p = self.p
        z0 = p.cart_rest_z - (p.cart_mass + p.pole_mass) * p.gravity / p.contact_stiffness
        self.st = [0.0, 0.0, z0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0, 0.0]
        # generalized impulse response at the upright pose (dynamics.py)
        mt = p.cart_mass + p.pole_mass
        jc = p.pole_mass * p.pole_length / 2.0
        ip = p.pole_mass * p.pole_length**2 / 12.0
        kg = p.pole_mass * (p.pole_length / 2.0) ** 2 + ip
        l = p.pole_length / 2.0
        det = mt * kg - jc * jc
        tau = p.initial_push_duration
        for axis in (0, 1):
            j = self.init_impulse[axis] * tau
            self.st[3 + axis] += (kg * j - jc * l * j) / det     # vx / vy
            self.st[8 + axis] += (-jc * j + mt * l * j) / det    # sdx / sdy
        self.steps = 0
        return self._obs([self._frame()] * p.action_repeats)

    def _frame(self):
        p = self.p
        x, y, z, _, _, _, sx, sy, _, _ = self.st
        w = math.sqrt(max(1.0 - sx * sx - sy * sy, p.w_min * p.w_min))
        l = p.pole_length / 2.0
        inv = 1.0 / math.sqrt(2.0 * (1.0 + w))
        return [
            x, y, z, 0.0, 0.0, 0.0, 1.0,                        # cart pose
            x + l * sx, y + l * sy, z + p.pivot_height + l * w,  # pole COM
            -sy * inv, sx * inv, 0.0, math.sqrt((1.0 + w) / 2.0),
        ]

    def _obs(self, frames):
        return np.asarray([v for f in frames for v in f], np.float64)

    def step(self, action):
        p = self.p
        if p.discrete_actions:
            dx, dy = ACTION_DIRS[int(action)]
            fx, fy = dx * p.action_force, dy * p.action_force
        else:
            fx = float(np.clip(action[0], -1, 1)) * p.action_force
            fy = float(np.clip(action[1], -1, 1)) * p.action_force

        frames = []
        for r in range(p.action_repeats):
            px, py = self.pushes.get((self.steps, r), (0.0, 0.0))
            for _ in range(p.steps_per_repeat):
                self.st = self._substep(self.st, fx, fy, px, py)
            frames.append(self._frame())

        self.steps += 1
        x, y = self.st[0], self.st[1]
        sx, sy = self.st[6], self.st[7]
        s2 = sx * sx + sy * sy
        tilted = s2 > math.sin(p.tilt_limit) ** 2
        oob = abs(x) > p.pos_limit or abs(y) > p.pos_limit
        too_long = self.steps >= p.max_episode_steps
        done_physical = tilted or oob
        done = done_physical or too_long
        if not p.reward_shaped:
            reward = 0.0 if done_physical else 1.0
        else:
            shaped = (1.0 - 0.5 * s2 / math.sin(p.tilt_limit) ** 2
                      - 0.5 * (x * x + y * y) / p.pos_limit**2)
            reward = 0.0 if done_physical else max(shaped, 0.0)
        return self._obs(frames), reward, done, {
            "tilted": tilted, "out_of_bounds": oob}
