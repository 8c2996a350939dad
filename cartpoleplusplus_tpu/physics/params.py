"""Static physics + environment configuration.

Reference counterpart: the URDF mass/inertia/joint definitions (`models/*.urdf`)
plus the argparse options of `bullet_cartpole.py` in rebcabin/cartpoleplusplus
(reference mount empty this session; behavioral contract from
BASELINE.json:5 — semi-implicit Euler, cart–pole pivot joint
constraint, ground-plane contact resolution, random push perturbations).

Design choice: the whole config is ONE hashable frozen dataclass so
it can be a `static_argnum` of jitted functions — every parameter becomes an
XLA compile-time constant, which lets the compiler constant-fold the dynamics
coefficients (J, K, Schur denominator, dt) straight into the fused kernel.
"""

from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class CartPoleParams:
    """All physics + episode constants for the 3D cart-pole.

    Model: a cart (box) with 3 translational DoF (x, y on the plane, z held
    by penalty ground contact) carrying a pole attached by a 2-DoF pivot
    (ball) joint at a fixed point above the cart COM. Reduced ("minimal")
    coordinates q = (x, y, z, ux, uy) where (ux, uy) are the horizontal
    components of the pole's unit direction vector u, uz = sqrt(1-ux^2-uy^2).
    This is the batched replacement for Bullet's maximal-coordinate
    iterative constraint solve: the joint constraint is exact by
    construction and the forward dynamics is a closed-form ~60-flop,
    branch-free expression (see physics/dynamics.py).
    """

    # --- rigid bodies -----------------------------------------------------
    cart_mass: float = 1.0          # kg
    pole_mass: float = 0.1          # kg
    pole_length: float = 1.0        # full rod length (m); COM at l = length/2
    gravity: float = 9.81           # m/s^2
    pivot_height: float = 0.1       # pivot above cart COM (m) (cart top face)

    # --- ground contact (cart <-> plane), penalty formulation -------------
    # Bullet resolves cart/ground contact with impulses inside
    # stepSimulation; here it is a stiff spring-damper penalty, which is
    # branch-free (relu) and unconditionally stable for semi-implicit Euler
    # at dt=1/240 (omega*dt ~= 0.28 << 2).
    cart_rest_z: float = 0.1        # cart COM height when resting (half-height)
    contact_stiffness: float = 5000.0   # N/m
    contact_damping: float = 140.0      # N.s/m  (~critical for Mt=1.1kg)
    ground_friction: float = 0.0    # smooth-Coulomb coefficient (0 = frictionless)
    friction_vel_eps: float = 0.05  # tanh regularization velocity (m/s)

    # --- damping (Bullet exposes linear/angular damping; default 0) -------
    linear_damping: float = 0.0     # N.s/m on cart xy
    angular_damping: float = 0.0    # N.m.s on pole tilt rate

    # --- integration -------------------------------------------------------
    dt: float = 1.0 / 240.0         # Bullet's default fixed timestep
    steps_per_repeat: int = 5       # physics substeps per action repeat
    action_repeats: int = 3         # repeats per env.step (obs stacked over these)

    # --- actions ------------------------------------------------------------
    action_force: float = 12.0      # N; discrete uses +-this, continuous scales it
    discrete_actions: bool = True   # 5-way (noop/+x/-x/+y/-y) vs Box(2)

    # --- random perturbations ------------------------------------------------
    # Initial push: the reference applies a random horizontal force to the
    # pole for a few substeps after reset. Equivalently (F * tau impulse) we
    # apply the exact generalized impulse response through the mass matrix
    # at the upright pose — see physics/dynamics.py:apply_push_impulse.
    initial_push_force: float = 1.2     # N (max magnitude, uniform in disc)
    initial_push_duration: float = 5.0 / 240.0  # effective tau (s)
    # Mid-episode pushes (continuous variant): per-repeat probability of a
    # random horizontal force on the pole COM held for that repeat's substeps.
    push_prob_per_repeat: float = 0.0
    push_force: float = 1.2         # N

    # --- termination / reward ---------------------------------------------
    tilt_limit: float = 0.3         # rad; done when pole tilt angle exceeds
    pos_limit: float = 2.4          # m;   done when |x| or |y| exceeds
    max_episode_steps: int = 200
    reward_shaped: bool = False     # continuous variant: shaped reward

    # --- numerics -----------------------------------------------------------
    w_min: float = 0.05             # clamp uz >= w_min (far outside tilt_limit)
    s_norm_max: float = 0.995       # renormalize s if |s| exceeds
    vel_max: float = 100.0          # NaN-guard clamp on velocities (m/s, 1/s)

    # ----- derived (computed, not fields) ----------------------------------
    @property
    def half_length(self) -> float:
        return 0.5 * self.pole_length

    @property
    def pole_inertia(self) -> float:
        """Thin rod about COM, perpendicular axis: m L^2 / 12."""
        return self.pole_mass * self.pole_length**2 / 12.0

    @property
    def total_mass(self) -> float:
        return self.cart_mass + self.pole_mass

    @property
    def coupling(self) -> float:
        """J = m*l : cart<->pole inertial coupling."""
        return self.pole_mass * self.half_length

    @property
    def pole_gen_inertia(self) -> float:
        """K = m*l^2 + I_p : generalized pole inertia about the pivot."""
        return self.pole_mass * self.half_length**2 + self.pole_inertia

    @property
    def schur_denom(self) -> float:
        """K - J^2/Mt > 0 : the (scalar) Schur complement of the mass matrix."""
        return self.pole_gen_inertia - self.coupling**2 / self.total_mass

    @property
    def rest_penetration(self) -> float:
        """Static contact penetration: k*d = Mt*g."""
        return self.total_mass * self.gravity / self.contact_stiffness

    @property
    def tilt_s2_limit(self) -> float:
        """|s|^2 threshold equivalent to the tilt-angle limit."""
        return math.sin(self.tilt_limit) ** 2

    @property
    def substeps_per_step(self) -> int:
        return self.steps_per_repeat * self.action_repeats

    def replace(self, **kw) -> "CartPoleParams":
        return dataclasses.replace(self, **kw)


# Preset matching the continuous-action benchmark config
# (BASELINE.json:9 — "continuous-action variant with random push
# perturbations (reward-shaped angle/position termination)").
def continuous_params(**kw) -> CartPoleParams:
    base = dict(
        discrete_actions=False,
        reward_shaped=True,
        push_prob_per_repeat=0.05,
    )
    base.update(kw)
    return CartPoleParams(**base)
