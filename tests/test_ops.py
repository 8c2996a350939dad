"""Fused-rollout kernel parity tests (Triton kernel in interpret mode on CPU).

SURVEY.md §7 stage 3: the kernel must be the bitwise(-ish) twin of the
public env.step path — same physics, same counter-PRNG streams, same
termination/reset logic. These tests run the kernel in the Pallas
interpreter against `reference_rollout` (XLA scan over env.step) with the
identical benchmark action stream. chip_smoke.py runs the same comparison
on the GPU with the compiled kernel.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu.ops import best_rollout, kernel_covers
from cartpoleplusplus_tpu.ops.fused_rollout import (
    pallas_rollout,
    reference_rollout,
    rollout_block_envs,
)
from cartpoleplusplus_tpu.physics.params import continuous_params

B = 512     # four 128-env programs


def _run_both(params, num_steps, num_envs=B):
    env = CartPole3D(params, num_envs=num_envs)
    state0, _ = jax.jit(env.reset)(7)
    # Separate copies: both paths donate their input.
    state_a = jax.tree.map(jnp.copy, state0)
    state_b = jax.tree.map(jnp.copy, state0)
    k_state, k_acc = pallas_rollout(env, num_steps, interpret=True)(state_a)
    r_state, r_acc = reference_rollout(env, num_steps)(state_b)
    return k_state, float(k_acc), r_state, float(r_acc)


def _assert_twins(k_state, k_acc, r_state, r_acc):
    # Physical state: identical math modulo association order -> tight rtol.
    np.testing.assert_allclose(np.asarray(k_state.phys.pos),
                               np.asarray(r_state.phys.pos),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(k_state.phys.s),
                               np.asarray(r_state.phys.s),
                               rtol=2e-5, atol=2e-5)
    np.testing.assert_allclose(np.asarray(k_state.phys.vel),
                               np.asarray(r_state.phys.vel),
                               rtol=5e-4, atol=5e-4)
    # Episode bookkeeping must be EXACT (resets happened at the same steps).
    np.testing.assert_array_equal(np.asarray(k_state.steps),
                                  np.asarray(r_state.steps))
    np.testing.assert_array_equal(np.asarray(k_state.episode),
                                  np.asarray(r_state.episode))
    np.testing.assert_array_equal(np.asarray(k_state.env_seed),
                                  np.asarray(r_state.env_seed))
    # Checksum (all obs components + rewards) agrees to fp32 reduction tol.
    assert abs(k_acc - r_acc) / max(abs(r_acc), 1.0) < 1e-4


@pytest.mark.parametrize("params", [
    CartPoleParams(),                      # discrete, +1 reward
    continuous_params(),                   # continuous, pushes, shaped
], ids=["discrete", "continuous"])
def test_kernel_matches_env_step(params):
    _assert_twins(*_run_both(params, num_steps=25))


def test_kernel_episodes_progress():
    """Sanity: over 60 steps of random actions many envs terminate and
    restart (auto-reset inside the kernel works)."""
    k_state, _, _, _ = _run_both(CartPoleParams(), num_steps=60)
    assert int(jnp.sum(k_state.episode)) > B // 4


def test_non_multiple_batch_matches_reference():
    """1000 envs is not a multiple of the 128-env block: the wrapper pads
    to 1024, runs 8 programs and slices the padding off before the
    checksum."""
    _assert_twins(*_run_both(continuous_params(), num_steps=12,
                             num_envs=1000))


def test_block_and_padding_rule():
    """128-env blocks, the batch padded up to a whole number of them; a
    batch below one block runs as one smaller power-of-two block."""
    assert rollout_block_envs(4096) == (128, 4096)
    assert rollout_block_envs(1000) == (128, 1024)
    assert rollout_block_envs(100) == (128, 128)
    assert rollout_block_envs(5) == (8, 8)


def test_best_rollout_choice():
    """The kernel is chosen only on a GPU and only for the env shapes it
    implements (pose-stack obs, masked auto-reset); the CPU test backend
    gets the XLA scan."""
    env = CartPole3D(CartPoleParams(), num_envs=16)
    assert kernel_covers(env)
    assert not kernel_covers(CartPole3D(CartPoleParams(), num_envs=16,
                                        obs_mode="state"))
    assert not kernel_covers(CartPole3D(CartPoleParams(), num_envs=16,
                                        auto_reset=False))
    _, impl = best_rollout(env, 4)
    assert impl == "xla_scan"
