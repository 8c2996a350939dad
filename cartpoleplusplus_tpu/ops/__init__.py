"""Hot-path kernels. `best_rollout` picks the env rollout for the current
backend: on a GPU the fused Triton kernel (ops/fused_rollout.py — the
native equivalent of Bullet's C++ `stepSimulation` loop), elsewhere the
XLA scan over env.step. The jnp path is the always-on correctness twin
(tests/test_ops.py asserts state parity between the two)."""

import jax

from .fused_rollout import pallas_rollout, reference_rollout


def kernel_covers(env) -> bool:
    """Whether the fused kernel implements this env's step: it hard-codes
    pose-stack observations and masked auto-reset."""
    return env.obs_mode == "pose_stack" and env.auto_reset


def best_rollout(env, num_steps: int):
    """Returns (jitted rollout fn state->(state, checksum), impl name)."""
    if jax.default_backend() == "gpu" and kernel_covers(env):
        return pallas_rollout(env, num_steps), "triton_fused"
    return reference_rollout(env, num_steps), "xla_scan"


__all__ = ["best_rollout", "kernel_covers", "pallas_rollout",
           "reference_rollout"]
