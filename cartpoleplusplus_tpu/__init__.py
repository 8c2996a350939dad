"""cartpoleplusplus_tpu — a vectorized 3D cart-pole RL framework in JAX.

A from-scratch rebuild of the capabilities of rebcabin/cartpoleplusplus
(PyBullet 3D cart-pole + DDPG/DQN/NAF/LRPG trainers) in idiomatic
JAX/XLA/Pallas: batched closed-form rigid-body stepping under jit, masked
auto-reset, device-resident lax.scan rollouts, on-device agents, and env
batches sharded over GPU meshes via XLA collectives.
"""

__version__ = "0.1.0"

from . import env, physics
from .env import CartPole3D, EnvState
from .physics import CartPoleParams, continuous_params

__all__ = [
    "physics",
    "env",
    "agents",
    "models",
    "dist",
    "CartPole3D",
    "EnvState",
    "CartPoleParams",
    "continuous_params",
    "__version__",
]


def __getattr__(name):
    # Lazy subpackage imports: `import cartpoleplusplus_tpu` stays light
    # (optax only loads when the agents/models/dist layers are used).
    if name in ("agents", "models", "dist"):
        import importlib

        return importlib.import_module(f".{name}", __name__)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
