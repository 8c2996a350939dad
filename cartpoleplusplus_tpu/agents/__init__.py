"""Agents / trainers — the framework's user-facing API layer.

Reference counterpart: the per-algorithm trainer scripts at the root of
rebcabin/cartpoleplusplus — `random_action_agent.py`, `lrpg_cartpole.py`,
`dqn_cartpole.py`, `naf_cartpole.py`, `ddpg_cartpole.py` (flagship), each
owning its own train loop, replay memory and target networks (SURVEY.md
§2a/§3.3; reference mount empty this session).

Redesign: every agent is a pair of pure functions
(`init(key) -> TrainState`, `train_step(state, env_state) -> ...`) where one
`train_step` fuses rollout (lax.scan over the sharded env batch), replay
insertion, and gradient/target updates into a single XLA program — the
reference's per-step Python<->TF<->Bullet round-trips become zero.
"""

from .replay import ReplayBuffer, ReplayState
from .random_agent import RandomAgent
from .ddpg import DDPG, DDPGConfig
from .dqn import DQN, DQNConfig
from .naf import NAF, NAFConfig
from .lrpg import LRPG, LRPGConfig

__all__ = [
    "ReplayBuffer",
    "ReplayState",
    "RandomAgent",
    "DDPG",
    "DDPGConfig",
    "DQN",
    "DQNConfig",
    "NAF",
    "NAFConfig",
    "LRPG",
    "LRPGConfig",
]
