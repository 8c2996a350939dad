"""Network definitions (plain jax.numpy) for the agents.

Reference counterpart: the per-trainer TensorFlow graph builders in
rebcabin/cartpoleplusplus — `base_network.py` (shared conv/MLP/batch-norm
helpers + target-network var copying) and the actor/critic/Q/NAF graphs in
`ddpg_cartpole.py`, `dqn_cartpole.py`, `naf_cartpole.py`,
`lrpg_cartpole.py` (reference mount empty this session; inventory per
SURVEY.md §2a).

Redesign: each net is a frozen dataclass with init/apply over an
explicit parameter pytree; bf16 compute / fp32 params; target networks
are plain pytree copies updated by `polyak` (a one-line tree_map, not
graph-variable surgery).
"""

from .nets import (
    ActorMLP,
    CriticMLP,
    NafNet,
    PatchEncoder,
    PixelEncoder,
    PolicyMLP,
    QNetMLP,
    VisualActor,
    VisualNafNet,
    VisualPolicy,
    VisualCritic,
    VisualQNet,
    polyak,
)

__all__ = [
    "ActorMLP",
    "CriticMLP",
    "NafNet",
    "PatchEncoder",
    "PixelEncoder",
    "PolicyMLP",
    "QNetMLP",
    "VisualActor",
    "VisualNafNet",
    "VisualPolicy",
    "VisualCritic",
    "VisualQNet",
    "polyak",
]
