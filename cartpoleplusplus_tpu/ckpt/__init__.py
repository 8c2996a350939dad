"""Checkpoint / resume.

Reference counterpart: the per-trainer TensorFlow `Saver` checkpoints
(`--ckpt-dir`, periodic save/restore) in rebcabin/cartpoleplusplus
(SURVEY.md §5 checkpoint row).

Redesign: a plain numpy (.npz) + JSON-manifest writer over the WHOLE
agent TrainState pytree — networks, optimizer moments, target nets,
device-resident replay buffer, env state and PRNG keys — so a resumed
run continues bit-exact, not just "with the same weights". Restores
take the sharding of a provided target state, so a checkpoint moves
between meshes.
"""

from .checkpoint import CheckpointManager, restore_checkpoint, save_checkpoint

__all__ = ["CheckpointManager", "save_checkpoint", "restore_checkpoint"]
