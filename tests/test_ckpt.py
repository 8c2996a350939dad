"""Checkpoint/resume tests: bit-exact resume of the full agent state
(SURVEY.md §5 — the TF-Saver capability, rebuilt on numpy + JSON)."""

import jax
import numpy as np
import pytest

from cartpoleplusplus_tpu import CartPole3D
from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu.ckpt import (
    CheckpointManager,
    restore_checkpoint,
    save_checkpoint,
)
from cartpoleplusplus_tpu.ckpt.checkpoint import read_manifest
from cartpoleplusplus_tpu.physics.params import continuous_params


def _agent():
    env = CartPole3D(continuous_params(), num_envs=4)
    return DDPG(env, DDPGConfig(hidden=(16, 16), rollout_steps=2,
                                updates_per_step=1, batch_size=16,
                                replay_capacity_per_env=16,
                                warmup_env_steps=0))


def _assert_tree_equal(a, b):
    jax.tree.map(
        lambda x, y: np.testing.assert_array_equal(np.asarray(x),
                                                   np.asarray(y)), a, b)


def test_save_restore_roundtrip(tmp_path):
    agent = _agent()
    st = agent.init(0)
    step = agent.make_train_step()
    st, _ = step(st)
    # make_train_step donates its input: save a fresh reference copy.
    saved_copy = jax.tree.map(np.asarray, st)
    save_checkpoint(str(tmp_path / "ck"), st)
    restored = restore_checkpoint(str(tmp_path / "ck"), agent.init(1))
    _assert_tree_equal(saved_copy, restored)


def test_resume_is_bit_exact(tmp_path):
    """train(ckpt(train(s))) == train(train(s)) — replay, env state and
    PRNG all resume exactly."""
    agent = _agent()
    step = agent.make_train_step()

    st = agent.init(0)
    st, _ = step(st)
    save_checkpoint(str(tmp_path / "ck"), st)
    st_cont, m_cont = step(st)

    restored = restore_checkpoint(str(tmp_path / "ck"), agent.init(1))
    st_res, m_res = step(restored)
    _assert_tree_equal(jax.tree.map(np.asarray, st_cont),
                       jax.tree.map(np.asarray, st_res))
    _assert_tree_equal(m_cont, m_res)


def test_manager_interval_retention_resume(tmp_path):
    agent = _agent()
    st = agent.init(0)
    with CheckpointManager(str(tmp_path / "runs"), save_interval_steps=2,
                           max_to_keep=2) as mgr:
        saves = [mgr.save(i, st) for i in range(5)]
        mgr.wait_until_finished()
        assert saves == [True, False, True, False, True]
        assert mgr.latest_step() == 4
        restored = mgr.restore(agent.init(1))
        _assert_tree_equal(jax.tree.map(np.asarray, st),
                           jax.tree.map(np.asarray, restored))

    with CheckpointManager(str(tmp_path / "runs")) as mgr2:
        assert mgr2.latest_step() == 4  # resume discovery across processes


def test_restore_missing_raises(tmp_path):
    agent = _agent()
    with CheckpointManager(str(tmp_path / "empty")) as mgr:
        with pytest.raises(FileNotFoundError):
            mgr.restore(agent.init(0))


def test_weights_only_checkpoint(tmp_path):
    """exclude=("replay",): saves skip the buffer (the reference's
    variables-only TF Saver behavior); restore warm-starts weights and
    env state with a fresh replay."""
    agent = _agent()
    st = agent.init(0)
    step = agent.make_train_step()
    st, _ = step(st)
    saved = jax.tree.map(np.asarray, st)
    with CheckpointManager(str(tmp_path / "w"), exclude=("replay",)) as mgr:
        assert mgr.save(0, st)
        mgr.wait_until_finished()
        fresh = agent.init(1)
        restored = mgr.restore(fresh)
    _assert_tree_equal(saved["actor"] if isinstance(saved, dict)
                       else saved.actor, restored.actor)
    _assert_tree_equal(jax.tree.map(np.asarray, st.env_state),
                       restored.env_state)
    # Replay came from the fresh target, not the checkpoint.
    _assert_tree_equal(jax.tree.map(np.asarray, fresh.replay),
                       restored.replay)
    assert int(restored.replay.filled) == 0


def test_restore_adapts_to_weights_only_save(tmp_path):
    """A weights-only save restores through a FULL-template manager
    (the --eval-only-after---no-ckpt-full workflow): on-disk fields load,
    missing ones keep the fresh target's values — no exclusion re-pass."""
    agent = _agent()
    st = agent.init(0)
    step = agent.make_train_step()
    st, _ = step(st)
    saved = jax.tree.map(np.asarray, st)
    with CheckpointManager(str(tmp_path / "w"), exclude=("replay",)) as mgr:
        assert mgr.save(0, st)
        mgr.wait_until_finished()
    # Fresh manager WITHOUT the exclusion — must still restore.
    fresh = agent.init(1)
    with CheckpointManager(str(tmp_path / "w")) as mgr2:
        restored = mgr2.restore(fresh)
    _assert_tree_equal(saved.actor, restored.actor)
    _assert_tree_equal(jax.tree.map(np.asarray, st.env_state),
                       restored.env_state)
    assert int(restored.replay.filled) == 0  # fresh replay, not on disk


def test_weights_only_restore_of_full_save(tmp_path):
    """The reverse direction: a FULL save restored with exclude=("replay",)
    partial-restores just the requested fields."""
    agent = _agent()
    st = agent.init(0)
    step = agent.make_train_step()
    st, _ = step(st)
    saved = jax.tree.map(np.asarray, st)
    save_checkpoint(str(tmp_path / "full"), st)
    fresh = agent.init(1)
    restored = restore_checkpoint(str(tmp_path / "full"), fresh,
                                  exclude=("replay",))
    _assert_tree_equal(saved.actor, restored.actor)
    _assert_tree_equal(saved.critic, restored.critic)
    _assert_tree_equal(jax.tree.map(np.asarray, fresh.replay),
                       restored.replay)


def test_restore_onto_another_mesh(tmp_path):
    """A state sharded over the 8-device mesh (env/replay fields on
    'data', params replicated) restores onto a 2-device mesh: every leaf
    takes the target's sharding, values bit-exact."""
    from cartpoleplusplus_tpu.dist import make_mesh, shard_agent_state

    agent = _agent()
    st8 = shard_agent_state(agent.init(0), make_mesh(jax.devices()[:8]))
    assert len(st8.replay.obs.sharding.device_set) == 8
    save_checkpoint(str(tmp_path / "ck"), st8)
    mesh2 = make_mesh(jax.devices()[:2])
    target = shard_agent_state(agent.init(1), mesh2)
    restored = restore_checkpoint(str(tmp_path / "ck"), target)
    _assert_tree_equal(jax.tree.map(np.asarray, st8), restored)
    for r, t in zip(jax.tree.leaves(restored), jax.tree.leaves(target)):
        assert r.sharding == t.sharding
    assert len(restored.replay.obs.sharding.device_set) == 2
    assert read_manifest(str(tmp_path / "ck"))["fields"] == sorted(
        st8._fields)


@pytest.mark.slow
def test_cli_weights_only_excludes_env_fields(tmp_path):
    """The train CLI's --no-ckpt-full saves persist nets + optimizer +
    counters ONLY: every env-shaped field (replay, env_state, obs,
    noise) stays off disk — at 4096 pixel envs the obs alone is ~57 MB
    per save."""
    from cartpoleplusplus_tpu.train import main
    d = tmp_path / "ck"
    assert main(["--agent", "ddpg", "--num-envs", "8",
                 "--total-env-steps", "8", "--log-interval", "100",
                 "--ckpt-dir", str(d), "--no-ckpt-full",
                 "--ddpg.hidden", "16", "16",
                 "--ddpg.rollout-steps", "2",
                 "--ddpg.updates-per-step", "1",
                 "--ddpg.batch-size", "16",
                 "--ddpg.replay-capacity-per-env", "8",
                 "--ddpg.warmup-env-steps", "0"]) == 0
    steps = sorted(int(p.name) for p in d.iterdir() if p.name.isdigit())
    fields = set(read_manifest(str(d / str(steps[-1])))["fields"])
    assert {"actor", "critic", "actor_opt", "env_steps"} <= fields
    assert not ({"replay", "env_state", "obs", "noise"} & fields)
