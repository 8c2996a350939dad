"""Multi-process (simulated multi-host) runtime test.

SURVEY.md §4: "multi-host is tested with jax.distributed multi-process on
one host". Two JAX processes x 2 virtual CPU devices form a 4-device
global ('data',) mesh via `initialize_multihost`; the sharded env rollout
must produce identical totals on every rank — the runtime layer BASELINE
config 5 needs (BASELINE.json:11), minus the real cluster.
"""

import os
import subprocess
import sys

import pytest

# Spawns 2-process jax.distributed runtimes: slow tier.
pytestmark = pytest.mark.slow

_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
rank = int(sys.argv[1])
port = sys.argv[2]
sys.path.insert(0, {repo!r})
from cartpoleplusplus_tpu.dist import initialize_multihost, make_mesh, \
    shard_batch_tree
initialize_multihost(f"localhost:{{port}}".format(port=port),
                     num_processes=2, process_id=rank)
import jax.numpy as jnp
from cartpoleplusplus_tpu import CartPole3D, CartPoleParams

assert jax.process_count() == 2
assert len(jax.devices()) == 4 and len(jax.local_devices()) == 2
env = CartPole3D(CartPoleParams(), num_envs=32)
mesh = make_mesh()
state, _ = jax.jit(env.reset)(0)
state = shard_batch_tree(state, mesh)
def policy(o, k):
    return jnp.zeros((o.shape[0],), jnp.int32)
state, (obs, act, rew, done) = jax.jit(
    lambda s: env.rollout(s, policy, 16))(state)
print("TOTAL", float(jnp.sum(rew)), flush=True)
"""


def test_two_process_mesh_rollout(tmp_path):
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "worker.py"
    script.write_text(_WORKER.replace("{repo!r}", repr(repo)))
    port = "23461"
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS",)}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
        assert p.returncode == 0, out[-2000:]
    totals = []
    for out in outs:
        lines = [l for l in out.splitlines() if l.startswith("TOTAL")]
        assert lines, out[-2000:]
        totals.append(float(lines[0].split()[1]))
    assert totals[0] == totals[1] > 0


_DDPG_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
rank = int(sys.argv[1])
port = sys.argv[2]
sys.path.insert(0, {repo!r})
from cartpoleplusplus_tpu.dist import (initialize_multihost, make_mesh,
                                       make_distributed_train_step,
                                       shard_agent_state)
initialize_multihost(f"localhost:{{port}}".format(port=port),
                     num_processes=2, process_id=rank)
import numpy as np
from cartpoleplusplus_tpu import CartPole3D
from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu.physics.params import continuous_params

env = CartPole3D(continuous_params(), num_envs=16)
agent = DDPG(env, DDPGConfig(hidden=(16,), rollout_steps=2,
                             updates_per_step=1, batch_size=16,
                             replay_capacity_per_env=16,
                             warmup_env_steps=0))
mesh = make_mesh()
state = shard_agent_state(agent.init(0), mesh)
step = make_distributed_train_step(agent, mesh)
for _ in range(2):
    state, metrics = step(state)
# Params are replicated: every process holds the same post-update copy.
leaf = jax.tree.leaves(state.actor)[0]
s = float(np.abs(np.asarray(leaf.addressable_data(0))).sum())
print("PARAMSUM", round(s, 6), "LOSS",
      round(float(metrics["critic_loss"]), 6), flush=True)
"""


def test_two_process_ddpg_train_step(tmp_path):
    """BASELINE config 5 at runtime level: a sharded DDPG actor-learner
    step across 2 JAX processes — gradients psum across process-local
    devices; both ranks end with identical replicated parameters."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "ddpg_worker.py"
    script.write_text(_DDPG_WORKER.replace("{repo!r}", repr(repo)))
    port = "23467"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    results = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        assert p.returncode == 0, out[-2000:]
        line = [l for l in out.splitlines() if l.startswith("PARAMSUM")]
        assert line, out[-2000:]
        results.append(line[0])
    assert results[0] == results[1]


_DQN_LEARN_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
rank = int(sys.argv[1])
port = sys.argv[2]
sys.path.insert(0, {repo!r})
from cartpoleplusplus_tpu.dist import (DATA_AXIS, initialize_multihost,
                                       make_mesh, make_shardmap_evaluate,
                                       make_shardmap_train_scan,
                                       shard_agent_state)
initialize_multihost(f"localhost:{{port}}".format(port=port),
                     num_processes=2, process_id=rank)
import numpy as np
from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu.agents import DQN, DQNConfig, RandomAgent

assert jax.process_count() == 2 and len(jax.devices()) == 4
n = 4                      # global shards (2 per process)
params = CartPoleParams()
cfg = DQNConfig(hidden=(64, 64), rollout_steps=16, updates_per_step=8,
                batch_size=128, replay_capacity_per_env=512, lr=5e-4,
                eps_decay_env_steps=1200, eps_end=0.05,
                warmup_env_steps=32, sample="uniform")
env_g = CartPole3D(params, num_envs=16 * n)
state = shard_agent_state(DQN(env_g, cfg).init(0), make_mesh())
agent_l = DQN(CartPole3D(params, num_envs=16), cfg,
              dist_axis=DATA_AXIS, num_shards=n)
mesh = make_mesh()
k = 5
scan = make_shardmap_train_scan(agent_l, mesh, k, state)
for _ in range((2000 // 16) // k):
    state, _ = scan(state)
stats = {key: float(v) for key, v in make_shardmap_evaluate(
    agent_l, mesh, state, 400, 7)(state).items()}
# Local (process-private) random baseline on the same global env shape.
import jax.numpy as jnp
rand = {key: float(v) for key, v in jax.jit(
    RandomAgent(env_g).evaluate, static_argnums=(1,))(
        jax.random.PRNGKey(7), 400).items()}
print("LEARN", round(stats["mean_episode_length"], 4),
      "RAND", round(rand["mean_episode_length"], 4),
      "EPISODES", int(stats["episodes"]), flush=True)
"""


def test_two_process_dqn_learns(tmp_path):
    """Cross-HOST learning, not just a train step (VERDICT r4 item 5 /
    BASELINE config 5): DQN trained entirely through the shard_map
    learner on a 2-process x 2-device global mesh — chip-local rollout
    and replay, gradient pmean crossing the process boundary — must
    beat the random baseline >=2x on the exact completed-episode
    statistics through the SHARDED eval path, and both ranks must
    report the identical result (replicated learning is bitwise in
    lockstep across processes)."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "dqn_learn_worker.py"
    script.write_text(_DQN_LEARN_WORKER.replace("{repo!r}", repr(repo)))
    port = "23473"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    lines = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        assert p.returncode == 0, out[-2000:]
        ln = [l for l in out.splitlines() if l.startswith("LEARN")]
        assert ln, out[-2000:]
        lines.append(ln[0])
    assert lines[0] == lines[1], lines
    parts = lines[0].split()
    learned, rand = float(parts[1]), float(parts[3])
    assert int(parts[5]) > 0
    assert learned > 2.0 * rand, (
        f"2-process sharded DQN {learned:.1f} vs random {rand:.1f} — "
        f"learning did not cross the process boundary")


_CKPT_WORKER = r"""
import os, sys
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
import jax
jax.config.update("jax_platforms", "cpu")
rank = int(sys.argv[1])
port = sys.argv[2]
ckpt_dir = sys.argv[3]
sys.path.insert(0, {repo!r})
from cartpoleplusplus_tpu.dist import (initialize_multihost, make_mesh,
                                       make_distributed_train_step,
                                       shard_agent_state)
initialize_multihost(f"localhost:{{port}}".format(port=port),
                     num_processes=2, process_id=rank)
import numpy as np
from jax.experimental import multihost_utils
from cartpoleplusplus_tpu import CartPole3D
from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
from cartpoleplusplus_tpu.ckpt import CheckpointManager
from cartpoleplusplus_tpu.physics.params import continuous_params

env = CartPole3D(continuous_params(), num_envs=16)
agent = DDPG(env, DDPGConfig(hidden=(16,), rollout_steps=2,
                             updates_per_step=1, batch_size=16,
                             replay_capacity_per_env=16,
                             warmup_env_steps=0))
mesh = make_mesh()
state = shard_agent_state(agent.init(0), mesh)
state, _ = make_distributed_train_step(agent, mesh)(state)
with CheckpointManager(ckpt_dir, max_to_keep=1) as mgr:
    mgr.save(1, state, force=True)
    mgr.save(2, state, force=True)
    assert mgr.all_steps() == [2], mgr.all_steps()
    restored = mgr.restore(shard_agent_state(agent.init(1), mesh))
gather = lambda x: np.asarray(multihost_utils.process_allgather(x, tiled=True))
n = 0
for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(restored)):
    assert b.sharding == a.sharding, (a.sharding, b.sharding)
    np.testing.assert_array_equal(gather(a), gather(b))
    n += 1
print("CKPT", n, flush=True)
"""


def test_two_process_checkpoint_roundtrip(tmp_path):
    """A DDPG state sharded across 2 processes (replay split over the
    process boundary, params replicated) saves through CheckpointManager
    and restores onto a fresh state with the same shardings, equal leaf
    for leaf on both ranks; retention keeps only the newest step."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    script = tmp_path / "ckpt_worker.py"
    script.write_text(_CKPT_WORKER.replace("{repo!r}", repr(repo)))
    port = "23479"
    env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
    procs = [subprocess.Popen(
        [sys.executable, str(script), str(rank), port,
         str(tmp_path / "ckpt")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        env=env) for rank in range(2)]
    lines = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        assert p.returncode == 0, out[-2000:]
        ln = [l for l in out.splitlines() if l.startswith("CKPT")]
        assert ln, out[-2000:]
        lines.append(ln[0])
    assert lines[0] == lines[1] and int(lines[0].split()[1]) > 0, lines
