"""Training CLI — the user-facing entry point for every agent family.

Reference counterpart: the per-algorithm scripts at the reference's root
(`ddpg_cartpole.py --flags`, `dqn_cartpole.py`, `naf_cartpole.py`,
`lrpg_cartpole.py`, `random_action_agent.py` — SURVEY.md §2a/§3.3).
One CLI replaces all five: the env,
agent, mesh, checkpointing, event log and profiler are assembled from a
typed config.

Usage:
    python -m cartpoleplusplus_tpu.train --agent ddpg --num-envs 4096
    python -m cartpoleplusplus_tpu.train --agent dqn --agent-cfg.lr 1e-3
    python -m cartpoleplusplus_tpu.train --agent random  # smoke/baseline
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from . import CartPole3D, CartPoleParams
from .agents import DDPG, DDPGConfig, DQN, DQNConfig, LRPG, LRPGConfig, \
    NAF, NAFConfig, RandomAgent
from .config import RunConfig, add_dataclass_args, explicit_dests, from_args
from .physics.params import continuous_params

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")

_AGENTS = {
    "ddpg": (DDPG, DDPGConfig, "continuous"),
    "naf": (NAF, NAFConfig, "continuous"),
    "dqn": (DQN, DQNConfig, "discrete"),
    "lrpg": (LRPG, LRPGConfig, "discrete"),
    "random": (None, None, "discrete"),
}

# Named presets: tuned recipes, applied to unset fields only
# (explicitly-typed flags always override preset fields).
# - fast (ddpg): large-batch, long-rollout cadence for throughput; it
#   sits near a mediocre attractor that catches some seeds, so the
#   end-of-budget canary re-seeds and re-trains a collapsed attempt.
#   Quality-critical runs keep the agent defaults.
# - fast (lrpg): 2048 envs, 120k per-env steps at dispatch 16.
# - fast (naf): 1024 envs, 80k per-env steps at dispatch 16, with the
#   end-of-budget canary (NAF recipes sit near a basin boundary where
#   the matmul arithmetic can reroute a run — docs/design.md §16).
# - pixels (ddpg): grayscale uint8 48x48 2-camera obs with gain-4
#   frame-diff motion channels, block sampling, lr decay.
_PRESETS = {
    "fast": {
        "ddpg": {
            # Verify-and-retry: this cadence sits near a mediocre
            # attractor that catches ~1 in 4 seeds; every static knob
            # that rescued one seed sank another, and mid-run evals
            # cannot separate the two. So the canary fires at 100% of
            # budget: eval; below 150 -> restart from a re-seeded init.
            # At P(fail) ~ 0.25 per attempt ~98% of runs end >= 150
            # within the default 2 restarts.
            "run": dict(num_envs=4096, total_env_steps=320_000,
                        steps_per_dispatch=32, canary_env_steps=320_000,
                        canary_min_eval=150.0),
            "agent": dict(rollout_steps=64, updates_per_step=8,
                          batch_size=8192, ou_sigma_decay_env_steps=64_000,
                          warmup_env_steps=0),
        },
        "lrpg": {
            "run": dict(num_envs=2048, total_env_steps=120_000,
                        steps_per_dispatch=16),
            "agent": dict(),
        },
        "naf": {
            # End-of-budget canary: collapsed attempts are re-seeded
            # and re-trained (restart budget 5).
            "run": dict(num_envs=1024, total_env_steps=80_000,
                        steps_per_dispatch=16, canary_env_steps=80_000,
                        canary_min_eval=150.0, canary_max_restarts=5),
            "agent": dict(),
        },
    },
    "pixels": {
        "ddpg": {
            # 2048 envs / replay 64 / BLOCK sampling / 200k steps / lr
            # decay over the first 100k.
            "run": dict(num_envs=2048, obs_mode="pixels",
                        render_grayscale=True, render_obs_uint8=True,
                        render_frame_diff=True, render_frame_diff_gain=4.0,
                        total_env_steps=200_000, steps_per_dispatch=16,
                        # End-of-budget collapse canary: long-horizon
                        # pixel runs can walk off entirely on unlucky
                        # seeds and mid-run evals cannot tell, so the
                        # same verify-and-retry as the fast/NAF
                        # presets. Restart budget 4: the collapse rate
                        # at the 200k horizon was ~1 in 3 draws.
                        canary_env_steps=200_000, canary_min_eval=150.0,
                        canary_max_restarts=4,
                        # One log per 10 dispatches: every metric fetch
                        # is a device->host sync.
                        log_interval=160,
                        # Weights-only saves: a full-state pixel ckpt
                        # copies the multi-GB uint8 replay ring to the
                        # host per save. Resume loses the ring (refills
                        # in seconds); --eval-only restore is
                        # unaffected.
                        ckpt_full=False),
            "agent": dict(actor_lr=3e-4, critic_lr=3e-4,
                          updates_per_step=16,
                          replay_capacity_per_env=64, sample="block",
                          ou_sigma_decay_env_steps=20_000,
                          lr_decay_env_steps=100_000),
        },
    },
}


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu.train",
                                 description=__doc__.split("\n")[0])
    add_dataclass_args(ap, RunConfig)
    # Physics/env and per-agent flags compose under dotted prefixes —
    # the reference's `module.add_opts(parser)` pattern, automated.
    add_dataclass_args(ap, CartPoleParams, prefix="env.")
    for name, (_, cfg_cls, _) in _AGENTS.items():
        if cfg_cls is not None:
            add_dataclass_args(ap, cfg_cls, prefix=f"{name}.")
    return ap


def build(run: RunConfig, args: argparse.Namespace, provided=None):
    """(env, agent) from parsed configuration.

    `provided` is the set of explicitly-passed CLI dests (main computes it
    via config.explicit_dests); fields the user actually typed are NEVER
    lifted to the continuous preset, even when the typed value equals the
    plain default (e.g. `--no-env.reward-shaped` must stick). Library
    callers that skip `provided` fall back to a value-differs heuristic.
    """
    _, cfg_cls, kind = _AGENTS[run.agent]
    params = from_args(CartPoleParams, args, prefix="env.")
    if kind == "continuous":
        # Continuous agents default to the config-3 preset (continuous
        # actions + shaped reward + pushes); unset fields lift to it.
        plain, preset = CartPoleParams(), continuous_params()

        def keep(f):
            if provided is not None:
                return ("env." + f.name) in provided
            return getattr(params, f.name) != getattr(plain, f.name)

        merged = {
            f.name: (getattr(params, f.name) if keep(f)
                     else getattr(preset, f.name))
            for f in dataclasses.fields(CartPoleParams)}
        params = CartPoleParams(**merged)
    render_config = None
    if run.obs_mode == "pixels":
        from .env.pixels import RenderConfig
        render_config = RenderConfig(width=run.render_size,
                                     height=run.render_size,
                                     grayscale=run.render_grayscale,
                                     dtype=run.render_dtype,
                                     obs_uint8=run.render_obs_uint8,
                                     frame_diff=run.render_frame_diff,
                                     frame_diff_gain=(
                                         run.render_frame_diff_gain))
    env = CartPole3D(params, num_envs=run.num_envs, obs_mode=run.obs_mode,
                     render_config=render_config)
    if run.agent == "random":
        return env, RandomAgent(env)
    agent_cls = _AGENTS[run.agent][0]
    cfg = from_args(cfg_cls, args, prefix=f"{run.agent}.")
    if run.preset and run.agent in _PRESETS.get(run.preset, {}):
        over = {k: v
                for k, v in _PRESETS[run.preset][run.agent]["agent"].items()
                if provided is None
                or f"{run.agent}.{k}" not in provided}
        cfg = dataclasses.replace(cfg, **over)
    return env, agent_cls(env, cfg)


def enable_compile_cache():
    """Persistent XLA compilation cache for every entry point (this CLI,
    bench.py, chip_smoke.py, experiments/). Where JAX_COMPILATION_CACHE_DIR
    is set, JAX already reads it and nothing is set here; otherwise the
    cache lives at <checkout>/.jax_cache, a fixed path so that repeat
    runs find their entries. The threshold is low enough that the
    train-step compiles (seconds each) are kept."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def parse_run(argv):
    """(run, args, provided) for a command line, with the preset's run
    fields applied where the user typed none. Raises ValueError for an
    unknown agent or preset."""
    args = build_parser().parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    if run.agent not in _AGENTS:
        raise ValueError(f"unknown agent {run.agent!r}; choose from "
                         f"{list(_AGENTS)}")
    if run.preset:
        if run.agent not in _PRESETS.get(run.preset, {}):
            raise ValueError(
                f"unknown preset {run.preset!r} for agent {run.agent!r}; "
                f"presets: {sorted(p + ':' + a for p, d in _PRESETS.items() for a in d)}")
        run = dataclasses.replace(
            run, **{k: v
                    for k, v in _PRESETS[run.preset][run.agent]["run"].items()
                    if k not in provided})
    return run, args, provided


def main(argv=None) -> int:
    enable_compile_cache()
    try:
        run, args, provided = parse_run(argv)
    except ValueError as e:
        print(e, file=sys.stderr)
        return 2
    try:
        env, agent = build(run, args, provided)
    except ValueError as e:
        # Config-validation errors (e.g. a block-sampling batch that
        # does not divide the env batch) surface as the CLI's clean
        # rc=2 path, not a traceback.
        hint = (" (note: --preset {} may pin fields; override with "
                "explicit flags)".format(run.preset) if run.preset else "")
        print(f"invalid configuration: {e}{hint}", file=sys.stderr)
        return 2

    if run.agent == "random":
        # total_env_steps is PER-ENV everywhere (the training loop runs
        # total_env_steps // rollout_steps calls) — the random baseline
        # uses the same per-env interpretation.
        stats = jax.jit(agent.evaluate, static_argnums=(1,))(
            jax.random.PRNGKey(run.seed), max(run.total_env_steps, 1))
        print(json.dumps({k: float(v) for k, v in stats.items()}))
        return 0

    if run.learner not in ("spmd", "shardmap"):
        print(f"unknown learner {run.learner!r}; choose spmd or shardmap",
              file=sys.stderr)
        return 2

    state = agent.init(run.seed)
    mesh = None
    if run.use_mesh and len(jax.devices()) > 1:
        from .dist import make_mesh
        mesh = make_mesh()

    use_shardmap = run.learner == "shardmap"
    local_agent = None
    if use_shardmap:
        if mesh is None or run.agent not in ("ddpg", "dqn", "naf", "lrpg"):
            print("--learner shardmap needs >1 device and a learning agent "
                  "(ddpg/dqn/naf/lrpg); falling back to spmd",
                  file=sys.stderr)
            use_shardmap = False
        elif run.num_envs % mesh.size != 0:
            print(f"--learner shardmap needs num_envs divisible by the "
                  f"{mesh.size}-device mesh", file=sys.stderr)
            return 2
        else:
            # The PER-SHARD agent the shard_map body runs.
            from .dist import DATA_AXIS
            agent_cls, _, _ = _AGENTS[run.agent]
            local_env = CartPole3D(env.params,
                                   num_envs=run.num_envs // mesh.size,
                                   obs_mode=run.obs_mode)
            local_agent = agent_cls(local_env, agent.cfg,
                                    dist_axis=DATA_AXIS,
                                    num_shards=mesh.size)
    if mesh is not None:
        from .dist import shard_agent_state
        state = shard_agent_state(state, mesh)

    def fresh_state(seed):
        """Re-seeded init with the same sharding the startup state went
        through (canary restarts)."""
        st = agent.init(seed)
        if mesh is not None:
            from .dist import shard_agent_state as _shard
            st = _shard(st, mesh)
        return st

    mgr = None
    start_call = 0
    if run.ckpt_dir:
        from .ckpt import CheckpointManager
        # Weights-only saves (--no-ckpt-full) persist nets + optimizer +
        # counters and skip EVERY env-shaped field, not just the replay
        # ring: at 4096 pixel envs the (B, 48, 48, 6) obs alone is
        # ~57 MB copied to the host every save. Env fields restore to
        # fresh resets, which weights-only resume semantics already
        # accept for the replay ring.
        exclude = (() if run.ckpt_full
                   else ("replay", "env_state", "obs", "noise"))
        if run.eval_only:
            # Deterministic eval needs only network weights; optimizer
            # state is both unnecessary and config-dependent (an lr
            # schedule changes the optax tree structure, so an eval
            # process built without the training run's lr flags could
            # not even restore it). Skip every *opt field + rng.
            # ...and every env-shaped field: evaluation resets its own
            # envs, and restoring (num_envs,)-shaped state would pin
            # --eval-only to the training run's env count (a 4096-env
            # checkpoint could not be evaluated in a 256-env process).
            # env_steps (a scalar counter, not env-shaped) is excluded
            # too: deterministic eval never reads the training-progress
            # counter, and skipping it keeps the eval-restorable set
            # minimal.
            st_fields = type(state)._fields
            exclude = tuple(set(exclude)
                            | {f for f in st_fields
                               if f.endswith("opt") or f == "opt"}
                            | ({"rng", "env_state", "obs", "env_steps",
                                "noise", "replay"} & set(st_fields)))
        mgr = CheckpointManager(
            run.ckpt_dir, save_interval_steps=run.ckpt_interval,
            exclude=exclude)
        latest = mgr.latest_step()
        if latest is not None:
            state = mgr.restore(state, latest)
            # Resume where the run left off: the checkpoint step IS the
            # train-call index, so the loop continues at latest + 1 (and
            # the manager's skip-older-steps save policy lines up).
            start_call = latest + 1
            print(f"resumed from step {latest}", file=sys.stderr)
            # Replay-cursor alignment invariant: the agents insert only
            # rollout_steps-length chunks from cursor 0, and
            # add_trajectory(aligned=True) bakes that in statically
            # (dropping a per-train-step lax.cond that cost two
            # full-ring copies). A checkpoint written under a DIFFERENT
            # rollout length is the one way to violate it — realign
            # here (cursor floors to the chunk grid; the <=t-1 newest
            # transitions get overwritten first, statistically nil).
            rs = getattr(state, "replay", None)
            if rs is not None and hasattr(rs, "cursor"):
                t = agent.cfg.rollout_steps
                cur = int(np.asarray(rs.cursor))
                if cur % t != 0:
                    state = state._replace(replay=rs._replace(
                        cursor=jnp.int32((cur // t) * t)))
                    print(f"realigned replay cursor {cur} -> "
                          f"{(cur // t) * t} (rollout_steps={t})",
                          file=sys.stderr)

    def run_eval(st, seed):
        """Deterministic-policy episode stats. Under --learner shardmap
        the eval itself is sharded (dist/shardmap.py::
        make_shardmap_evaluate): each shard rolls out its envs with
        GLOBAL env identities and the episode histogram is psum'd —
        same statistics as the global eval."""
        if use_shardmap:
            from .dist import make_shardmap_evaluate
            return make_shardmap_evaluate(local_agent, mesh, st,
                                          run.eval_steps, seed)(st)
        return jax.jit(agent.evaluate, static_argnums=(1, 2))(
            st, run.eval_steps, seed)

    if run.eval_only:
        # Deterministic-policy evaluation of the restored (or fresh)
        # weights — the reference's "watch the trained agent" workflow,
        # batched and headless.
        stats = run_eval(state, run.seed)
        print(json.dumps({k: float(np.asarray(v))
                          for k, v in stats.items()}))
        if run.eval_render:
            # Render env 0 acting under the trained greedy policy. The
            # policy steps on its own observation config; the DUMPED
            # frames are always RGB at a readable size (a grayscale
            # 48x48 luminance plane — the pixel-learning obs — is
            # visually ambiguous: cart 0.43 and pole 0.52 blend into
            # the 0.35-0.6 checkerboard).
            import dataclasses as _dc

            from .env.pixels import RenderConfig, render_all_cameras
            from .viz import save_frame
            policy = agent.greedy_policy(state)
            est, obs = jax.jit(env.reset)(run.seed)
            step_fn = jax.jit(env.step)
            base = (env.render_config if run.obs_mode == "pixels"
                    else RenderConfig())
            demo_cfg = _dc.replace(
                base, width=max(base.width, 96),
                height=max(base.height, 96),
                grayscale=False, obs_uint8=False, dtype="float32")
            # Render (and transfer) ONLY env 0 — rendering the full
            # batch to dump one env copies B x H x W x C floats to the
            # host per frame.
            render_fn = jax.jit(lambda ph: render_all_cameras(
                env.params, jax.tree.map(lambda a: a[:1], ph),
                demo_cfg)[0, ..., :3])
            os.makedirs(run.eval_render, exist_ok=True)
            n_frames = min(run.eval_steps, 120)
            for t in range(n_frames):
                img = np.asarray(render_fn(est.phys))
                save_frame(os.path.join(run.eval_render, f"step{t:04d}"),
                           img)
                est, obs, _, _, _ = step_fn(est, policy(obs))
            print(f"wrote {n_frames} frames to {run.eval_render}",
                  file=sys.stderr)
        if mgr is not None:
            mgr.close()
        return 0

    sink = None
    log_envs = run.num_envs
    if run.event_log:
        from .eventlog import EpisodeSink, EventLogWriter, next_episode_ids
        # Per-env sampling: at production batch sizes the host-side sink
        # is the ceiling (docs/design.md §13); logging the first k envs
        # keeps tracing usable at 4096+ envs (per-env randomness is a
        # function of the global env index, so env identity is stable).
        if run.event_log_envs > 0:
            log_envs = min(run.event_log_envs, run.num_envs)
        appending = start_call > 0 and os.path.exists(run.event_log)
        # On append, continue episode numbering past the ids already in
        # the file — (env_id, episode_id) pairs must stay unique.
        seed_ids = (next_episode_ids(run.event_log, log_envs)
                    if appending else None)
        writer = EventLogWriter(
            run.event_log,
            metadata={"run": dataclasses.asdict(run),
                      "env": dataclasses.asdict(env.params),
                      "obs_shape": list(env.obs_shape),
                      "logged_envs": log_envs},
            append=appending)
        sink = EpisodeSink(writer, log_envs,
                           obs_as_frames=env.obs_mode == "pixels",
                           initial_episode_ids=seed_ids)

    if use_shardmap:
        # Explicit-communication learner: device-local replay sampling;
        # cross-device traffic is the gradient pmeans — dist/shardmap.py.
        from .dist import make_shardmap_train_step
        step = make_shardmap_train_step(local_agent, mesh, state,
                                        capture=sink is not None)
    elif mesh is not None:
        # SPMD path on a mesh: pin output state shardings to the input
        # placement (stable layout + in-place donation by construction).
        from .dist import make_distributed_train_step
        step = make_distributed_train_step(agent, mesh, state,
                                           capture=sink is not None)
    else:
        step = agent.make_train_step(capture=sink is not None)

    # Chunked dispatch: scan `steps_per_dispatch` train steps inside one
    # jit call (agents/common.py::make_train_scan; dist/train.py's twin
    # under an SPMD mesh, dist/shardmap.py's under the explicit-
    # communication learner) — amortizes the fixed per-dispatch enqueue
    # cost that dominates at fast cadences.
    spd = max(run.steps_per_dispatch, 1)
    if use_shardmap:
        from .dist import make_shardmap_train_scan
        make_chunk = lambda k: make_shardmap_train_scan(  # noqa: E731
            local_agent, mesh, k, state, capture=sink is not None)
    elif mesh is not None:
        from .dist import make_distributed_train_scan
        make_chunk = lambda k: make_distributed_train_scan(  # noqa: E731
            agent, mesh, k, state, capture=sink is not None)
    else:
        make_chunk = lambda k: agent.make_train_scan(  # noqa: E731
            k, capture=sink is not None)

    if run.profile_dir:
        jax.profiler.start_trace(run.profile_dir)

    steps_per_call = agent.cfg.rollout_steps
    n_calls = max(run.total_env_steps // steps_per_call, 1)
    scans = {}
    t0 = time.perf_counter()
    i = start_call
    attempt = 0
    # Clamp the canary to the actual budget: a preset pins
    # canary_env_steps to ITS total_env_steps, and a user override of
    # --total-env-steps alone must not silently disarm the end-of-budget
    # check (canary_call beyond n_calls would never fire) or turn it
    # into a mid-run one (mid-run evals do not separate the outcomes).
    canary_steps = (min(run.canary_env_steps, run.total_env_steps)
                    if run.canary_env_steps > 0 else 0)
    canary_call = (None if canary_steps <= 0
                   or start_call * steps_per_call >= canary_steps
                   else -(-canary_steps // steps_per_call))
    # Off-thread metric logging: fetching the metric scalars
    # synchronizes with the device, and with a log landing every
    # dispatch that sync would sit in the loop's critical path. A
    # daemon logger thread owns every fetch+print instead; the train
    # loop only hands it device arrays. Bounded queue: if logging falls
    # behind the training rate, windows are dropped (counted, reported
    # at exit) rather than ever back-pressuring the device.
    import queue as _queue
    import threading as _threading

    log_q = _queue.Queue(maxsize=8)
    dropped = [0]

    def _logger():
        while True:
            item = log_q.get()
            if item is None:
                return
            p_metrics, p_k, p_i = item
            row = (lambda v: v[-1]) if p_k > 1 else (lambda v: v)
            m = {key: float(np.asarray(row(v)))
                 for key, v in p_metrics.items()}
            # Rate measured at FETCH COMPLETION: np.asarray above
            # synchronizes with the device, so the elapsed time covers
            # step p_i's actual execution — computing it at post time
            # would count enqueues, not work (dispatch is asynchronous,
            # so an unsynced loop can "finish" a run in seconds of
            # enqueue).
            rate = (run.num_envs * steps_per_call * (p_i - start_call)
                    / (time.perf_counter() - t0))
            m["env_steps_per_sec"] = round(rate)
            m["train_step"] = p_i
            print(json.dumps(m), flush=True)

    log_thread = _threading.Thread(target=_logger, daemon=True)
    log_thread.start()

    def post_log(metrics, k, i, final=False):
        item = (metrics, k, i)
        try:
            log_q.put(item, block=final)  # final window always lands
        except _queue.Full:
            dropped[0] += 1

    while i < n_calls:
        k = min(spd, n_calls - i)
        if k > 1:
            if k not in scans:
                scans[k] = make_chunk(k)
            state, metrics = scans[k](state)
        else:
            state, metrics = step(state)

        if sink is not None:
            obs_t, act_t, rew_t, done_t = metrics.pop("traj")
            if k > 1:
                # Stacked (k, T, B, ...) chunks -> one time-major
                # (k*T, B, ...) chunk (rollouts are contiguous in time).
                reshape = lambda a: a.reshape((-1,) + a.shape[2:])  # noqa: E731
                obs_t, act_t, rew_t, done_t = (
                    reshape(x) for x in (obs_t, act_t, rew_t, done_t))
            # Device-side slice to the logged env subset BEFORE the host
            # fetch (event_log_envs sampling costs no transfer bandwidth).
            sink.add_rollout(np.asarray(obs_t[:, :log_envs]),
                             np.asarray(act_t[:, :log_envs]),
                             np.asarray(rew_t[:, :log_envs]),
                             np.asarray(done_t[:, :log_envs]))
        i += k
        if (canary_call is not None and i >= canary_call
                and attempt <= run.canary_max_restarts):
            stats = run_eval(state, run.seed + 97)
            mean_len = float(np.asarray(stats["mean_episode_length"]))
            healthy = mean_len >= run.canary_min_eval
            print(json.dumps({"canary_eval_mean": round(mean_len, 2),
                              "canary_at_step": i,
                              "attempt": attempt,
                              "healthy": healthy}), flush=True)
            if healthy or attempt == run.canary_max_restarts:
                canary_call = None   # pass (or out of restarts): train on
            else:
                # Collapse detected: random-restart from a re-seeded
                # init (the mediocre attractor is an init/exploration
                # artifact); budget clock and call index restart with
                # the fresh attempt.
                attempt += 1
                # Release the collapsed attempt's buffers BEFORE
                # allocating the fresh state: at pixel scale the
                # transient two-state overlap (uint8 ring ~1.8 GB each
                # plus the scan workspace) fragments device memory and
                # slowed the rest of the process many-fold.
                state = None
                metrics = None
                state = fresh_state(run.seed + 1000 * attempt)
                i = start_call
                t0 = time.perf_counter()
                continue
        if mgr is not None and any(mgr.should_save(j)
                                   for j in range(i - k, i)):
            # force: the window check above IS the cadence decision;
            # the manager would re-check `(i-1) % interval == 0` and
            # skip chunk-boundary steps (see CheckpointManager.save).
            mgr.save(i - 1, state, force=True)
        last_of = range(i - k, i)
        if any((j + 1) % run.log_interval == 0 for j in last_of) \
                or i == n_calls:
            post_log(metrics, k, i, final=i == n_calls)

    log_q.put(None)           # drain + stop the logger thread
    log_thread.join(timeout=120)
    if dropped[0]:
        print(f"logger dropped {dropped[0]} metric windows (training "
              "outpaced the logger; final window always logged)",
              file=sys.stderr)
    if run.profile_dir:
        jax.profiler.stop_trace()
    if mgr is not None and mgr.latest_step() != n_calls - 1:
        # The interval window rarely lands on the final call, so without
        # this a restored run sees a STALE policy. The final training
        # state must always be on disk.
        mgr.save(n_calls - 1, state, force=True)
    if run.final_eval:
        # Honest post-training report: deterministic-policy episode stats
        # (exact completed-episode accounting, agents/common.py) as one
        # last JSON line with eval_-prefixed keys.
        stats = run_eval(state, run.seed + 1)
        print(json.dumps({"eval_" + k: float(np.asarray(v))
                          for k, v in stats.items()}), flush=True)
    if mgr is not None:
        mgr.wait_until_finished()
        mgr.close()
    if sink is not None:
        sink.writer.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
