"""Config/CLI tests (SURVEY.md §5 config row): dataclass->argparse
round-trip, agent construction, and the train entry point end to end
with checkpointing + event logging enabled."""

import json

import numpy as np

from cartpoleplusplus_tpu.config import RunConfig, add_dataclass_args, from_args
from cartpoleplusplus_tpu.train import _AGENTS, build, build_parser, main
from cartpoleplusplus_tpu.eventlog import read_records, validate
import pytest

# End-to-end CLI runs (subprocess + full train loops): slow tier.
pytestmark = pytest.mark.slow


def test_flag_roundtrip_defaults():
    args = build_parser().parse_args([])
    run = from_args(RunConfig, args)
    assert run == RunConfig()


def test_flag_overrides_nested():
    args = build_parser().parse_args([
        "--agent", "dqn", "--num-envs", "32",
        "--env.action-force", "8.5", "--no-env.discrete-actions",
        "--dqn.lr", "0.002", "--dqn.hidden", "16", "16",
    ])
    run = from_args(RunConfig, args)
    assert run.agent == "dqn" and run.num_envs == 32
    assert getattr(args, "env.action_force") == 8.5
    assert getattr(args, "env.discrete_actions") is False
    assert getattr(args, "dqn.lr") == 0.002
    assert getattr(args, "dqn.hidden") == [16, 16]


def test_build_every_agent():
    for name in _AGENTS:
        args = build_parser().parse_args(["--agent", name,
                                          "--num-envs", "4"])
        run = from_args(RunConfig, args)
        env, agent = build(run, args)
        assert env.num_envs == 4
        kind = _AGENTS[name][2]
        assert env.params.discrete_actions == (kind == "discrete")


def test_continuous_preset_keeps_explicit_flags():
    """Round-1 advisor (medium): explicitly-passed env flags whose value
    equals the plain default must NOT be lifted to the continuous preset
    (`--no-env.reward-shaped --env.push-prob-per-repeat 0.0` has to
    stick), while genuinely-unset fields still get the preset."""
    from cartpoleplusplus_tpu.config import explicit_dests
    argv = ["--agent", "ddpg", "--num-envs", "4",
            "--no-env.reward-shaped", "--env.push-prob-per-repeat", "0.0"]
    args = build_parser().parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    env, _ = build(run, args, provided)
    assert env.params.reward_shaped is False
    assert env.params.push_prob_per_repeat == 0.0
    # Unset fields still lift to the config-3 preset.
    assert env.params.discrete_actions is False


def test_train_main_random(capsys):
    rc = main(["--agent", "random", "--num-envs", "8",
               "--total-env-steps", "128"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out.strip())
    assert out["episodes"] > 0


def test_train_main_dqn_with_ckpt_and_eventlog(tmp_path, capsys):
    log = tmp_path / "train.cpe"
    argv = ["--agent", "dqn", "--num-envs", "8",
            "--total-env-steps", "8",
            "--log-interval", "1",
            "--ckpt-dir", str(tmp_path / "ck"), "--ckpt-interval", "1",
            "--event-log", str(log),
            "--dqn.hidden", "16", "--dqn.rollout-steps", "4",
            "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
            "--dqn.replay-capacity-per-env", "16",
            "--dqn.warmup-env-steps", "0"]
    assert main(argv) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[-1]["env_steps"] == 8.0
    assert np.isfinite(lines[-1]["loss"])
    # Event log captured the rollout; per-env step totals must add up.
    assert validate(str(log)) >= 1
    chunks = [r for k, r in read_records(str(log)) if k == "chunk"]
    assert sum(len(c["reward"]) for c in chunks) == 8 * 8
    # Resume path: a second invocation restores from the checkpoint and
    # continues AFTER the last trained call — a completed run does no
    # extra work and must not truncate the existing event log.
    n_before = validate(str(log))
    assert main(argv) == 0
    err_or_out = capsys.readouterr()
    # (resume message goes to stderr)
    assert "resumed from step" in err_or_out.err
    assert err_or_out.out.strip() == ""  # no re-training of finished calls
    assert validate(str(log)) >= n_before  # append mode, not truncation
    # A raised budget resumes and trains only the remaining calls.
    argv2 = list(argv)
    i = argv2.index("--total-env-steps")
    argv2[i + 1] = "16"
    assert main(argv2) == 0
    out2 = capsys.readouterr()
    lines2 = [json.loads(l) for l in out2.out.splitlines()]
    assert lines2 and lines2[-1]["env_steps"] == 16.0


def test_train_main_shardmap_learner(capsys):
    """--learner shardmap drives the explicit-communication path on the
    virtual 8-device mesh."""
    rc = main(["--agent", "ddpg", "--num-envs", "32",
               "--total-env-steps", "4", "--log-interval", "1",
               "--learner", "shardmap",
               "--ddpg.hidden", "16", "--ddpg.rollout-steps", "2",
               "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "16",
               "--ddpg.replay-capacity-per-env", "8",
               "--ddpg.warmup-env-steps", "0"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert np.isfinite(lines[-1]["critic_loss"])


def test_shardmap_learner_with_eventlog(tmp_path, capsys):
    """Round-1 gap: --event-log now works under --learner shardmap (each
    shard's trajectory slab is stitched on the batch axis by shard_map
    out_specs). Per-env step totals in the log must add up exactly."""
    log = tmp_path / "sm.cpe"
    rc = main(["--agent", "ddpg", "--num-envs", "32",
               "--total-env-steps", "4", "--log-interval", "1",
               "--learner", "shardmap", "--event-log", str(log),
               "--ddpg.hidden", "16", "--ddpg.rollout-steps", "2",
               "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "16",
               "--ddpg.replay-capacity-per-env", "8",
               "--ddpg.warmup-env-steps", "0"])
    assert rc == 0
    assert validate(str(log)) >= 1
    chunks = [r for k, r in read_records(str(log)) if k == "chunk"]
    assert sum(len(c["reward"]) for c in chunks) == 4 * 32
    assert {c["env_id"] for c in chunks} == set(range(32))


def test_shardmap_learner_chunked_dispatch(tmp_path, capsys):
    """--steps-per-dispatch under --learner shardmap scans train steps
    inside the shard_map body (dist.make_shardmap_train_scan) — the
    event-log contents must be identical to per-step dispatch."""
    logs = {}
    for spd in ("1", "2"):
        log = tmp_path / f"sm{spd}.cpe"
        rc = main(["--agent", "ddpg", "--num-envs", "32",
                   "--total-env-steps", "4", "--log-interval", "1",
                   "--learner", "shardmap", "--event-log", str(log),
                   "--steps-per-dispatch", spd,
                   "--ddpg.hidden", "16", "--ddpg.rollout-steps", "2",
                   "--ddpg.updates-per-step", "1",
                   "--ddpg.batch-size", "16",
                   "--ddpg.replay-capacity-per-env", "8",
                   "--ddpg.warmup-env-steps", "0"])
        assert rc == 0
        chunks = [r for k, r in read_records(str(log)) if k == "chunk"]
        # Chunk-record boundaries depend on the dispatch granularity
        # (one sink push per dispatch); the per-env (episode, reward)
        # STREAMS must be identical.
        streams = {}
        for c in chunks:
            streams.setdefault(c["env_id"], []).extend(
                (c["episode_id"], float(r))
                for r in np.asarray(c["reward"]))
        logs[spd] = streams
    assert sum(len(s) for s in logs["2"].values()) == 4 * 32
    assert logs["1"] == logs["2"]


def test_eventlog_env_sampling(tmp_path, capsys):
    """--event-log-envs k logs only the first k envs (docs/design.md §13
    scalability valve)."""
    log = tmp_path / "sampled.cpe"
    rc = main(["--agent", "dqn", "--num-envs", "16",
               "--total-env-steps", "4", "--log-interval", "1",
               "--event-log", str(log), "--event-log-envs", "3",
               "--dqn.hidden", "16", "--dqn.rollout-steps", "2",
               "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
               "--dqn.replay-capacity-per-env", "8",
               "--dqn.warmup-env-steps", "0"])
    assert rc == 0
    recs = list(read_records(str(log)))
    meta = [r for k, r in recs if k == "metadata"][0]
    assert meta["logged_envs"] == 3
    chunks = [r for k, r in recs if k == "chunk"]
    assert {c["env_id"] for c in chunks} == {0, 1, 2}
    assert sum(len(c["reward"]) for c in chunks) == 4 * 3


def test_eventlog_png_dump(tmp_path, capsys):
    """Pixel-obs event logs dump per-step PNG/PPM images via the CLI
    (reference event_log.py reader parity — SURVEY.md §3.5)."""
    import glob

    from cartpoleplusplus_tpu.eventlog.__main__ import main as elmain
    log = tmp_path / "px.cpe"
    rc = main(["--agent", "ddpg", "--num-envs", "8", "--obs-mode", "pixels",
               "--total-env-steps", "2", "--log-interval", "1",
               "--event-log", str(log), "--event-log-envs", "1",
               "--ddpg.hidden", "8", "--ddpg.rollout-steps", "2",
               "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "8",
               "--ddpg.replay-capacity-per-env", "8",
               "--ddpg.warmup-env-steps", "0"])
    assert rc == 0
    out_dir = tmp_path / "png"
    elmain(["dump", str(log), "--frames", str(out_dir), "--png"])
    capsys.readouterr()
    imgs = glob.glob(str(out_dir / "ep*_env0_t*"))
    assert len(imgs) == 2  # one image per logged step


def test_train_then_eval_only(tmp_path, capsys):
    """Train briefly with checkpoints, then --eval-only restores and
    reports deterministic-policy episode statistics."""
    argv = ["--agent", "dqn", "--num-envs", "8", "--total-env-steps", "8",
            "--log-interval", "1", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-interval", "1",
            "--dqn.hidden", "16", "--dqn.rollout-steps", "4",
            "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
            "--dqn.replay-capacity-per-env", "16",
            "--dqn.warmup-env-steps", "0"]
    assert main(argv) == 0
    capsys.readouterr()
    assert main(argv + ["--eval-only", "--eval-steps", "64"]) == 0
    out = capsys.readouterr()
    stats = json.loads(out.out.strip())
    assert stats["episodes"] > 0
    assert 1.0 <= stats["mean_episode_length"] <= 200.0
    assert "resumed" in out.err


def test_eval_render_writes_frames(tmp_path, capsys):
    argv = ["--agent", "dqn", "--num-envs", "8", "--total-env-steps", "4",
            "--log-interval", "1", "--ckpt-dir", str(tmp_path / "ck"),
            "--ckpt-interval", "1",
            "--dqn.hidden", "16", "--dqn.rollout-steps", "4",
            "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
            "--dqn.replay-capacity-per-env", "16",
            "--dqn.warmup-env-steps", "0"]
    assert main(argv) == 0
    capsys.readouterr()
    out_dir = tmp_path / "frames"
    assert main(argv + ["--eval-only", "--eval-steps", "6",
                        "--eval-render", str(out_dir)]) == 0
    import glob
    assert len(glob.glob(str(out_dir / "step*"))) == 6


def test_train_steps_per_dispatch_chunked(tmp_path, capsys):
    """--steps-per-dispatch 2 over 3 train calls: one 2-step scanned
    dispatch plus a 1-step tail. Totals, metrics rows and the event-log
    capture must all line up with the unchunked semantics."""
    log = tmp_path / "chunked.cpe"
    argv = ["--agent", "dqn", "--num-envs", "8",
            "--total-env-steps", "12",
            "--log-interval", "1",
            "--event-log", str(log),
            "--steps-per-dispatch", "2",
            "--dqn.hidden", "16", "--dqn.rollout-steps", "4",
            "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
            "--dqn.replay-capacity-per-env", "16",
            "--dqn.warmup-env-steps", "0"]
    assert main(argv) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert lines[-1]["env_steps"] == 12.0
    assert lines[-1]["train_step"] == 3
    assert np.isfinite(lines[-1]["loss"])
    assert validate(str(log)) >= 1
    chunks = [r for k, r in read_records(str(log)) if k == "chunk"]
    assert sum(len(c["reward"]) for c in chunks) == 12 * 8


def test_preset_fast_merges_without_clobbering(tmp_path, capsys):
    """--preset fast lifts unset run/agent fields to the measured
    high-throughput recipe; explicitly-typed flags always win."""
    from cartpoleplusplus_tpu.train import build, build_parser
    from cartpoleplusplus_tpu.config import (RunConfig, explicit_dests,
                                             from_args)

    argv = ["--agent", "ddpg", "--preset", "fast", "--num-envs", "64",
            "--ddpg.updates-per-step", "2",
            "--ddpg.replay-capacity-per-env", "8"]
    args = build_parser().parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    import dataclasses as dc
    from cartpoleplusplus_tpu.train import _PRESETS
    run = dc.replace(run, **{k: v
                             for k, v in _PRESETS["fast"]["ddpg"]["run"].items()
                             if k not in provided})
    env, agent = build(run, args, provided)
    assert run.num_envs == 64                      # explicit flag wins
    assert run.total_env_steps == 320_000          # lifted
    assert run.steps_per_dispatch == 32            # lifted
    assert agent.cfg.updates_per_step == 2         # explicit flag wins
    assert agent.cfg.rollout_steps == 64           # lifted
    assert agent.cfg.batch_size == 8192            # lifted
    assert agent.cfg.ou_sigma_decay_env_steps == 64_000


def test_preset_fast_naf_merges_and_trains(capsys):
    """--preset fast --agent naf lifts the canary recipe (end-of-budget
    canary with restart budget 5); explicit flags still win, and a tiny
    end-to-end run through main() exercises the canary path on CPU."""
    from cartpoleplusplus_tpu.config import (RunConfig, explicit_dests,
                                             from_args)
    from cartpoleplusplus_tpu.train import _PRESETS, build, build_parser

    argv = ["--agent", "naf", "--preset", "fast", "--num-envs", "16"]
    args = build_parser().parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    import dataclasses as dc
    run = dc.replace(run, **{k: v
                             for k, v in _PRESETS["fast"]["naf"]["run"].items()
                             if k not in provided})
    env, agent = build(run, args, provided)
    assert run.num_envs == 16                      # explicit flag wins
    assert run.total_env_steps == 80_000           # lifted
    assert run.canary_env_steps == 80_000          # lifted
    assert run.canary_max_restarts == 5            # lifted
    rc = main(["--agent", "naf", "--preset", "fast", "--num-envs", "16",
               "--total-env-steps", "32", "--canary-env-steps", "32",
               "--canary-min-eval", "0", "--log-interval", "100",
               "--naf.hidden", "16", "16", "--naf.rollout-steps", "2",
               "--naf.updates-per-step", "1", "--naf.batch-size", "16",
               "--naf.replay-capacity-per-env", "8",
               "--naf.warmup-env-steps", "0", "--final-eval"])
    assert rc == 0
    out = capsys.readouterr().out
    assert '"canary_eval_mean"' in out and '"eval_reward_mean"' in out


def test_preset_fast_unknown_agent_errors(capsys):
    rc = main(["--agent", "dqn", "--preset", "fast",
               "--total-env-steps", "4"])
    assert rc == 2


def test_preset_fast_lrpg_trains_end_to_end(capsys):
    """--preset fast for lrpg lifts its recipe (2048 envs, dispatch
    16); explicit flags shrink it to CPU size and the run trains end to
    end."""
    rc = main(["--agent", "lrpg", "--preset", "fast",
               "--num-envs", "16", "--total-env-steps", "8",
               "--steps-per-dispatch", "2", "--log-interval", "1",
               "--lrpg.hidden", "16", "16", "--lrpg.rollout-steps", "2"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert np.isfinite(lines[-1]["loss"])
    assert lines[-1]["env_steps"] == 8.0


def test_preset_pixels_merges_without_clobbering():
    """--preset pixels lifts unset fields to the pixel-learning recipe
    (2048 envs / block sampling / 200k steps); explicitly-typed flags
    always win."""
    import dataclasses as dc

    from cartpoleplusplus_tpu.config import (RunConfig, explicit_dests,
                                             from_args)
    from cartpoleplusplus_tpu.train import _PRESETS, build, build_parser

    # batch-size 8 keeps the preset's block sampling valid at the tiny
    # debug env count (the construction guard requires batch | num_envs).
    argv = ["--agent", "ddpg", "--preset", "pixels", "--num-envs", "8",
            "--ddpg.batch-size", "8",
            "--render-size", "24", "--total-env-steps", "4"]
    args = build_parser().parse_args(argv)
    provided = explicit_dests(build_parser(), argv)
    run = from_args(RunConfig, args)
    run = dc.replace(run,
                     **{k: v
                        for k, v in _PRESETS["pixels"]["ddpg"]["run"].items()
                        if k not in provided})
    env, agent = build(run, args, provided)
    assert run.num_envs == 8                      # explicit flag wins
    assert run.obs_mode == "pixels"               # lifted
    assert run.render_grayscale and run.render_obs_uint8
    assert run.render_frame_diff and run.render_frame_diff_gain == 4.0
    assert env.obs_shape[-1] == 1 * 2 * env.params.action_repeats
    assert agent.cfg.actor_lr == 3e-4 and agent.cfg.critic_lr == 3e-4
    assert agent.cfg.updates_per_step == 16
    assert agent.cfg.lr_decay_env_steps == 100_000
    assert agent.cfg.sample == "block"
    assert agent.cfg.replay_capacity_per_env == 64
    assert agent.cfg.ou_sigma_decay_env_steps == 20_000


def test_ckpt_cadence_under_chunked_dispatch(tmp_path):
    """With --steps-per-dispatch > 1 saves land on chunk-boundary step
    indices (511, 1007, ...) that satisfy the interval window but not
    the manager's `step % interval == 0` policy; train.py forces those
    saves, and the LATEST checkpoint must be the final training state."""
    d = tmp_path / "ck"
    rc = main(["--agent", "dqn", "--num-envs", "16",
               "--total-env-steps", "256", "--steps-per-dispatch", "16",
               "--log-interval", "1000", "--ckpt-dir", str(d),
               "--ckpt-interval", "5", "--no-ckpt-full",
               "--dqn.hidden", "16", "--dqn.rollout-steps", "2",
               "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
               "--dqn.replay-capacity-per-env", "8",
               "--dqn.warmup-env-steps", "0"])
    assert rc == 0
    import glob
    import os.path as osp
    steps = sorted(int(osp.basename(x)) for x in glob.glob(str(d) + "/*")
                   if osp.basename(x).isdigit())
    # 128 train calls; saves trigger on every 16-call chunk whose window
    # crosses a multiple of 5; retention keeps the last 3 — the final
    # state (call 127) MUST be among them (the end-of-training save
    # guarantees it even when no window lands on the final call).
    assert steps and max(steps) == 127, steps
    # End-of-training save: an interval that never triggers mid-run
    # still leaves the FINAL state on disk.
    d2 = str(d) + "2"
    rc = main(["--agent", "dqn", "--num-envs", "16",
               "--total-env-steps", "64", "--steps-per-dispatch", "16",
               "--log-interval", "1000", "--ckpt-dir", d2,
               "--ckpt-interval", "10000", "--no-ckpt-full",
               "--dqn.hidden", "16", "--dqn.rollout-steps", "2",
               "--dqn.updates-per-step", "1", "--dqn.batch-size", "16",
               "--dqn.replay-capacity-per-env", "8",
               "--dqn.warmup-env-steps", "0"])
    assert rc == 0
    steps2 = sorted(int(osp.basename(x)) for x in glob.glob(d2 + "/*")
                    if osp.basename(x).isdigit())
    assert steps2 and max(steps2) == 31, steps2


def test_eval_only_restores_across_lr_config(tmp_path):
    """--eval-only must restore checkpoints written under a DIFFERENT lr
    configuration: an lr schedule changes the optax tree structure, and
    eval needs only weights — the restore excludes *opt fields + rng."""
    d = tmp_path / "ck"
    base = ["--agent", "naf", "--num-envs", "16",
            "--total-env-steps", "16", "--log-interval", "100",
            "--ckpt-dir", str(d),
            "--naf.hidden", "16", "16", "--naf.rollout-steps", "2",
            "--naf.updates-per-step", "1", "--naf.batch-size", "16",
            "--naf.replay-capacity-per-env", "8",
            "--naf.warmup-env-steps", "0"]
    assert main(base + ["--naf.lr-decay-env-steps", "8"]) == 0
    assert main(base + ["--eval-only", "--eval-steps", "8"]) == 0


def test_eval_only_restores_across_env_count(tmp_path, capsys):
    """--eval-only must restore checkpoints written under a DIFFERENT
    env count: evaluation resets its own envs, so every env-shaped state
    field (env_state, obs, noise, env_steps) is excluded from the
    restore request — a 4096-env training checkpoint stays evaluable in
    a small eval process (found on hardware, round 4: the 632k-config
    pixel run's checkpoint). Also exercises the target-sharding restore
    path (ckpt/checkpoint.py::_abstract_like + explicit restore_args),
    which cross-backend restores require."""
    d = tmp_path / "ck"
    common = ["--agent", "ddpg", "--total-env-steps", "16",
              "--log-interval", "100", "--ckpt-dir", str(d),
              "--ddpg.hidden", "16", "16", "--ddpg.rollout-steps", "2",
              "--ddpg.updates-per-step", "1", "--ddpg.batch-size", "16",
              "--ddpg.replay-capacity-per-env", "8",
              "--ddpg.warmup-env-steps", "0"]
    assert main(common + ["--num-envs", "16"]) == 0
    capsys.readouterr()
    assert main(common + ["--num-envs", "4", "--eval-only",
                          "--eval-steps", "64"]) == 0
    out = capsys.readouterr()
    stats = json.loads(out.out.strip())
    assert stats["episodes"] > 0
    assert "resumed" in out.err


def test_canary_restart_paths(capsys):
    """Collapse-detection canary (RunConfig.canary_*): a healthy run
    logs the canary eval and trains straight through; an (artificially)
    always-failing threshold triggers the re-seeded restart, exhausts
    canary_max_restarts, and the run still completes with a final
    training state."""
    base = ["--agent", "dqn", "--num-envs", "16", "--no-use-mesh",
            "--total-env-steps", "128", "--eval-steps", "40",
            "--canary-env-steps", "32", "--log-interval", "1000",
            "--dqn.rollout-steps", "8", "--dqn.batch-size", "16",
            "--dqn.updates-per-step", "1",
            "--dqn.replay-capacity-per-env", "32",
            "--dqn.warmup-env-steps", "0"]
    rc = main(base + ["--canary-min-eval", "0.5"])   # any policy passes
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    canary = [l for l in lines if "canary_eval_mean" in l]
    assert len(canary) == 1 and canary[0]["healthy"]
    assert canary[0]["attempt"] == 0

    rc = main(base + ["--canary-min-eval", "1e9",    # nothing passes
                      "--canary-max-restarts", "1"])
    assert rc == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    canary = [l for l in lines if "canary_eval_mean" in l]
    # attempt 0 fails -> restart; attempt 1 fails but is the last
    # allowed, so training continues and finishes.
    assert [c["attempt"] for c in canary] == [0, 1]
    assert not any(c["healthy"] for c in canary)
    assert lines[-1]["train_step"] == 128 // 8
