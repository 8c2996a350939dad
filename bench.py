#!/usr/bin/env python
"""Throughput benchmark: env-steps/s per device (BASELINE.json:5).

`python bench.py` runs the env cell: the discrete env rollout at 4096
envs x 4096 steps through `best_rollout` (the fused Triton kernel on a
GPU) and, beside it, the XLA scan over env.step it is chosen over. It
prints one JSON line per implementation; the FIRST line is the headline
(the chosen implementation). Every line names the device it ran on.

BENCH_CONFIG selects another cell: continuous (the same rollout on the
continuous env), ddpg, dqn, naf, lrpg (each agent's end-to-end train
loop), pixels (pixel env rollout), ddpg_pixels (pixel-DDPG training).
BENCH_NUM_ENVS / BENCH_NUM_STEPS override the shape. `python bench.py
--suite` runs every cell, one subprocess at a time (one JAX process per
card), and writes BENCH_SUITE.json.
"""

import json
import os
import sys
import time


def _emit(line: dict, stream=sys.stdout):
    print(json.dumps(line), file=stream, flush=True)


def main():
    if "--suite" in sys.argv or os.environ.get("BENCH_SUITE") == "1":
        return bench_suite()
    import jax

    from cartpoleplusplus_tpu.train import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        # A rate measured here would be a CPU number under a device
        # metric's name.
        raise SystemExit(f"bench.py measures a GPU; JAX found "
                         f"{jax.devices()[0].platform!r}")
    enable_compile_cache()
    num_envs = int(os.environ.get("BENCH_NUM_ENVS", "4096"))
    num_steps = int(os.environ.get("BENCH_NUM_STEPS", "4096"))
    config = os.environ.get("BENCH_CONFIG", "discrete")
    cells = {"ddpg": bench_ddpg, "dqn": bench_dqn, "naf": bench_naf,
             "lrpg": bench_lrpg, "pixels": bench_pixels,
             "ddpg_pixels": bench_ddpg_pixels}
    if config in cells:
        return cells[config](num_envs, num_steps)
    if config not in ("discrete", "continuous"):
        raise SystemExit(f"unknown BENCH_CONFIG {config!r}")
    return bench_env(config, num_envs, num_steps)


def bench_env(config: str, num_envs: int, num_steps: int):
    """The env cell: best_rollout first (the headline), then the XLA
    scan it is chosen over, at the same shape."""
    from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu.bench import measure_env_steps_per_sec
    from cartpoleplusplus_tpu.ops import best_rollout, reference_rollout
    from cartpoleplusplus_tpu.physics.params import continuous_params

    params = continuous_params() if config == "continuous" \
        else CartPoleParams()
    env = CartPole3D(params, num_envs=num_envs)
    rollout, impl = best_rollout(env, num_steps)
    runs = [(impl, rollout)]
    if impl != "xla_scan":
        runs.append(("xla_scan", reference_rollout(env, num_steps)))
    for name, fn in runs:
        stats = measure_env_steps_per_sec(env, num_steps=num_steps,
                                          repeats=3, rollout=fn)
        _emit({"metric": f"{config}_env_steps_per_sec_{num_envs}envs",
               "value": stats["env_steps_per_sec"], "unit": "env-steps/s",
               "impl": name, **stats})


def _time_train(agent, rollout: int, num_envs: int, num_steps: int,
                trials: int = 3):
    """Time an agent's end-to-end train loop: BENCH_SCAN train steps per
    jitted dispatch (agents.make_train_scan; default 16 amortizes the
    per-dispatch cost; BENCH_SCAN=1 is one jit call per train step).
    Returns (env_steps_per_sec, info dict)."""
    import jax

    scan = max(int(os.environ.get("BENCH_SCAN", "16")), 1)
    n_calls = max(num_steps // rollout, 1)
    n_dispatch = max(n_calls // scan, 1)
    st = agent.init(0)
    step = agent.make_train_scan(scan) if scan > 1 \
        else agent.make_train_step()
    t0 = time.perf_counter()
    st, m = jax.block_until_ready(step(st))
    first = time.perf_counter() - t0
    best = float("inf")
    for _ in range(trials):
        t0 = time.perf_counter()
        for _ in range(n_dispatch):
            st, m = step(st)
        jax.block_until_ready((st, m))
        best = min(best, time.perf_counter() - t0)
    rate = n_dispatch * scan * rollout * num_envs / best
    return rate, {"scan": scan, "n_dispatch": n_dispatch,
                  "best_seconds": best, "compile_and_first_seconds": first}


def _emit_train(name: str, num_envs: int, rate: float, info: dict):
    from cartpoleplusplus_tpu.bench import device_info

    _emit({"metric": f"{name}_train_env_steps_per_sec_{num_envs}envs",
           "value": rate, "unit": "env-steps/s", **info, **device_info()})


def bench_ddpg(num_envs: int, num_steps: int):
    """End-to-end DDPG actor-learner env-steps/s: rollout scan + device
    replay insert + K gradient updates per train step."""
    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    rollout = int(os.environ.get("BENCH_DDPG_ROLLOUT", "64"))
    updates = int(os.environ.get("BENCH_DDPG_UPDATES", "8"))
    batch = int(os.environ.get("BENCH_DDPG_BATCH", "8192"))
    dtype = os.environ.get("BENCH_DDPG_DTYPE", "float32")
    # Per-env replay ring length: the default 1024 slots x 42-f32 obs
    # is ~2.9 GB at 16384 envs — shrink it to bench very large env
    # counts (the sampling distribution changes, not the step cost).
    cap = int(os.environ.get("BENCH_DDPG_REPLAY", "1024"))
    env = CartPole3D(continuous_params(), num_envs=num_envs)
    agent = DDPG(env, DDPGConfig(rollout_steps=rollout,
                                 updates_per_step=updates,
                                 batch_size=batch, warmup_env_steps=0,
                                 dtype=dtype, replay_capacity_per_env=cap))
    rate, info = _time_train(agent, rollout, num_envs, num_steps)
    _emit_train("ddpg", num_envs, rate,
                {"rollout_steps": rollout, "updates_per_step": updates,
                 "batch_size": batch, "dtype": dtype, **info})


def bench_dqn(num_envs: int, num_steps: int):
    """End-to-end DQN train env-steps/s: epsilon-greedy rollout + device
    replay insert + TD updates."""
    from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu.agents import DQN, DQNConfig

    rollout = int(os.environ.get("BENCH_DQN_ROLLOUT", "64"))
    updates = int(os.environ.get("BENCH_DQN_UPDATES", "8"))
    batch = int(os.environ.get("BENCH_DQN_BATCH", "8192"))
    env = CartPole3D(CartPoleParams(), num_envs=num_envs)
    agent = DQN(env, DQNConfig(rollout_steps=rollout,
                               updates_per_step=updates,
                               batch_size=batch, warmup_env_steps=0))
    rate, info = _time_train(agent, rollout, num_envs, num_steps)
    _emit_train("dqn", num_envs, rate,
                {"rollout_steps": rollout, "updates_per_step": updates,
                 "batch_size": batch, **info})


def bench_naf(num_envs: int, num_steps: int):
    """End-to-end NAF actor-learner env-steps/s: Gaussian-exploration
    rollout + device replay insert + K quadratic-advantage TD updates."""
    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.agents import NAF, NAFConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    rollout = int(os.environ.get("BENCH_NAF_ROLLOUT", "64"))
    updates = int(os.environ.get("BENCH_NAF_UPDATES", "8"))
    batch = int(os.environ.get("BENCH_NAF_BATCH", "8192"))
    env = CartPole3D(continuous_params(), num_envs=num_envs)
    agent = NAF(env, NAFConfig(rollout_steps=rollout,
                               updates_per_step=updates,
                               batch_size=batch, warmup_env_steps=0))
    rate, info = _time_train(agent, rollout, num_envs, num_steps)
    _emit_train("naf", num_envs, rate,
                {"rollout_steps": rollout, "updates_per_step": updates,
                 "batch_size": batch, **info})


def bench_lrpg(num_envs: int, num_steps: int):
    """End-to-end LRPG on-policy training env-steps/s: softmax-sampling
    rollout + returns-to-go + one policy update per window."""
    from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu.agents import LRPG, LRPGConfig

    rollout = int(os.environ.get("BENCH_LRPG_ROLLOUT", "32"))
    env = CartPole3D(CartPoleParams(), num_envs=num_envs)
    agent = LRPG(env, LRPGConfig(rollout_steps=rollout))
    rate, info = _time_train(agent, rollout, num_envs, num_steps)
    _emit_train("lrpg", num_envs, rate, {"rollout_steps": rollout, **info})


def _render_info(rc) -> dict:
    return {"dtype": rc.dtype, "obs_uint8": rc.obs_uint8,
            "grayscale": rc.grayscale, "width": rc.width,
            "height": rc.height, "cameras": len(rc.cameras),
            "frame_diff": rc.frame_diff,
            "frame_diff_gain": rc.frame_diff_gain}


def bench_pixels(num_envs: int, num_steps: int):
    """Pixel-observation env throughput (BASELINE config 4): full
    env.step with 2-camera 48x48 rendering per action repeat. Batch and
    step count default smaller than the state bench (each env-step
    renders 6 frames)."""
    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.bench import measure_env_steps_per_sec
    from cartpoleplusplus_tpu.env.pixels import RenderConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    if "BENCH_NUM_ENVS" not in os.environ:
        num_envs = 1024
    if "BENCH_NUM_STEPS" not in os.environ:
        num_steps = 256
    rc = RenderConfig(dtype=os.environ.get("BENCH_PIXELS_DTYPE", "bfloat16"),
                      obs_uint8=os.environ.get("BENCH_PIXELS_U8", "0") == "1",
                      grayscale=os.environ.get("BENCH_PIXELS_GRAY",
                                               "0") == "1")
    env = CartPole3D(continuous_params(), num_envs=num_envs,
                     obs_mode="pixels", render_config=rc)
    stats = measure_env_steps_per_sec(env, num_steps=num_steps, repeats=3)
    frames = (len(rc.cameras) * env.params.action_repeats
              * stats["env_steps_per_sec"])
    _emit({"metric": f"pixel_env_steps_per_sec_{num_envs}envs",
           "value": stats["env_steps_per_sec"], "unit": "env-steps/s",
           "rendered_frames_per_sec": frames, "render": _render_info(rc),
           **stats})


def bench_ddpg_pixels(num_envs: int, num_steps: int):
    """End-to-end pixel-DDPG training env-steps/s (BASELINE config 4).
    Defaults mirror `--preset pixels` (grayscale uint8 48x48 2-camera
    obs with gain-4 frame-diff, block sampling, 16 updates x 256 batch
    per 8-step rollout). BENCH_PIX_UPDATES=0 isolates rollout + render
    + insert."""
    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.env.pixels import RenderConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    if "BENCH_NUM_ENVS" not in os.environ:
        num_envs = 2048
    if "BENCH_NUM_STEPS" not in os.environ:
        num_steps = 1024
    rollout = int(os.environ.get("BENCH_PIX_ROLLOUT", "8"))
    updates = int(os.environ.get("BENCH_PIX_UPDATES", "16"))
    batch = int(os.environ.get("BENCH_PIX_BATCH", "256"))
    cap = int(os.environ.get("BENCH_PIX_REPLAY", "64"))
    smp = os.environ.get("BENCH_PIX_SAMPLE", "block")
    rc = RenderConfig(grayscale=True, obs_uint8=True, frame_diff=True,
                      frame_diff_gain=4.0)
    env = CartPole3D(continuous_params(), num_envs=num_envs,
                     obs_mode="pixels", render_config=rc)
    agent = DDPG(env, DDPGConfig(rollout_steps=rollout,
                                 updates_per_step=updates,
                                 batch_size=batch, warmup_env_steps=0,
                                 sample=smp, replay_capacity_per_env=cap))
    rate, info = _time_train(agent, rollout, num_envs, num_steps)
    _emit_train("pixel_ddpg", num_envs, rate,
                {"rollout_steps": rollout, "updates_per_step": updates,
                 "batch_size": batch, "replay_capacity_per_env": cap,
                 "sample": smp, "render": _render_info(rc),
                 "obs_shape": list(env.obs_shape), **info})


def bench_suite():
    """`python bench.py --suite`: every cell as ONE artifact. Runs each
    config in a fresh subprocess, ONE AT A TIME — a JAX process reserves
    most of the card's memory, so two at once would fail — collects
    every JSON line it prints and writes BENCH_SUITE.json at the repo
    root. BENCH_SUITE_CONFIGS / BENCH_SUITE_TIMEOUT tune it."""
    import subprocess

    root = os.path.dirname(os.path.abspath(__file__))
    configs = os.environ.get(
        "BENCH_SUITE_CONFIGS",
        "discrete,continuous,ddpg,dqn,naf,lrpg,pixels,ddpg_pixels").split(",")
    per_timeout = float(os.environ.get("BENCH_SUITE_TIMEOUT", "900"))
    out = {"results": {}}
    for cfg in configs:
        cfg = cfg.strip()
        env = dict(os.environ, BENCH_CONFIG=cfg)
        env.pop("BENCH_SUITE", None)
        t0 = time.perf_counter()
        try:
            proc = subprocess.run(
                [sys.executable, os.path.abspath(__file__)], env=env,
                capture_output=True, text=True, timeout=per_timeout,
                cwd=root)
            lines = []
            for ln in proc.stdout.splitlines():
                if ln.strip().startswith("{"):
                    try:
                        lines.append(json.loads(ln))
                    except ValueError:
                        pass
            out["results"][cfg] = {"rc": proc.returncode, "lines": lines,
                                   "seconds": time.perf_counter() - t0}
        except subprocess.TimeoutExpired:
            out["results"][cfg] = {"rc": "timeout", "seconds": per_timeout}
        headline = next(iter(out["results"][cfg].get("lines", [])), None)
        _emit({"config": cfg, **(headline or
                                 {"error": out["results"][cfg]["rc"]})})
    path = os.path.join(root, "BENCH_SUITE.json")
    with open(path, "w") as f:
        json.dump(out, f, indent=1)
    print(f"wrote {path}", file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
