#!/usr/bin/env python
"""On-card smoke test: the main path runs on the GPU and gives right answers.

    python chip_smoke.py               # one GPU: phases (a)-(e)
    python chip_smoke.py --four-cards  # four GPUs: the sharded path only

One card, full widths, through the entry points a user calls:
  (a) rollout — the fused Triton env kernel vs the XLA scan over
      env.step at 4096 envs x 64 steps (discrete and continuous), then
      both timed at 4096 x 4096;
  (b) ddpg — `train.main` with the default DDPG recipe at 4096 envs,
      checkpointing to a temp dir, then resuming from it;
  (c) agents — DQN, NAF, LRPG at their defaults, NAF and LRPG under
      `--preset fast`;
  (d) pixels — `--agent ddpg --preset pixels`, plus the render alone;
  (e) nets — every net's forward on the card vs a numpy float64 forward
      of the same params, at `highest` matmul precision and at the
      backend default (TF32).
Training phases also time the steady-state train step of the same
configuration. `--four-cards`: DDPG at 8192 envs through `train.main`
with `--learner spmd` and `--learner shardmap`; the sharded env-only
rollout vs its one-card run; the first sharded learner step's losses vs
the one-card step at `highest` precision.

Every phase prints one JSON line. The line before the last is
`nvidia-smi`'s name and power limit; the last line is
{"ok": true, "device": {...}} — printed only when every phase passed.
Outside a checkout of the repo, or without a GPU, the script exits
non-zero before any phase.
"""

import contextlib
import io
import json
import subprocess
import sys
import tempfile
import time
import traceback

NUM_ENVS = 4096


def emit(line: dict):
    print(json.dumps(line), flush=True)


def nvidia_smi() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable: {e}"


class PhaseFailed(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseFailed(msg)


def _maxerr(a, b) -> float:
    import numpy as np
    return float(np.max(np.abs(np.asarray(a, np.float64)
                               - np.asarray(b, np.float64))))


# --- running train.main --------------------------------------------------

def run_main(argv):
    """train.main(argv) with its stdout/stderr captured; returns (metric
    lines, stderr text)."""
    from cartpoleplusplus_tpu import train

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = train.main(argv)
    check(rc == 0, f"train.main{argv} returned {rc}: {err.getvalue()[-2000:]}")
    lines = [json.loads(ln) for ln in out.getvalue().splitlines()
             if ln.startswith("{")]
    return lines, err.getvalue()


def last_metrics(lines, loss_key):
    rows = [ln for ln in lines if loss_key in ln]
    check(rows, f"no metric line with {loss_key!r}")
    last = rows[-1]
    import math
    check(math.isfinite(last[loss_key]) and last[loss_key] != 0.0,
          f"{loss_key}={last[loss_key]} after training")
    return last


def steady_step(argv, calls: int = 10):
    """Steady-state time of the train dispatch `train.main(argv)` runs
    (same agent, same chunking; compiled once before the window)."""
    import jax

    from cartpoleplusplus_tpu import train

    run, args, provided = train.parse_run(argv)
    _, agent = train.build(run, args, provided)
    spd = max(run.steps_per_dispatch, 1)
    step = agent.make_train_scan(spd) if spd > 1 else agent.make_train_step()
    st = agent.init(run.seed)
    for _ in range(2):      # compile, then pass the replay warmup gate
        st, m = jax.block_until_ready(step(st))
    t0 = time.perf_counter()
    for _ in range(calls):
        st, m = step(st)
    jax.block_until_ready((st, m))
    dt = time.perf_counter() - t0
    n_steps = calls * spd
    return {"ms_per_train_step": 1e3 * dt / n_steps,
            "env_steps_per_sec": (n_steps * agent.cfg.rollout_steps
                                  * run.num_envs / dt),
            "num_envs": run.num_envs, "steps_per_dispatch": spd}


# --- one-card phases -----------------------------------------------------

def phase_rollout():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
    from cartpoleplusplus_tpu.bench import measure_env_steps_per_sec
    from cartpoleplusplus_tpu.ops import (best_rollout, pallas_rollout,
                                          reference_rollout)
    from cartpoleplusplus_tpu.physics.params import continuous_params

    res = {}
    for name, params in (("discrete", CartPoleParams()),
                         ("continuous", continuous_params())):
        env = CartPole3D(params, num_envs=NUM_ENVS)
        check(best_rollout(env, 8)[1] == "triton_fused",
              "best_rollout did not pick the kernel on the GPU")
        s0, _ = jax.jit(env.reset)(0)
        sk, ak = pallas_rollout(env, 64)(jax.tree.map(jnp.copy, s0))
        sr, ar = reference_rollout(env, 64)(s0)
        err = {f: _maxerr(getattr(sk.phys, f), getattr(sr.phys, f))
               for f in ("pos", "s", "vel", "sd")}
        for f, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                       ("sd", 5e-4)):
            np.testing.assert_allclose(
                np.asarray(getattr(sk.phys, f)),
                np.asarray(getattr(sr.phys, f)), rtol=tol, atol=tol,
                err_msg=f"{name}: phys.{f}")
        check(np.array_equal(sk.steps, sr.steps), f"{name}: steps differ")
        check(np.array_equal(sk.episode, sr.episode),
              f"{name}: episodes differ")
        rel = abs(float(ak) - float(ar)) / max(abs(float(ar)), 1.0)
        check(rel < 1e-4, f"{name}: checksum rel err {rel}")
        times = {}
        for impl, fn in (("triton_fused", pallas_rollout(env, 4096)),
                         ("xla_scan", reference_rollout(env, 4096))):
            st = measure_env_steps_per_sec(env, num_steps=4096, repeats=3,
                                           rollout=fn)
            times[impl] = {"best_seconds": st["best_seconds"],
                           "env_steps_per_sec": st["env_steps_per_sec"]}
        res[name] = {"max_abs_err_64": err, "checksum_rel_err": rel,
                     "timing_4096x4096": times}
    return res


def phase_ddpg():
    import numpy as np

    from cartpoleplusplus_tpu import train
    from cartpoleplusplus_tpu.ckpt import CheckpointManager

    ck = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    base = ["--agent", "ddpg", "--num-envs", str(NUM_ENVS),
            "--log-interval", "1", "--ckpt-dir", ck, "--ckpt-interval", "4"]
    lines, _ = run_main(base + ["--total-env-steps", "64"])
    first = last_metrics(lines, "critic_loss")
    lines, err = run_main(base + ["--total-env-steps", "128"])
    check("resumed from step 7" in err, f"no resume: {err[-500:]}")
    resumed = last_metrics(lines, "critic_loss")
    check(resumed["env_steps"] == 128, f"resume ended at {resumed}")
    run, args, provided = train.parse_run(base)
    _, agent = train.build(run, args, provided)
    fresh = agent.init(run.seed)
    with CheckpointManager(ck) as mgr:
        check(mgr.latest_step() == 15, f"latest ckpt {mgr.latest_step()}")
        restored = mgr.restore(agent.init(run.seed))
    moved = max(_maxerr(a, b) for a, b in zip(
        _leaves(fresh.actor), _leaves(restored.actor)))
    check(moved > 0.0, "actor params unchanged after training")
    check(all(np.isfinite(np.asarray(x)).all()
              for x in _leaves(restored.critic)), "non-finite critic")
    return {"first_run": _pick(first), "resumed_run": _pick(resumed),
            "actor_max_change": moved,
            "steady": steady_step(base + ["--total-env-steps", "64"])}


def _leaves(tree):
    import jax
    return jax.tree.leaves(tree)


def _pick(line):
    return {k: line[k] for k in line
            if k in ("critic_loss", "actor_loss", "loss", "env_steps",
                     "reward_mean", "done_frac")}


def phase_agents():
    cases = {
        "dqn": (["--agent", "dqn", "--total-env-steps", "32"], "loss"),
        "naf": (["--agent", "naf", "--total-env-steps", "32"], "loss"),
        "lrpg": (["--agent", "lrpg", "--total-env-steps", "128"], "loss"),
        "naf_fast": (["--agent", "naf", "--preset", "fast",
                      "--total-env-steps", "256",
                      "--canary-env-steps", "0"], "loss"),
        "lrpg_fast": (["--agent", "lrpg", "--preset", "fast",
                       "--total-env-steps", "1024"], "loss"),
    }
    res = {}
    for name, (argv, key) in cases.items():
        argv = argv + ["--log-interval", "1"]
        lines, _ = run_main(argv)
        res[name] = {"last": _pick(last_metrics(lines, key)),
                     "steady": steady_step(argv)}
    return res


def phase_pixels():
    import jax

    from cartpoleplusplus_tpu import train

    argv = ["--agent", "ddpg", "--preset", "pixels",
            "--total-env-steps", "256", "--canary-env-steps", "0"]
    lines, _ = run_main(argv)
    last = last_metrics(lines, "critic_loss")
    run, args, provided = train.parse_run(argv)
    env, _ = train.build(run, args, provided)
    st, _ = jax.jit(env.reset)(0)
    render = jax.jit(env.render)
    jax.block_until_ready(render(st.phys))
    t0 = time.perf_counter()
    for _ in range(20):
        img = render(st.phys)
    jax.block_until_ready(img)
    render_ms = 1e3 * (time.perf_counter() - t0) / 20
    return {"last": _pick(last), "obs_shape": list(env.obs_shape),
            "render_ms_all_cameras": render_ms,
            "render_shape": list(img.shape),
            "steady": steady_step(argv, calls=4)}


def phase_nets():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cartpoleplusplus_tpu.models import (ActorMLP, CriticMLP, NafNet,
                                             PixelEncoder, PolicyMLP,
                                             QNetMLP, reference)

    rng = np.random.default_rng(0)
    obs = rng.normal(size=(256, 42)).astype(np.float32)
    act = rng.uniform(-1, 1, size=(256, 2)).astype(np.float32)
    img = rng.integers(0, 256, size=(64, 48, 48, 6)).astype(np.uint8)
    nets = {"actor": (ActorMLP(), (obs,)),
            "critic": (CriticMLP(), (obs, act)),
            "qnet": (QNetMLP(), (obs,)),
            "policy": (PolicyMLP(), (obs,)),
            "naf": (NafNet(), (obs, act)),
            "pixel_encoder": (PixelEncoder(), (img,))}
    tols = {"highest": 1e-5, "default": 2e-3}
    res = {}
    for name, (net, inputs) in nets.items():
        params = net.init(jax.random.PRNGKey(0), *inputs)
        want = jax.tree.leaves(reference.forward(net, params, *inputs))
        errs = {}
        for prec, tol in tols.items():
            ctx = (jax.default_matmul_precision("highest")
                   if prec == "highest" else contextlib.nullcontext())
            with ctx:
                got = jax.tree.leaves(jax.jit(net.apply)(
                    params, *map(jnp.asarray, inputs)))
            errs[prec] = max(_maxerr(g, w) / max(np.max(np.abs(w)), 1e-6)
                             for g, w in zip(got, want))
            check(errs[prec] < tol,
                  f"{name} at {prec} precision: rel err {errs[prec]} "
                  f">= {tol}")
        res[name] = errs
    return {"rel_err": res, "tolerance": tols}


# --- four-card phases ----------------------------------------------------

NUM_ENVS_SHARDED = 8192   # BASELINE.json:11


def phase_sharded_train():
    import jax

    from cartpoleplusplus_tpu import train
    from cartpoleplusplus_tpu.dist import (DATA_AXIS, make_mesh,
                                           make_shardmap_train_step,
                                           shard_agent_state)
    from cartpoleplusplus_tpu.dist.train import make_distributed_train_step

    res = {}
    base = ["--agent", "ddpg", "--num-envs", str(NUM_ENVS_SHARDED),
            "--total-env-steps", "64", "--log-interval", "1"]
    for learner in ("spmd", "shardmap"):
        lines, _ = run_main(base + ["--learner", learner])
        res[learner] = {"last": _pick(last_metrics(lines, "critic_loss"))}

    run, args, provided = train.parse_run(base)
    env, agent = train.build(run, args, provided)
    mesh = make_mesh()
    local = type(agent)(
        type(env)(env.params, num_envs=env.num_envs // mesh.size),
        agent.cfg, dist_axis=DATA_AXIS, num_shards=mesh.size)

    def timed(step, st, calls=10):
        for _ in range(2):
            st, m = jax.block_until_ready(step(st))
        t0 = time.perf_counter()
        for _ in range(calls):
            st, m = step(st)
        jax.block_until_ready((st, m))
        dt = (time.perf_counter() - t0) / calls
        return {"ms_per_train_step": 1e3 * dt,
                "env_steps_per_sec": (agent.cfg.rollout_steps
                                      * env.num_envs / dt)}

    st = shard_agent_state(agent.init(0), mesh)
    res["spmd"]["steady"] = timed(
        make_distributed_train_step(agent, mesh, st), st)
    st = shard_agent_state(agent.init(0), mesh)
    res["shardmap"]["steady"] = timed(
        make_shardmap_train_step(local, mesh, st), st)
    one = jax.device_put(agent.init(0), jax.devices()[0])
    res["one_card_steady"] = timed(agent.make_train_step(), one)
    return res


def phase_sharded_rollout():
    import jax
    import jax.numpy as jnp
    import numpy as np

    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.bench import build_rollout
    from cartpoleplusplus_tpu.dist import make_mesh, shard_batch_tree
    from cartpoleplusplus_tpu.physics.params import continuous_params

    env = CartPole3D(continuous_params(), num_envs=NUM_ENVS_SHARDED)
    s0, _ = jax.jit(env.reset)(0)
    s_one = jax.device_put(jax.tree.map(jnp.copy, s0), jax.devices()[0])
    s_sh = shard_batch_tree(jax.tree.map(jnp.copy, s0), make_mesh())
    run = build_rollout(env, 64, donate=False)
    r1, a1 = run(s_one)
    r4, a4 = run(s_sh)
    check(len(r4.steps.sharding.device_set) == 4, "rollout not sharded")
    check(np.array_equal(r1.steps, r4.steps), "steps differ")
    check(np.array_equal(r1.episode, r4.episode), "episodes differ")
    err = {}
    for f, tol in (("pos", 2e-5), ("s", 2e-5), ("vel", 5e-4),
                   ("sd", 5e-4)):
        np.testing.assert_allclose(np.asarray(getattr(r4.phys, f)),
                                   np.asarray(getattr(r1.phys, f)),
                                   rtol=tol, atol=tol, err_msg=f)
        err[f] = _maxerr(getattr(r4.phys, f), getattr(r1.phys, f))
    rel = abs(float(a4) - float(a1)) / max(abs(float(a1)), 1.0)
    check(rel < 1e-4, f"checksum rel err {rel}")
    return {"max_abs_err": err, "checksum_rel_err": rel}


def phase_sharded_first_step():
    import jax
    import numpy as np

    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.dist import make_mesh, shard_agent_state
    from cartpoleplusplus_tpu.dist.train import make_distributed_train_step
    from cartpoleplusplus_tpu.physics.params import continuous_params

    env = CartPole3D(continuous_params(), num_envs=NUM_ENVS_SHARDED)
    agent = DDPG(env, DDPGConfig(warmup_env_steps=0))
    mesh = make_mesh()
    with jax.default_matmul_precision("highest"):
        st1 = jax.device_put(agent.init(0), jax.devices()[0])
        _, m1 = agent.make_train_step()(st1)
        st4 = shard_agent_state(agent.init(0), mesh)
        _, m4 = make_distributed_train_step(agent, mesh, st4)(st4)
    res = {}
    for k in ("critic_loss", "actor_loss"):
        a, b = float(m1[k]), float(m4[k])
        rel = abs(a - b) / max(abs(a), 1e-6)
        res[k] = {"one_card": a, "four_cards": b, "rel_err": rel}
        check(np.isfinite(b) and rel < 1e-4, f"{k}: {a} vs {b}")
    return res


ONE_CARD = (("rollout", phase_rollout), ("ddpg", phase_ddpg),
            ("agents", phase_agents), ("pixels", phase_pixels),
            ("nets", phase_nets))
FOUR_CARDS = (("sharded_train", phase_sharded_train),
              ("sharded_rollout", phase_sharded_rollout),
              ("sharded_first_step", phase_sharded_first_step))


def main(argv) -> int:
    try:
        import cartpoleplusplus_tpu  # noqa: F401
    except ImportError as e:
        print(f"chip_smoke: run it from the root of a checkout of the "
              f"repo ({e})", file=sys.stderr)
        return 2
    import jax

    four = "--four-cards" in argv
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: needs a GPU; JAX found {devices[0].platform!r}",
              file=sys.stderr)
        return 2
    need = 4 if four else 1
    if len(devices) < need:
        print(f"chip_smoke: needs {need} GPUs; JAX found {len(devices)}",
              file=sys.stderr)
        return 2
    from cartpoleplusplus_tpu.train import enable_compile_cache

    enable_compile_cache()
    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi,
          "device_kind": devices[0].device_kind, "count": len(devices),
          "jax": jax.__version__})
    ok = True
    for name, fn in (FOUR_CARDS if four else ONE_CARD):
        t0 = time.perf_counter()
        try:
            res = {"ok": True, **fn()}
        except Exception as e:  # report every phase, then fail
            traceback.print_exc()
            res = {"ok": False, "error": f"{type(e).__name__}: {e}"[:2000]}
        res["seconds"] = time.perf_counter() - t0
        emit({"phase": name, **res})
        ok = ok and res["ok"]
    if not ok:
        print("chip_smoke: a phase failed", file=sys.stderr)
        return 1
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": devices[0].platform,
                                 "kind": devices[0].device_kind,
                                 "count": len(devices)}})
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
