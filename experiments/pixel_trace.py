#!/usr/bin/env python
"""Device-side trace of the pixel-DDPG train step: runs N profiled train
calls at a given config and prints the top device ops by total time and
the device's idle share over the traced window, read with
`jax.profiler.ProfileData` (JAX only, no other tooling).

Usage: python experiments/pixel_trace.py [--envs 2048] [--replay 64]
           [--calls 32] [--out <dir>] [--top 25]
"""

import argparse
import collections
import glob
import os
import shutil
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def device_events(xplane_path):
    """(name, start_ns, duration_ns) of every op on the first device
    plane of an .xplane.pb."""
    from jax.profiler import ProfileData

    data = ProfileData.from_file(xplane_path)
    planes = [p for p in data.planes if p.name.startswith("/device:GPU")]
    if not planes:
        raise SystemExit("no GPU plane in the trace")
    return [(ev.name, ev.start_ns, ev.duration_ns)
            for line in planes[0].lines for ev in line.events]


def busy_ns(events):
    """Length of the union of the event intervals."""
    total, end = 0.0, None
    for _, s, d in sorted(events, key=lambda e: e[1]):
        e = s + d
        if end is None or s > end:
            total += d
            end = e
        elif e > end:
            total += e - end
            end = e
    return total


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--envs", type=int, default=2048)
    ap.add_argument("--replay", type=int, default=64)
    ap.add_argument("--updates", type=int, default=16)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--calls", type=int, default=32)
    ap.add_argument("--scan", type=int, default=16)
    ap.add_argument("--sample", default="block")
    ap.add_argument("--out", default="")
    ap.add_argument("--top", type=int, default=25)
    args = ap.parse_args()

    import jax

    from cartpoleplusplus_tpu import CartPole3D
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.env.pixels import RenderConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params
    from cartpoleplusplus_tpu.train import enable_compile_cache

    enable_compile_cache()
    rcfg = RenderConfig(grayscale=True, obs_uint8=True, frame_diff=True,
                        frame_diff_gain=4.0)
    env = CartPole3D(continuous_params(), num_envs=args.envs,
                     obs_mode="pixels", render_config=rcfg)
    agent = DDPG(env, DDPGConfig(rollout_steps=8,
                                 updates_per_step=args.updates,
                                 batch_size=args.batch,
                                 warmup_env_steps=0, sample=args.sample,
                                 replay_capacity_per_env=args.replay))
    st = agent.init(0)
    scan = agent.make_train_scan(args.scan)
    st, m = jax.block_until_ready(scan(st))   # compile + fill some replay

    out = args.out or tempfile.mkdtemp(prefix="pixel_trace_")
    shutil.rmtree(out, ignore_errors=True)
    jax.profiler.start_trace(out)
    for _ in range(max(args.calls // args.scan, 1)):
        st, m = scan(st)
    jax.block_until_ready((st, m))
    jax.profiler.stop_trace()

    files = glob.glob(os.path.join(out, "plugins/profile/*/*.xplane.pb"))
    events = device_events(files[0])
    n_steps = max(args.calls // args.scan, 1) * args.scan
    window = (max(s + d for _, s, d in events)
              - min(s for _, s, _ in events))
    by_name = collections.Counter()
    for name, _, d in events:
        by_name[name[:110]] += d
    total = sum(by_name.values())
    print(f"# {n_steps} train calls: device op time {total / 1e6:.3f} ms "
          f"({total / 1e3 / n_steps:.1f} us/call), idle share "
          f"{1.0 - busy_ns(events) / window:.4f} of the traced window")
    print(f"{'us/call':>9}  op")
    for name, t in by_name.most_common(args.top):
        print(f"{t / 1e3 / n_steps:9.1f}  {name}")


if __name__ == "__main__":
    main()
