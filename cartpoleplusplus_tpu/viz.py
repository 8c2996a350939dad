"""Visual inspection CLI — render rollouts to image files.

Reference counterpart: pybullet GUI mode (`pybullet.GUI` + `--delay`),
the reference's tool for human visual inspection of episodes, plus the
event-log reader's PNG dump (SURVEY.md §4 item 2, §3.5). A headless
accelerator host has no interactive GUI; the equivalent capability is
offline frame dumps from the same on-device
raycaster that produces pixel observations.

Usage:
    python -m cartpoleplusplus_tpu.viz --steps 60 --out /tmp/frames
    python -m cartpoleplusplus_tpu.viz --policy random --width 128

Writes one PNG (if matplotlib is available) or binary PPM per env-step,
using camera 0 of the pixel-observation RenderConfig.
"""

from __future__ import annotations

import argparse
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np

from . import CartPole3D, CartPoleParams
from .env.pixels import CameraConfig, RenderConfig, render


def _write_ppm(path: str, img: np.ndarray) -> None:
    """Dependency-free binary PPM (P6) writer. img: (H, W, 3) u8."""
    h, w, _ = img.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(img.tobytes())


def save_frame(path_base: str, img01: np.ndarray) -> str:
    """Save one float [0,1] frame as PNG (matplotlib) or PPM fallback."""
    img = (np.clip(img01, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    try:
        import matplotlib.image as mpimg

        mpimg.imsave(path_base + ".png", img)
        return path_base + ".png"
    except ImportError:
        _write_ppm(path_base + ".ppm", img)
        return path_base + ".ppm"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="cartpoleplusplus_tpu.viz",
                                 description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--out", default="/tmp/cartpole_frames")
    ap.add_argument("--width", type=int, default=128)
    ap.add_argument("--height", type=int, default=128)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--policy", choices=["noop", "random"], default="noop")
    ap.add_argument("--env-index", type=int, default=0,
                    help="which env of the small batch to record")
    args = ap.parse_args(argv)

    params = CartPoleParams()
    env = CartPole3D(params, num_envs=4)
    cam = CameraConfig()
    cfg = RenderConfig(width=args.width, height=args.height, cameras=(cam,))
    state, _ = jax.jit(env.reset)(args.seed)
    step = jax.jit(env.step)
    frame_fn = jax.jit(lambda ph: render(params, ph, cfg, cam))

    os.makedirs(args.out, exist_ok=True)
    key = jax.random.PRNGKey(args.seed)
    paths = []
    for t in range(args.steps):
        img = np.asarray(frame_fn(state.phys))[args.env_index]
        paths.append(save_frame(os.path.join(args.out, f"step{t:04d}"), img))
        if args.policy == "random":
            key, k = jax.random.split(key)
            action = jax.random.randint(k, (4,), 0, 5)
        else:
            action = jnp.zeros((4,), jnp.int32)
        state, _, _, done, _ = step(state, action)
    print(f"wrote {len(paths)} frames to {args.out} "
          f"({os.path.basename(paths[0])} .. {os.path.basename(paths[-1])})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
