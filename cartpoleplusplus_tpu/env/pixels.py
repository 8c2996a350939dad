"""Batched on-device rendering of the scene — pixel observations.

Reference counterpart: `pybullet.getCameraImage` (Bullet's TinyRenderer, a
C++ software rasterizer) used by `bullet_cartpole.py` for the
pixel-observation variant: small RGB frames from 1-2 fixed cameras, stacked
over the action-repeat window (SURVEY.md §2a; BASELINE config 4,
BASELINE.json:10).

Redesign: rasterizing triangle meshes is hostile to SIMD batching
(per-primitive loops, z-buffer scatter). The scene here is three
analytic primitives (ground plane, cart box, pole capsule), so a branch-
free per-pixel RAY CAST is both simpler and a perfect fit for a wide
vector machine: one fused elementwise program over (envs x H x W) rays,
which XLA emits as one GPU loop fusion — no scatter, no
data-dependent control flow. Camera rays are compile-time constants
(cameras are fixed); per-env work is just two ray-primitive intersections
and a Lambert shade.
"""

from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp

from ..physics import CartPoleParams, PhysState, pole_w

_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class CameraConfig:
    """A fixed pinhole camera looking at `target` from `eye`."""

    eye: tuple = (0.0, -2.4, 1.3)
    target: tuple = (0.0, 0.0, 0.6)
    up: tuple = (0.0, 0.0, 1.0)
    fov_deg: float = 45.0


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    """Render settings for the pixel-observation variant.

    Two default cameras at 90 degrees (front and side) mirror the
    reference's use of a second camera to disambiguate the y axis.
    """

    width: int = 48
    height: int = 48
    cameras: tuple = (
        CameraConfig(eye=(0.0, -2.4, 1.3)),
        CameraConfig(eye=(-2.4, 0.0, 1.3)),
    )
    grayscale: bool = False
    # Visual sizes (match the physics footprint; purely cosmetic beyond it).
    cart_half_extents: tuple = (0.25, 0.25, 0.1)
    pole_radius: float = 0.06
    # Ray-cast compute dtype: "bfloat16" halves the elementwise work's
    # register and memory width (~200 flops/pixel); outputs stay f32 in
    # [0, 1] either way. bf16's ~3 significant digits are ample for a
    # 48x48 conv-net observation (and the frames are replayed as uint8).
    dtype: str = "float32"
    # uint8 observations: the env quantizes rendered frames to 0..255
    # at obs-assembly time, cutting the (B, H, W, C)-sized stack /
    # auto-reset-select / replay-insert HBM traffic 4x (the measured
    # co-bottleneck of the pixel env next to the raycast itself).
    # PixelEncoder normalizes uint8 inputs back to [0, 1] on entry.
    obs_uint8: bool = False
    # Frame-difference observations: instead of the R raw frames of the
    # action-repeat window, stack [latest frame, 0.5*(f_r - f_{r-1})+0.5
    # for each consecutive pair] — same channel count, but the motion
    # signal the conv net otherwise has to infer from frame pairs is
    # handed to it explicitly (the pose-stack agents get velocities
    # implicitly the same way; the reference stacks repeat-window frames
    # "in lieu of velocities"). Diff planes are centered at 0.5 so the
    # uint8 and float pipelines stay identical up to quantization.
    frame_diff: bool = False
    # Contrast gain on the diff planes (encode = clip(0.5 + 0.5*gain*d)):
    # inter-repeat motion at 48x48 is 1-2 px, so raw diffs occupy a
    # handful of uint8 levels around 128 — the measured cause of the
    # gain-1 A/B regression (docs/design.md §4). gain 4-8 spends the
    # 8-bit range on the amplitudes that actually occur (clipping the
    # rare saturated pixel) instead of the +/-1 worst case.
    frame_diff_gain: float = 1.0

    @property
    def channels_per_camera(self) -> int:
        return 1 if self.grayscale else 3


# Scene constants. numpy scalars, folded into the program as compile-time
# constants (same rule as env/compute.py).
_LIGHT = (0.4, -0.3, 0.85)
_CART_COL = (0.85, 0.25, 0.2)
_POLE_COL = (0.2, 0.45, 0.9)
_SKY_COL = (0.7, 0.8, 0.95)


def _light_np():
    import numpy as np

    l = np.asarray(_LIGHT, np.float32)
    return tuple(np.float32(v) for v in (l / np.sqrt((l * l).sum())))


def ray_constants_np(cam: CameraConfig, width: int, height: int):
    """Numpy mirror of camera_rays, flattened: ((ex, ey, ez),
    (dx, dy, dz), (inv_dx, inv_dy, inv_dz)) with d*/inv_* of shape
    (1, H*W) f32. Static per camera — compile-time constants, not traced."""
    import math as m

    import numpy as np

    eye = np.asarray(cam.eye, np.float32)
    fwd = np.asarray(cam.target, np.float32) - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(cam.up, np.float32))
    right = right / np.linalg.norm(right)
    up = np.cross(right, fwd)
    tan = m.tan(m.radians(cam.fov_deg) / 2.0)
    xs = (np.arange(width, dtype=np.float32) + 0.5) / width * 2.0 - 1.0
    ys = 1.0 - (np.arange(height, dtype=np.float32) + 0.5) / height * 2.0
    d = (fwd[None, None]
         + xs[None, :, None] * (tan * right)[None, None]
         + ys[:, None, None] * (tan * height / width * up)[None, None])
    d = d / np.linalg.norm(d, axis=-1, keepdims=True)
    d = d.reshape(-1, 3).astype(np.float32)
    guard = np.where(np.abs(d) < 1e-9, 1e-9, d)
    inv = (1.0 / guard).astype(np.float32)
    return (tuple(np.float32(v) for v in eye),
            tuple(d[None, :, i] for i in range(3)),
            tuple(inv[None, :, i] for i in range(3)))


def static_rows_np(cam: CameraConfig, cfg: RenderConfig, gray: bool):
    """Every state-independent per-pixel quantity, hoisted to trace time.

    The ground plane, the sky, the camera rays and the light are all
    static, so everything that depends only on them is a pure function
    of the pixel index — precomputed here (numpy, f32 throughout) and
    fed to the shade as constant (1, H*W) rows instead of being
    recomputed per env per frame. Rows, in order:

      t_g            ground hit distance (_BIG at miss) — deletes the
                     plane test + checkerboard floor/mod chain;
      bg (1 or 3)    background composite: checkerboard shade where the
                     ground is hit, sky color where not (1 luminance
                     row when `gray`, else 3 RGB rows) — deletes the
                     final sky select;
      ha_x/y/z       cart_half_extent * |1/d| per axis — the slab
                     min/max over the ± faces collapses to q ∓ ha
                     (sign-folded slab test);
      nl_x/y/z       -sign(d)·light per axis — the cart face-normal
                     Lambert dot, already resolved per pixel.

    Returns (rows, n_bg) with rows a flat tuple of (1, H*W) f32 arrays.
    """
    import numpy as np

    f = np.float32
    eye, (dx, dy, dz), (idx_, idy_, idz_) = ray_constants_np(
        cam, cfg.width, cfg.height)
    ex, ey, ez = eye
    lx, ly, lz = _light_np()
    t = f(-1.0) * ez * idz_
    hit = (dz < f(-1e-6)) & (t > f(0.0))
    t_g = np.where(hit, t, f(_BIG)).astype(np.float32)
    checker = np.mod(np.floor(ex + t_g * dx) + np.floor(ey + t_g * dy),
                     f(2.0))
    shade_up = f(0.45 + 0.55 * max(float(lz), 0.0))
    g_lum = ((f(0.35) + f(0.25) * checker) * shade_up).astype(np.float32)
    if gray:
        sky = f(sum(_SKY_COL) / 3.0)
        bg = (np.where(hit, g_lum, sky).astype(np.float32),)
    else:
        bg = tuple(np.where(hit, g_lum, f(c)).astype(np.float32)
                   for c in _SKY_COL)
    hx, hy, hz = (f(v) for v in cfg.cart_half_extents)
    ha = (np.abs(idx_) * hx, np.abs(idy_) * hy, np.abs(idz_) * hz)
    nl = (-np.sign(dx) * lx, -np.sign(dy) * ly, -np.sign(dz) * lz)
    rows = (t_g,) + bg + tuple(a.astype(np.float32) for a in ha + nl)
    return rows, len(bg)


def shade_components(p: CartPoleParams, cfg: RenderConfig, eye,
                     dx, dy, dz, idx_, idy_, idz_, static,
                     cx, cy, cz, ux, uy, uz, gray: bool = False):
    """The full per-pixel raycast + Lambert shade, all-elementwise.

    The env/compute.py pattern applied to rendering. Ray components
    (dx, dy, dz) and their reciprocals broadcast against env components
    (cx..uz); every op is elementwise on the broadcast shape (no
    (..., 3) vectors, no stack/argmin), so XLA fuses the whole shade
    into one kernel. Everything state-independent — ground hit + sky
    background, sign-folded slab half-widths, cart face-normal Lambert
    rows — arrives precomputed in `static` (static_rows_np): only the
    two moving bodies cost per-env work.
    Returns (r, g, b) in [0, 1], or a single luminance plane when
    `gray` (the grayscale fast path: compositing mean-color constants
    once instead of three channels — identical to averaging the
    channels afterwards because every channel value is in [0, 1] by
    construction, so the final clip commutes with the mean).
    """
    import numpy as np

    f = np.float32
    one = f(1.0)
    # eye components are np scalars (one camera) or (1, npx) rows.
    ex, ey, ez = eye
    lx, ly, lz = _light_np()
    big = f(_BIG)
    n_bg = 1 if gray else 3
    t_g = static[0]
    bg = static[1:1 + n_bg]
    hax, hay, haz, nlx, nly, nlz = static[1 + n_bg:]

    # --- cart: sign-folded slab test, face-normal Lambert. With
    # q = (c - e) * (1/d) per axis, min/max over the ±h faces is just
    # q ∓ h|1/d| (the half-width row ha is static), and the face normal
    # dotted with the light (-sign(d)·l) is the static row nl: three
    # broadcast muls + six adds replace six muls + six min/max, and the
    # normal select picks between constants.
    qx = (cx - ex) * idx_
    qy = (cy - ey) * idy_
    qz = (cz - ez) * idz_
    tnx = qx - hax
    txx = qx + hax
    tny = qy - hay
    txy = qy + hay
    tnz = qz - haz
    txz = qz + haz
    t_near = jnp.maximum(tnx, jnp.maximum(tny, tnz))
    t_far = jnp.minimum(txx, jnp.minimum(txy, txz))
    hit = (t_near <= t_far) & (t_far > f(0.0))
    t_c = jnp.where(hit, jnp.where(t_near > f(0.0), t_near, t_far), big)
    nl_c = jnp.where(tnx == t_near, nlx,
                     jnp.where(tny == t_near, nly, nlz))
    shade_c = f(0.45) + f(0.55) * jnp.maximum(nl_c, f(0.0))

    # --- pole: capsule pivot -> tip (|u| = 1, so |b-a|^2 = L^2 static).
    # The length scale folds into the per-env axis components (uxl =
    # L·ux is a (B, 1) column — free relative to broadcast work), and
    # the h_along division becomes a multiply by the static 1/L.
    ll = f(p.pole_length)
    l2 = f(p.pole_length * p.pole_length)
    inv_ll = f(1.0 / p.pole_length)
    r = f(cfg.pole_radius)
    ax = cx
    ay = cy
    az = cz + f(p.pivot_height)
    oax = ex - ax
    oay = ey - ay
    oaz = ez - az
    uxl = ll * ux
    uyl = ll * uy
    uzl = ll * uz
    bard = uxl * dx + uyl * dy + uzl * dz
    baoa = uxl * oax + uyl * oay + uzl * oaz
    rdoa = dx * oax + dy * oay + dz * oaz
    oaoa = oax * oax + oay * oay + oaz * oaz
    a2 = l2 - bard * bard
    b2 = l2 * rdoa - baoa * bard
    c2 = l2 * oaoa - baoa * baoa - r * r * l2
    h = b2 * b2 - a2 * c2
    sq = jnp.sqrt(jnp.maximum(h, f(0.0)))
    a2g = jnp.where(jnp.abs(a2) < f(1e-9), f(1e-9), a2)
    t_cyl = (f(-1.0) * b2 - sq) / a2g
    y = baoa + t_cyl * bard
    cyl_ok = (h > f(0.0)) & (y > f(0.0)) & (y < l2) & (t_cyl > f(0.0))
    t_p = jnp.where(cyl_ok, t_cyl, big)
    for sx_, sy_, sz_ in ((oax, oay, oaz),
                          (oax - uxl, oay - uyl, oaz - uzl)):
        bq = dx * sx_ + dy * sy_ + dz * sz_
        cq = sx_ * sx_ + sy_ * sy_ + sz_ * sz_ - r * r
        hq = bq * bq - cq
        ts = f(-1.0) * bq - jnp.sqrt(jnp.maximum(hq, f(0.0)))
        t_p = jnp.minimum(t_p, jnp.where((hq > f(0.0)) & (ts > f(0.0)),
                                         ts, big))
    px_ = oax + t_p * dx
    py_ = oay + t_p * dy
    pz_ = oaz + t_p * dz
    h_along = jnp.clip((px_ * ux + py_ * uy + pz_ * uz) * inv_ll,
                       f(0.0), one)
    nx_ = px_ - h_along * uxl
    ny_ = py_ - h_along * uyl
    nz_ = pz_ - h_along * uzl
    nl_p = ((nx_ * lx + ny_ * ly + nz_ * lz)
            * jax.lax.rsqrt(nx_ * nx_ + ny_ * ny_ + nz_ * nz_ + f(1e-12)))
    shade_p = f(0.45) + f(0.55) * jnp.maximum(nl_p, f(0.0))

    # --- composite: closest-so-far over the precomputed background (bg
    # is already ground-where-hit / sky-where-not, so no final sky
    # select: the two body tests are the only per-env selects left).
    clip01 = lambda v: jnp.clip(v, f(0.0), one)  # noqa: E731
    if gray:
        # Luminance-only composite: material colors collapse to their
        # channel means (ground is already gray). One select chain and
        # one output plane instead of three.
        cl = f(sum(_CART_COL) / 3.0)
        pl_ = f(sum(_POLE_COL) / 3.0)
        (lum0,) = bg
        closer = t_c < t_g
        lum = jnp.where(closer, cl * shade_c, lum0)
        t_hit = jnp.minimum(t_c, t_g)
        closer = t_p < t_hit
        lum = jnp.where(closer, pl_ * shade_p, lum)
        return (clip01(lum),)
    ccr, ccg, ccb = (f(v) for v in _CART_COL)
    pcr, pcg, pcb = (f(v) for v in _POLE_COL)
    bgr, bgg, bgb = bg
    closer = t_c < t_g
    cr = jnp.where(closer, ccr * shade_c, bgr)
    cg_ = jnp.where(closer, ccg * shade_c, bgg)
    cb = jnp.where(closer, ccb * shade_c, bgb)
    t_hit = jnp.minimum(t_c, t_g)
    closer = t_p < t_hit
    cr = jnp.where(closer, pcr * shade_p, cr)
    cg_ = jnp.where(closer, pcg * shade_p, cg_)
    cb = jnp.where(closer, pcb * shade_p, cb)
    return clip01(cr), clip01(cg_), clip01(cb)


def render(p: CartPoleParams, phys: PhysState, cfg: RenderConfig,
           cam: CameraConfig, gray: bool = False) -> jax.Array:
    """One camera view of every env: (B, H, W, 3) float32 in [0, 1]
    ((B, H, W, 1) luminance when `gray`).

    Thin broadcast wrapper over `shade_components` (the single math
    source): env components as (B, 1) columns against (1, H*W)
    ray-constant rows, one fused elementwise program, reshaped to
    images at the end."""
    dt = jnp.bfloat16 if cfg.dtype == "bfloat16" else jnp.float32
    eye, dcomp, icomp = ray_constants_np(cam, cfg.width, cfg.height)
    rays = [jnp.asarray(c, dt) for c in dcomp + icomp]  # (1, HW) each
    rows_np, _ = static_rows_np(cam, cfg, gray)
    static = tuple(jnp.asarray(c, dt) for c in rows_np)

    b = phys.pos.shape[0]
    col = lambda v: v.astype(dt)[:, None]  # noqa: E731 - (B, 1) column
    sx, sy = phys.s[..., 0], phys.s[..., 1]
    w = pole_w(p, sx, sy)
    chans = shade_components(
        p, cfg, eye, *rays, static,
        col(phys.pos[..., 0]), col(phys.pos[..., 1]),
        col(phys.pos[..., 2]), col(sx), col(sy), col(w), gray=gray)
    img = jnp.stack(chans, axis=-1).reshape(
        b, cfg.height, cfg.width, len(chans))
    return img.astype(jnp.float32)


def render_all_cameras(p: CartPoleParams, phys: PhysState,
                       cfg: RenderConfig) -> jax.Array:
    """(B, H, W, C*num_cameras) — cameras stacked on channels (C=3 RGB,
    or 1 when cfg.grayscale: the luminance composite runs inside the
    shade itself rather than averaging three rendered channels)."""
    views = [render(p, phys, cfg, cam, gray=cfg.grayscale)
             for cam in cfg.cameras]
    return jnp.concatenate(views, axis=-1)


def pixel_obs_shape(p: CartPoleParams, cfg: RenderConfig) -> tuple:
    """(H, W, C): repeats and cameras stack on channels (the reference
    stacks repeat-window frames in lieu of velocities)."""
    c = cfg.channels_per_camera * len(cfg.cameras) * p.action_repeats
    return (cfg.height, cfg.width, c)
