"""Pixel-observation tests (BASELINE config 4).

Reference counterpart for coverage: pybullet.getCameraImage frames as
observations (SURVEY.md §2a). The reference has no renderer tests; here
the analytic raycaster is checked through geometric invariants (what
moves on screen when the state moves) and the env pixel path end to end.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpoleplusplus_tpu import CartPole3D, CartPoleParams
from cartpoleplusplus_tpu.env.pixels import (
    CameraConfig,
    RenderConfig,
    render,
    render_all_cameras,
)
from cartpoleplusplus_tpu.physics import rest_state

P = CartPoleParams()
CFG = RenderConfig(width=32, height=32)
CAM = CFG.cameras[0]  # front camera, looking along +y


def _img(phys):
    return np.asarray(jax.jit(render, static_argnums=(0, 2, 3))(
        P, phys, CFG, CAM))


def _col_mass(mask):
    """Mean column index of a boolean mask (horizontal centroid)."""
    cols = np.argwhere(mask)[:, 2]
    return cols.mean()


def test_render_shapes_and_range():
    phys = rest_state(P, batch_shape=(4,))
    img = _img(phys)
    assert img.shape == (4, 32, 32, 3)
    assert np.all(img >= 0.0) and np.all(img <= 1.0)
    both = render_all_cameras(P, phys, CFG)
    assert both.shape == (4, 32, 32, 6)


def test_cart_visible_and_tracks_x():
    """The red cart moves right on screen as x increases (front camera)."""
    phys0 = rest_state(P, batch_shape=(1,))
    phys1 = phys0._replace(pos=phys0.pos.at[..., 0].set(1.0))
    red0 = _img(phys0)
    red1 = _img(phys1)
    is_cart0 = (red0[..., 0] > 0.5) & (red0[..., 2] < 0.3)
    is_cart1 = (red1[..., 0] > 0.5) & (red1[..., 2] < 0.3)
    assert is_cart0.sum() > 5, "cart not visible at origin"
    assert _col_mass(is_cart1) > _col_mass(is_cart0) + 2.0


def test_pole_tilt_changes_pixels():
    """Tilting the pole moves blue pixels; the two cameras disambiguate
    the tilt axis (x-tilt is visible front-on, y-tilt side-on)."""
    upright = rest_state(P, batch_shape=(1,))
    tilted_x = upright._replace(s=upright.s.at[..., 0].set(0.25))
    img_u = _img(upright)
    img_t = _img(tilted_x)
    is_pole_u = (img_u[..., 2] > 0.5) & (img_u[..., 0] < 0.4)
    is_pole_t = (img_t[..., 2] > 0.5) & (img_t[..., 0] < 0.4)
    assert is_pole_u.sum() > 5, "pole not visible"
    assert _col_mass(is_pole_t) > _col_mass(is_pole_u) + 0.5


def test_env_pixels_mode_end_to_end():
    env = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=CFG)
    assert env.obs_shape == (32, 32, 3 * 2 * P.action_repeats)
    state, obs = jax.jit(env.reset)(0)
    assert obs.shape == (3,) + env.obs_shape
    action = jnp.zeros((3,), jnp.int32)
    step = jax.jit(env.step)
    state, obs, reward, done, info = step(state, action)
    assert obs.shape == (3,) + env.obs_shape
    assert np.all(np.isfinite(np.asarray(obs)))
    # Frames across the repeat window differ (the pole is falling).
    c = 6
    first, last = np.asarray(obs[..., :c]), np.asarray(obs[..., -c:])
    assert np.any(first != last)


def test_env_pixels_uint8_obs_mode():
    """RenderConfig.obs_uint8: the env emits quantized uint8 frames that
    round-trip the float render to within 1/255, and the encoder +
    replay path accept them unchanged (no double quantization)."""
    cfg8 = RenderConfig(width=32, height=32, obs_uint8=True)
    env8 = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=cfg8)
    envf = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=CFG)
    s8, o8 = jax.jit(env8.reset)(0)
    sf, of = jax.jit(envf.reset)(0)
    assert o8.dtype == jnp.uint8 and of.dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(o8) / 255.0, np.asarray(of),
                               atol=1.0 / 255.0)
    action = jnp.zeros((3,), jnp.int32)
    s8, o8, *_ = jax.jit(env8.step)(s8, action)
    sf, of, *_ = jax.jit(envf.step)(sf, action)
    assert o8.dtype == jnp.uint8
    np.testing.assert_allclose(np.asarray(o8) / 255.0, np.asarray(of),
                               atol=1.0 / 255.0)
    # Encoder normalizes uint8 back to [0,1] on entry: identical to
    # feeding the dequantized float frame.
    from cartpoleplusplus_tpu.models.nets import PixelEncoder
    enc = PixelEncoder()
    params = enc.init(jax.random.PRNGKey(0), of)
    z8 = enc.apply(params, o8)
    zq = enc.apply(params, o8.astype(jnp.float32) / 255.0)
    np.testing.assert_allclose(np.asarray(z8), np.asarray(zq),
                               rtol=1e-5, atol=1e-6)
    # Replay encode is the identity (modulo flat storage) on uint8 obs.
    from cartpoleplusplus_tpu.agents.replay import ReplayBuffer
    rb = ReplayBuffer(num_envs=3, capacity_per_env=8,
                      obs_shape=env8.obs_shape, quantize_obs=True)
    enc = np.asarray(rb._encode_obs(o8))
    assert enc.dtype == np.uint8
    assert np.array_equal(enc, np.asarray(o8).reshape(3, -1))
    # and decode round-trips to the original shape/values.
    np.testing.assert_allclose(
        np.asarray(rb._decode_obs(rb._encode_obs(o8))),
        np.asarray(o8).astype(np.float32) / 255.0, atol=1e-7)


def test_frame_diff_obs_mode():
    """RenderConfig.frame_diff: same obs shape as the raw R-frame stack;
    the first plane group per window is the LATEST raw frame, the rest
    are consecutive diffs encoded 0.5*(f_r - f_{r-1}) + 0.5 (computed
    before any quantization); reset-obs diff planes are the exact 0.5
    constant (128 in uint8 mode)."""
    cfgd = RenderConfig(width=32, height=32, frame_diff=True)
    envd = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=cfgd)
    envr = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=CFG)
    assert envd.obs_shape == envr.obs_shape
    c = cfgd.channels_per_camera * len(cfgd.cameras)  # per-frame channels
    sd, od = jax.jit(envd.reset)(0)
    sr, orr = jax.jit(envr.reset)(0)
    od, orr = np.asarray(od), np.asarray(orr)
    np.testing.assert_allclose(od[..., :c], orr[..., :c],
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(od[..., c:], np.float32(0.5))
    # Same trajectory (randomness keys on env_seed, not obs mode): the
    # diff obs after one step must be the encoded diffs of the raw
    # stacked frames from the plain env.
    action = jnp.zeros((3,), jnp.int32)
    sd, od, *_ = jax.jit(envd.step)(sd, action)
    sr, orr, *_ = jax.jit(envr.step)(sr, action)
    od, orr = np.asarray(od), np.asarray(orr)
    raw = [orr[..., i * c:(i + 1) * c] for i in range(P.action_repeats)]
    np.testing.assert_allclose(od[..., :c], raw[-1], rtol=1e-6, atol=1e-6)
    for i in range(1, P.action_repeats):
        np.testing.assert_allclose(od[..., i * c:(i + 1) * c],
                                   0.5 * (raw[i] - raw[i - 1]) + 0.5,
                                   rtol=1e-6, atol=1e-6)
    # uint8 mode: reset diff planes quantize to exactly 128.
    cfg8 = RenderConfig(width=32, height=32, frame_diff=True,
                        obs_uint8=True, grayscale=True)
    env8 = CartPole3D(P, num_envs=2, obs_mode="pixels", render_config=cfg8)
    _, o8 = jax.jit(env8.reset)(0)
    c8 = cfg8.channels_per_camera * len(cfg8.cameras)
    assert o8.dtype == jnp.uint8
    assert np.all(np.asarray(o8)[..., c8:] == 128)
    # frame_diff_gain amplifies (and clips) the diff planes around 0.5;
    # the latest-frame plane is untouched and reset diffs stay 0.5.
    cfgg = RenderConfig(width=32, height=32, frame_diff=True,
                        frame_diff_gain=4.0)
    envg = CartPole3D(P, num_envs=3, obs_mode="pixels", render_config=cfgg)
    sg, og = jax.jit(envg.reset)(0)
    np.testing.assert_array_equal(np.asarray(og)[..., c:], np.float32(0.5))
    sg, og, *_ = jax.jit(envg.step)(sg, action)
    og = np.asarray(og)
    np.testing.assert_allclose(og[..., :c], raw[-1], rtol=1e-6, atol=1e-6)
    for i in range(1, P.action_repeats):
        np.testing.assert_allclose(
            og[..., i * c:(i + 1) * c],
            np.clip(2.0 * (raw[i] - raw[i - 1]) + 0.5, 0.0, 1.0),
            rtol=1e-6, atol=1e-6)


def test_auto_reset_obs_is_constant_reset_frame():
    """The fresh-episode pose is deterministic (reset randomness enters
    through velocities only — env/compute.py::reset_components), so a
    done env's post-reset observation must equal the reset() image
    exactly, while live envs keep their (different) terminal frames.
    Guards the batch-1 constant-frame broadcast in CartPole3D.step."""
    cfg8 = RenderConfig(width=32, height=32, grayscale=True,
                        obs_uint8=True)
    env = CartPole3D(P, num_envs=8, obs_mode="pixels", render_config=cfg8)
    state, obs0 = jax.jit(env.reset)(0)
    obs0 = np.asarray(obs0)
    assert (obs0 == obs0[0]).all(), "reset obs differs across envs"
    step = jax.jit(env.step)
    action = jnp.zeros((8,), jnp.int32)  # noop: the pushed pole falls
    for _ in range(60):
        state, obs, reward, done, info = step(state, action)
        d = np.asarray(done)
        if d.any():
            break
    assert d.any(), "no env terminated in 60 steps"
    o = np.asarray(obs)
    for i in np.nonzero(d)[0]:
        np.testing.assert_array_equal(o[i], obs0[0])
    live = np.nonzero(~d)[0]
    assert any(not np.array_equal(o[i], obs0[0]) for i in live), \
        "live envs should observe mid-episode frames, not the reset image"


def test_grayscale_composite_parity():
    """Grayscale path invariants: (a) the in-shade luminance composite
    equals the mean of the RGB channels (clip commutes: all channel
    values are in [0, 1] by construction); (b) the env emits 1 channel
    per camera-repeat."""
    cfg_g = RenderConfig(width=16, height=16, grayscale=True)
    cfg_rgb = RenderConfig(width=16, height=16)
    phys = rest_state(P, batch_shape=(8,))
    phys = phys._replace(
        pos=phys.pos.at[:, 0].set(jnp.linspace(-1.0, 1.0, 8)),
        s=phys.s.at[:, 0].set(jnp.linspace(-0.25, 0.25, 8)))
    gray = np.asarray(jax.jit(
        lambda ph: render_all_cameras(P, ph, cfg_g))(phys))
    rgb = np.asarray(jax.jit(
        lambda ph: render_all_cameras(P, ph, cfg_rgb))(phys))
    assert gray.shape == (8, 16, 16, 2) and rgb.shape == (8, 16, 16, 6)
    np.testing.assert_allclose(gray[..., 0], rgb[..., :3].mean(-1),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(gray[..., 1], rgb[..., 3:].mean(-1),
                               rtol=1e-5, atol=1e-5)

    env = CartPole3D(P, num_envs=3, obs_mode="pixels",
                     render_config=cfg_g)
    assert env.obs_shape == (16, 16, 1 * 2 * P.action_repeats)
    _, obs = jax.jit(env.reset)(0)
    assert obs.shape == (3,) + env.obs_shape


@pytest.mark.slow
def test_patch_encoder_shapes_and_training():
    """PatchEncoder (models/nets.py): the patch-embedding pixel encoder —
    output shape contract ((H/P)*(W/P)*features[-1] flat f32), uint8
    and float inputs produce identical features, and a pixel-DDPG train
    step through encoder="patch" learns finite metrics end to end."""
    from cartpoleplusplus_tpu.agents import DDPG, DDPGConfig
    from cartpoleplusplus_tpu.models import PatchEncoder
    from cartpoleplusplus_tpu.physics.params import continuous_params

    enc = PatchEncoder()          # patch 6, features (128, 32)
    img_u8 = jnp.asarray(
        np.random.default_rng(0).integers(0, 256, (4, 48, 48, 6)),
        jnp.uint8)
    params = enc.init(jax.random.PRNGKey(0), img_u8)
    feats = enc.apply(params, img_u8)
    assert feats.shape == (4, 8 * 8 * 32) and feats.dtype == jnp.float32
    feats_f = enc.apply(params, img_u8.astype(jnp.float32) / 255.0)
    np.testing.assert_allclose(np.asarray(feats), np.asarray(feats_f),
                               atol=1e-5)

    cfg = RenderConfig(width=48, height=48, grayscale=True, obs_uint8=True)
    env = CartPole3D(continuous_params(), num_envs=16, obs_mode="pixels",
                     render_config=cfg)
    agent = DDPG(env, DDPGConfig(hidden=(32, 32), rollout_steps=2,
                                 updates_per_step=2, batch_size=32,
                                 replay_capacity_per_env=16,
                                 warmup_env_steps=0, encoder="patch"))
    st = agent.init(0)
    a0 = jax.tree.map(jnp.copy, st.actor)
    # Two steps: pixel agents sample PRE-insert (agents/ddpg.py), so the
    # very first update phase sees the empty ring's all-zero batch
    # (exactly-zero grads by construction — benign with the default
    # warmup; asserted movement needs a populated ring).
    for _ in range(2):
        st, m = agent.train_step(st)
    assert np.isfinite(float(m["critic_loss"]))
    assert np.isfinite(float(m["actor_loss"]))
    moved = any(float(jnp.max(jnp.abs(a - b))) > 0
                for a, b in zip(jax.tree.leaves(a0),
                                jax.tree.leaves(st.actor)))
    assert moved, "patch-encoder train step left the actor unchanged"


def test_pixel_naf_and_lrpg_train(tmp_path):
    """Pixel-observation NAF and LRPG (the reference trained its agents
    from pixels through a shared conv stack): conv-encoder nets wire in, the quantized uint8 ring holds
    NAF's replay, params move, and metrics stay finite."""
    from cartpoleplusplus_tpu.agents import LRPG, LRPGConfig, NAF, NAFConfig
    from cartpoleplusplus_tpu.physics.params import continuous_params

    rc = RenderConfig(width=16, height=16, grayscale=True, obs_uint8=True,
                      frame_diff=True, frame_diff_gain=4.0)
    env = CartPole3D(continuous_params(), num_envs=16, obs_mode="pixels",
                     render_config=rc)
    agent = NAF(env, NAFConfig(hidden=(32, 32), rollout_steps=2,
                               updates_per_step=2, batch_size=32,
                               replay_capacity_per_env=16,
                               warmup_env_steps=0))
    assert agent.replay.quantize_obs
    st = agent.init(0)
    p0 = jax.tree.map(jnp.copy, st.params)
    step = jax.jit(agent.train_step)
    for _ in range(3):
        st, m = step(st)
    assert np.isfinite(float(m["loss"]))
    assert any(float(jnp.max(jnp.abs(a - b))) > 0
               for a, b in zip(jax.tree.leaves(p0),
                               jax.tree.leaves(st.params))), \
        "pixel-NAF params did not move"

    denv = CartPole3D(CartPoleParams(), num_envs=16, obs_mode="pixels",
                      render_config=rc)
    lagent = LRPG(denv, LRPGConfig(hidden=(32, 32), rollout_steps=4))
    lst = lagent.init(0)
    lp0 = jax.tree.map(jnp.copy, lst.params)
    lstep = jax.jit(lagent.train_step)
    for _ in range(3):
        lst, lm = lstep(lst)
    assert np.isfinite(float(lm["loss"]))
    assert any(float(jnp.max(jnp.abs(a - b))) > 0
               for a, b in zip(jax.tree.leaves(lp0),
                               jax.tree.leaves(lst.params))), \
        "pixel-LRPG params did not move"
