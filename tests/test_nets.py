"""Plain-JAX nets vs their numpy float64 reference (models/reference.py).

Each net is initialized with the repo's own init, run through jnp at
`highest` matmul precision (conftest) and through numpy float64 on the
same parameters. The same comparison runs on the GPU in chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from cartpoleplusplus_tpu.models import (ActorMLP, CriticMLP, NafNet,
                                         PatchEncoder, PixelEncoder,
                                         PolicyMLP, QNetMLP, VisualActor,
                                         VisualCritic, VisualNafNet,
                                         VisualPolicy, VisualQNet)
from cartpoleplusplus_tpu.models import reference
from cartpoleplusplus_tpu.models.nets import FINAL_INIT_SCALE

RNG = np.random.default_rng(0)
OBS = RNG.normal(size=(16, 42)).astype(np.float32)
ACT = RNG.uniform(-1, 1, size=(16, 2)).astype(np.float32)
IMG = RNG.integers(0, 256, size=(4, 20, 20, 6)).astype(np.uint8)

NETS = {
    "actor": (ActorMLP(hidden=(32, 32)), (OBS,)),
    "critic": (CriticMLP(hidden=(32, 32)), (OBS, ACT)),
    "qnet": (QNetMLP(hidden=(32, 32)), (OBS,)),
    "policy": (PolicyMLP(hidden=(16, 16)), (OBS,)),
    "naf": (NafNet(hidden=(32, 32)), (OBS, ACT)),
    "pixel_encoder": (PixelEncoder(features=(8, 16, 16)), (IMG,)),
}


def _perturbed(params, key):
    """Init params plus noise, so zero biases, unit LayerNorm scales and
    the tiny final layers are exercised with generic values too."""
    leaves, tree = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(tree, [
        x + 0.1 * jax.random.normal(k, x.shape) for x, k in zip(leaves, keys)])


@pytest.mark.parametrize("name", list(NETS))
def test_net_matches_numpy(name):
    net, inputs = NETS[name]
    params = _perturbed(net.init(jax.random.PRNGKey(1), *inputs),
                        jax.random.PRNGKey(2))
    got = jax.jit(net.apply)(params, *inputs)
    want = reference.forward(net, params, *inputs)
    for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert g.dtype == jnp.float32 and g.shape == w.shape
        scale = max(np.max(np.abs(w)), 1e-6)
        assert np.max(np.abs(np.asarray(g, np.float64) - w)) / scale < 1e-5
    if name == "naf":   # the action-free (v, mu) head
        v, mu = jax.jit(net.apply)(params, OBS)
        rv, rmu = reference.forward(net, params, OBS)
        np.testing.assert_allclose(np.asarray(v), rv, rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(np.asarray(mu), rmu, rtol=1e-5,
                                   atol=1e-6)


def test_init_statistics():
    """The recipes' layer defaults: lecun-normal kernels (truncated
    normal, std sqrt(1/fan_in), within two pre-truncation stds), zero
    biases, unit LayerNorm scales, uniform[0, 3e-3) final layers."""
    net = ActorMLP(hidden=(512, 512))
    p = net.init(jax.random.PRNGKey(0), jnp.zeros((1, 256)))
    layers = p["torso"]["layers"]
    for layer, fan_in in zip(layers, (256, 512)):
        w = np.asarray(layer["dense"]["kernel"])
        assert abs(w.std() * np.sqrt(fan_in) - 1.0) < 0.03
        assert abs(w.mean()) < 0.01 / np.sqrt(fan_in) * 10
        assert np.abs(w).max() <= 2.0 / 0.8796256610342398 / np.sqrt(fan_in)
        assert not np.any(np.asarray(layer["dense"]["bias"]))
        np.testing.assert_array_equal(np.asarray(layer["norm"]["scale"]), 1)
        assert not np.any(np.asarray(layer["norm"]["bias"]))
    out = np.asarray(p["out"]["kernel"])
    assert out.min() >= 0.0 and out.max() < FINAL_INIT_SCALE
    assert out.max() > 0.9 * FINAL_INIT_SCALE
    conv = PixelEncoder().init(jax.random.PRNGKey(1),
                               jnp.zeros((1, 48, 48, 6)))
    k0 = np.asarray(conv["convs"][0]["kernel"])
    assert k0.shape == (3, 3, 6, 16)
    assert abs(k0.std() * np.sqrt(3 * 3 * 6) - 1.0) < 0.15


def test_bfloat16_compute_path():
    """dtype=bfloat16 computes in bf16 with float32 params and a float32
    output that tracks the float32 net."""
    p = ActorMLP(hidden=(64, 64)).init(jax.random.PRNGKey(3), OBS)
    p = _perturbed(p, jax.random.PRNGKey(4))
    f32 = ActorMLP(hidden=(64, 64)).apply(p, OBS)
    bf16 = ActorMLP(hidden=(64, 64), dtype=jnp.bfloat16).apply(p, OBS)
    assert bf16.dtype == jnp.float32
    assert jax.tree.leaves(p)[0].dtype == jnp.float32
    np.testing.assert_allclose(np.asarray(bf16), np.asarray(f32), atol=5e-2)


@pytest.mark.parametrize("encoder", ["conv", "patch"])
def test_visual_nets_compose(encoder):
    """Encoder + head nets: params split into encoder/head, outputs have
    the heads' shapes, and the encoder feeds the head."""
    img = jnp.asarray(RNG.integers(0, 256, size=(3, 24, 24, 6)), jnp.uint8)
    act = jnp.zeros((3, 2))
    kw = dict(hidden=(16, 16), encoder=encoder)
    cases = [(VisualActor(**kw), (img,), (3, 2)),
             (VisualCritic(**kw), (img, act), (3,)),
             (VisualQNet(**kw), (img,), (3, 5)),
             (VisualPolicy(**kw), (img,), (3, 5)),
             (VisualNafNet(**kw), (img, act), (3,))]
    for net, inputs, shape in cases:
        p = net.init(jax.random.PRNGKey(5), *inputs)
        assert set(p) == {"encoder", "head"}
        out = net.apply(p, *inputs)
        out = out[0] if isinstance(out, tuple) else out
        assert out.shape == shape and bool(jnp.all(jnp.isfinite(out)))
    enc = PatchEncoder(patch=6, features=(8, 4))
    pe = enc.init(jax.random.PRNGKey(6), img)
    assert enc.apply(pe, img).shape == (3, 4 * 4 * 4)
