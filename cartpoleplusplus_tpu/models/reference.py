"""numpy float64 forwards of every net in models/nets.py.

The plain reference the jnp nets are checked against (tests/test_nets.py
on the CPU, chip_smoke.py on the GPU): the same parameters, the same
layer definitions, written independently with numpy in float64.
"""

from __future__ import annotations

import numpy as np

from .nets import (LN_EPS, ActorMLP, CriticMLP, NafNet, PixelEncoder,
                   PolicyMLP, QNetMLP)


def _f64(tree):
    if isinstance(tree, dict):
        return {k: _f64(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_f64(v) for v in tree]
    return np.asarray(tree, np.float64)


def dense(p, x):
    return x @ p["kernel"] + p["bias"]


def layer_norm(p, x):
    mean = x.mean(-1, keepdims=True)
    var = ((x - mean) ** 2).mean(-1, keepdims=True)
    return (x - mean) / np.sqrt(var + LN_EPS) * p["scale"] + p["bias"]


def mlp(layers, x):
    for layer in layers:
        x = np.maximum(layer_norm(layer["norm"], dense(layer["dense"], x)),
                       0.0)
    return x


def conv_same(p, x, stride: int = 2):
    """3x3 (any odd k) strided conv with XLA's SAME padding, NHWC/HWIO."""
    k = p["kernel"]
    kh, kw = k.shape[:2]
    n, h, w, _ = x.shape
    oh, ow = -(-h // stride), -(-w // stride)
    ph = max((oh - 1) * stride + kh - h, 0)
    pw = max((ow - 1) * stride + kw - w, 0)
    xp = np.pad(x, ((0, 0), (ph // 2, ph - ph // 2),
                    (pw // 2, pw - pw // 2), (0, 0)))
    out = np.zeros((n, oh, ow, k.shape[-1]))
    for i in range(kh):
        for j in range(kw):
            patch = xp[:, i:i + stride * oh:stride, j:j + stride * ow:stride]
            out += patch @ k[i, j]
    return out + p["bias"]


def forward(net, params, *inputs):
    """float64 forward of `net` (one of the nets below) on numpy inputs;
    returns what net.apply returns, as float64 arrays."""
    p = _f64(params)
    xs = [np.asarray(x, np.float64) for x in inputs]
    if isinstance(net, (ActorMLP,)):
        x = mlp(p["torso"]["layers"], xs[0])
        return np.tanh(dense(p["out"], x))
    if isinstance(net, CriticMLP):
        obs, action = xs
        x = mlp(p["in"], obs)
        x = mlp(p["rest"], np.concatenate([x, action], -1))
        return dense(p["out"], x)[..., 0]
    if isinstance(net, (QNetMLP, PolicyMLP)):
        return dense(p["out"], mlp(p["torso"]["layers"], xs[0]))
    if isinstance(net, NafNet):
        x = mlp(p["torso"]["layers"], xs[0])
        v = dense(p["v"], x)[..., 0]
        mu = np.tanh(dense(p["mu"], x))
        if len(xs) == 1:
            return v, mu
        d = net.action_dim
        l_mat = np.zeros(x.shape[:-1] + (d, d))
        rows, cols = np.tril_indices(d)
        l_mat[..., rows, cols] = dense(p["l"], x)
        idx = np.arange(d)
        l_mat[..., idx, idx] = np.logaddexp(0.0, l_mat[..., idx, idx])
        da = xs[1] - mu
        ld = np.einsum("...ji,...j->...i", l_mat, da)   # L^T (a - mu)
        return v - 0.5 * np.sum(ld * ld, -1), mu, v
    if isinstance(net, PixelEncoder):
        x = xs[0]
        if np.asarray(inputs[0]).dtype == np.uint8:
            x = x / 255.0
        for layer in p["convs"]:
            x = np.maximum(conv_same(layer, x), 0.0)
        return x.reshape(x.shape[0], -1)
    raise TypeError(f"no reference forward for {type(net).__name__}")
