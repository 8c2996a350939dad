"""Network definitions for every agent family, in plain jax.numpy / lax.

Reference counterparts (SURVEY.md §2a):
  * ActorMLP / CriticMLP  <- `ddpg_cartpole.py::{ActorNetwork, CriticNetwork}`
    (TF graphs: MLPs for low-dim obs, conv stacks for pixels, batch-norm,
    tanh-bounded actor output, critic takes action at a late layer).
  * QNetMLP               <- the keras Q-network in `dqn_cartpole.py`.
  * PolicyMLP             <- the softmax policy graph in `lrpg_cartpole.py`.
  * NafNet                <- `naf_cartpole.py` (shared torso with value head
    V, action head mu, and a lower-triangular L head forming the quadratic
    advantage A(s,a) = -1/2 (a-mu)^T L L^T (a-mu)).
  * PixelEncoder          <- the shared conv stack in `base_network.py`.

Every net is a frozen dataclass with `init(key, *example) -> params` and
`apply(params, *inputs)`; params are nested dicts of float32 arrays.
The layer defaults are the ones the tuned recipes were found with:
Dense kernels lecun-normal (truncated normal, fan-in), zero biases;
LayerNorm with scale and bias, eps 1e-6, statistics in float32; 3x3
stride-2 SAME convolutions; the final action/Q layers drawn from
uniform[0, 3e-3). `dtype` is the compute dtype (bfloat16 halves the
matmul cost); parameters stay float32 and outputs are float32.
LayerNorm instead of the reference's batch-norm: batch statistics would
couple the sharded env batches for no benefit at these scales.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import jax
import jax.numpy as jnp
import numpy as np

LN_EPS = 1e-6
FINAL_INIT_SCALE = 3e-3
# Truncated-normal [-2, 2] has std 0.8796...; lecun-normal rescales by it.
_TRUNC_STD = 0.87962566103423978


def polyak(target_params, online_params, tau: float):
    """theta' <- tau * theta + (1 - tau) * theta'.

    Reference counterpart: the target-network variable-copy ops built in
    `base_network.py` (TF assign graph). Here it is one tree_map.
    """
    return jax.tree.map(
        lambda t, o: (1.0 - tau) * t + tau * o, target_params, online_params)


# --- layers -------------------------------------------------------------------

def lecun_normal(key, shape, fan_in: int):
    std = np.sqrt(1.0 / fan_in) / _TRUNC_STD
    return std * jax.random.truncated_normal(key, -2.0, 2.0, shape,
                                             jnp.float32)


def dense_init(key, fan_in: int, features: int, final: bool = False):
    """Dense params; `final` draws the kernel from uniform[0, 3e-3)."""
    if final:
        kernel = FINAL_INIT_SCALE * jax.random.uniform(
            key, (fan_in, features), jnp.float32)
    else:
        kernel = lecun_normal(key, (fan_in, features), fan_in)
    return {"kernel": kernel, "bias": jnp.zeros((features,), jnp.float32)}


def dense(p, x, dtype):
    return (jnp.dot(x.astype(dtype), p["kernel"].astype(dtype))
            + p["bias"].astype(dtype))


def layer_norm_init(features: int):
    return {"scale": jnp.ones((features,), jnp.float32),
            "bias": jnp.zeros((features,), jnp.float32)}


def layer_norm(p, x, dtype):
    """Normalise the last axis; statistics in float32, var = E[x^2] -
    E[x]^2 clipped at 0."""
    xf = x.astype(jnp.float32)
    mean = jnp.mean(xf, axis=-1, keepdims=True)
    var = jnp.maximum(jnp.mean(xf * xf, axis=-1, keepdims=True)
                      - mean * mean, 0.0)
    y = (xf - mean) * (jax.lax.rsqrt(var + LN_EPS) * p["scale"]) + p["bias"]
    return y.astype(dtype)


def conv_init(key, in_ch: int, features: int, k: int = 3):
    fan_in = k * k * in_ch
    return {"kernel": lecun_normal(key, (k, k, in_ch, features), fan_in),
            "bias": jnp.zeros((features,), jnp.float32)}


def conv(p, x, dtype, stride: int = 2):
    """SAME-padded strided conv over (..., H, W, C) inputs."""
    lead, (h, w, c) = x.shape[:-3], x.shape[-3:]
    y = jax.lax.conv_general_dilated(
        x.reshape((-1, h, w, c)).astype(dtype), p["kernel"].astype(dtype),
        (stride, stride), "SAME",
        dimension_numbers=("NHWC", "HWIO", "NHWC"))
    y = y + p["bias"].astype(dtype)
    return y.reshape(lead + y.shape[1:])


def _mlp_init(key, in_dim: int, hidden: Sequence[int]):
    layers = []
    for k, h in zip(jax.random.split(key, len(hidden)), hidden):
        layers.append({"dense": dense_init(k, in_dim, h),
                       "norm": layer_norm_init(h)})
        in_dim = h
    return layers


def _mlp(layers, x, dtype):
    """Dense -> LayerNorm -> relu, repeated."""
    for layer in layers:
        x = jax.nn.relu(layer_norm(layer["norm"],
                                   dense(layer["dense"], x, dtype), dtype))
    return x


# --- nets ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class _Torso:
    """Shared MLP torso: Dense -> LayerNorm -> relu, repeated."""

    hidden: Sequence[int]
    dtype: jnp.dtype = jnp.float32

    def init(self, key, x):
        return {"layers": _mlp_init(key, x.shape[-1], self.hidden)}

    def apply(self, params, x):
        return _mlp(params["layers"], x.astype(self.dtype), self.dtype)


@dataclasses.dataclass(frozen=True)
class ActorMLP:
    """Deterministic policy mu(s) in [-1, 1]^action_dim (DDPG actor)."""

    action_dim: int = 2
    hidden: Sequence[int] = (256, 256)
    dtype: jnp.dtype = jnp.float32

    def init(self, key, obs):
        k_t, k_o = jax.random.split(key)
        torso = _Torso(self.hidden, self.dtype)
        # Small final init keeps initial actions near zero (standard DDPG).
        return {"torso": torso.init(k_t, obs),
                "out": dense_init(k_o, self.hidden[-1], self.action_dim,
                                  final=True)}

    def apply(self, params, obs):
        x = _Torso(self.hidden, self.dtype).apply(params["torso"], obs)
        return jnp.tanh(dense(params["out"], x, self.dtype)).astype(
            jnp.float32)


@dataclasses.dataclass(frozen=True)
class CriticMLP:
    """Q(s, a): action enters after the first layer (DDPG critic shape)."""

    hidden: Sequence[int] = (256, 256)
    dtype: jnp.dtype = jnp.float32

    def init(self, key, obs, action):
        k_in, k_rest, k_o = jax.random.split(key, 3)
        h0 = self.hidden[0]
        joined = h0 + action.shape[-1]
        last = self.hidden[-1] if len(self.hidden) > 1 else joined
        return {"in": _mlp_init(k_in, obs.shape[-1], (h0,)),
                "rest": _mlp_init(k_rest, joined, self.hidden[1:]),
                "out": dense_init(k_o, last, 1, final=True)}

    def apply(self, params, obs, action):
        x = _mlp(params["in"], obs.astype(self.dtype), self.dtype)
        x = jnp.concatenate([x, action.astype(self.dtype)], axis=-1)
        x = _mlp(params["rest"], x, self.dtype)
        q = dense(params["out"], x, self.dtype)
        return q.squeeze(-1).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class QNetMLP:
    """Q(s, .) over the 5 discrete actions (DQN)."""

    num_actions: int = 5
    hidden: Sequence[int] = (256, 256)
    dtype: jnp.dtype = jnp.float32

    def init(self, key, obs):
        k_t, k_o = jax.random.split(key)
        return {"torso": _Torso(self.hidden, self.dtype).init(k_t, obs),
                "out": dense_init(k_o, self.hidden[-1], self.num_actions)}

    def apply(self, params, obs):
        x = _Torso(self.hidden, self.dtype).apply(params["torso"], obs)
        return dense(params["out"], x, self.dtype).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class PolicyMLP(QNetMLP):
    """Softmax policy logits over discrete actions (LRPG / REINFORCE)."""

    hidden: Sequence[int] = (64, 64)


@dataclasses.dataclass(frozen=True)
class NafNet:
    """Normalized Advantage Function: Q(s,a) = V(s) + A(s,a) with
    A = -1/2 (a-mu)^T P(s) (a-mu), P = L L^T, L lower-triangular with
    softplus diagonal. apply returns (v, mu) without an action and
    (q, mu, v) with one."""

    action_dim: int = 2
    hidden: Sequence[int] = (256, 256)
    dtype: jnp.dtype = jnp.float32

    def init(self, key, obs, action=None):
        k_t, k_v, k_mu, k_l = jax.random.split(key, 4)
        h, d = self.hidden[-1], self.action_dim
        return {"torso": _Torso(self.hidden, self.dtype).init(k_t, obs),
                "v": dense_init(k_v, h, 1),
                "mu": dense_init(k_mu, h, d, final=True),
                "l": dense_init(k_l, h, d * (d + 1) // 2)}

    def apply(self, params, obs, action=None):
        x = _Torso(self.hidden, self.dtype).apply(params["torso"], obs)
        v = dense(params["v"], x, self.dtype).squeeze(-1).astype(jnp.float32)
        mu = jnp.tanh(dense(params["mu"], x, self.dtype)).astype(jnp.float32)
        if action is None:
            return v, mu
        d = self.action_dim
        l_flat = dense(params["l"], x, self.dtype).astype(jnp.float32)
        rows, cols = np.tril_indices(d)
        l_mat = jnp.zeros(x.shape[:-1] + (d, d), jnp.float32)
        l_mat = l_mat.at[..., rows, cols].set(l_flat)
        diag = jax.nn.softplus(l_mat[..., np.arange(d), np.arange(d)])
        l_mat = l_mat.at[..., np.arange(d), np.arange(d)].set(diag)
        p_mat = l_mat @ jnp.swapaxes(l_mat, -1, -2)
        da = (action - mu)[..., None]
        adv = -0.5 * (jnp.swapaxes(da, -1, -2) @ p_mat @ da)[..., 0, 0]
        return v + adv, mu, v


def _pixels_in(img, dtype):
    """Frames to the compute dtype; uint8 (the env's quantized-obs mode)
    is scaled by 1/255, the same decode the replay would apply."""
    x = img.astype(dtype)
    if img.dtype == jnp.uint8:
        x = x * jnp.asarray(1.0 / 255.0, dtype)
    return x


@dataclasses.dataclass(frozen=True)
class PixelEncoder:
    """Small conv stack for pixel observations -> flat features.

    Reference counterpart: the conv layers in `base_network.py` applied to
    stacked rendered camera frames. Input: (..., H, W, C) float in [0, 1]
    or uint8 (C = channels * cameras * repeats after stacking).
    """

    features: Sequence[int] = (16, 32, 32)
    dtype: jnp.dtype = jnp.float32

    def init(self, key, img):
        layers, c = [], img.shape[-1]
        for k, f in zip(jax.random.split(key, len(self.features)),
                        self.features):
            layers.append(conv_init(k, c, f))
            c = f
        return {"convs": layers}

    def apply(self, params, img):
        x = _pixels_in(img, self.dtype)
        for layer in params["convs"]:
            x = jax.nn.relu(conv(layer, x, self.dtype))
        return x.reshape(x.shape[:-3] + (-1,)).astype(jnp.float32)


@dataclasses.dataclass(frozen=True)
class PatchEncoder:
    """Pixel encoder from non-overlapping patch embeddings: each P x P
    patch goes through a per-patch MLP, and global mixing happens in the
    torso's first Dense over the flattened patch features. Trades the
    conv stack's weight sharing across positions for wide dense
    matmuls.

    Input: (..., H, W, C) float in [0, 1] or uint8; H and W must divide
    by `patch`. Output: (..., (H/P)*(W/P)*features[-1]) float32.
    """

    patch: int = 6
    features: Sequence[int] = (128, 32)
    dtype: jnp.dtype = jnp.float32

    def _patches(self, img):
        x = _pixels_in(img, self.dtype)
        *lead, h, w, c = x.shape
        p = self.patch
        x = x.reshape(*lead, h // p, p, w // p, p, c)
        x = jnp.moveaxis(x, -4, -3)          # (..., hp, wp, p, p, c)
        return x.reshape(*lead, (h // p) * (w // p), p * p * c)

    def init(self, key, img):
        x = self._patches(img)
        return {"layers": _mlp_init(key, x.shape[-1], self.features)}

    def apply(self, params, img):
        x = _mlp(params["layers"], self._patches(img), self.dtype)
        return x.reshape(x.shape[:-2] + (-1,)).astype(jnp.float32)


def _encoder(encoder: str, conv_features, dtype):
    """Encoder factory shared by the Visual* nets ("conv" | "patch")."""
    if encoder == "patch":
        return PatchEncoder(dtype=dtype)
    if encoder != "conv":
        raise ValueError(f"encoder must be 'conv' or 'patch', got "
                         f"{encoder!r}")
    return PixelEncoder(tuple(conv_features), dtype)


@dataclasses.dataclass(frozen=True)
class _Visual:
    """Encoder + head: `head` maps encoded features (+ extra inputs) to
    the net's outputs; init/apply thread the encoder's features into it.
    Subclasses set `_head()`."""

    hidden: Sequence[int] = (256, 256)
    features: Sequence[int] = (16, 32, 32)
    dtype: jnp.dtype = jnp.float32
    encoder: str = "conv"

    def _enc(self):
        return _encoder(self.encoder, self.features, self.dtype)

    def init(self, key, img, *rest):
        k_e, k_h = jax.random.split(key)
        enc = self._enc()
        enc_params = enc.init(k_e, img)
        feats = jax.eval_shape(enc.apply, enc_params, img)
        return {"encoder": enc_params,
                "head": self._head().init(
                    k_h, jnp.zeros(feats.shape, feats.dtype), *rest)}

    def apply(self, params, img, *rest):
        x = self._enc().apply(params["encoder"], img)
        return self._head().apply(params["head"], x, *rest)


@dataclasses.dataclass(frozen=True)
class VisualActor(_Visual):
    """PixelEncoder + ActorMLP: deterministic policy from raw frames
    (the reference's conv stack feeding `ddpg_cartpole.py`'s actor)."""

    action_dim: int = 2

    def _head(self):
        return ActorMLP(self.action_dim, self.hidden, self.dtype)


@dataclasses.dataclass(frozen=True)
class VisualCritic(_Visual):
    """PixelEncoder + CriticMLP: Q(frames, action)."""

    def _head(self):
        return CriticMLP(self.hidden, self.dtype)


@dataclasses.dataclass(frozen=True)
class VisualQNet(_Visual):
    """PixelEncoder + QNetMLP: discrete Q-values from raw frames."""

    num_actions: int = 5

    def _head(self):
        return QNetMLP(self.num_actions, self.hidden, self.dtype)


@dataclasses.dataclass(frozen=True)
class VisualNafNet(_Visual):
    """PixelEncoder + NafNet: quadratic-advantage Q from raw frames (the
    reference's conv stack fed `naf_cartpole.py`'s heads — SURVEY.md §2a
    NAF row). Same contract as NafNet."""

    action_dim: int = 2

    def _head(self):
        return NafNet(self.action_dim, self.hidden, self.dtype)

    def apply(self, params, img, action=None):
        x = self._enc().apply(params["encoder"], img)
        return self._head().apply(params["head"], x, action)


@dataclasses.dataclass(frozen=True)
class VisualPolicy(_Visual):
    """PixelEncoder + PolicyMLP: softmax policy logits from raw frames
    (pixel-observation LRPG)."""

    num_actions: int = 5
    hidden: Sequence[int] = (64, 64)

    def _head(self):
        return PolicyMLP(self.num_actions, self.hidden, self.dtype)
