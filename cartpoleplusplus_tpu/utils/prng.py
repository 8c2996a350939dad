"""Counter-based stateless PRNG for env randomness.

Why not jax.random/threefry: every env-step of the lockstep batch draws
reset + push randomness for *all* envs (masked auto-reset computes both
branches). Threefry costs more ALU ops than the entire 15-substep physics;
a statistical-quality integer mixer is ~15 ops per draw. It is also pure
uint32 elementwise arithmetic, so the *identical* sequence is reproducible
in the jnp path, inside the Pallas kernel, and in the numpy oracle harness
— which threefry (host-seeded) and a hardware PRNG cannot give us
simultaneously.

Mixer: 'triple32' (exact-bias-optimal 32-bit permutation, public domain,
Chris Wellons' hash-prospector), combined over words hash_combine-style.
Randomness quality requirements here are modest (push directions and
magnitudes); determinism and cost are what matter.

Reference counterpart: numpy's global RandomState used by
`bullet_cartpole.py` for push perturbations (recall; mount empty).
"""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np

# numpy scalars (not jnp) so kernels do not capture device constants
_GOLDEN = np.uint32(0x9E3779B9)


def triple32(x):
    """Bijective 32-bit mixer. x: uint32 array."""
    x = jnp.asarray(x, jnp.uint32)
    x = x ^ (x >> 17)
    x = x * np.uint32(0xED5AD4BB)
    x = x ^ (x >> 11)
    x = x * np.uint32(0xAC4C1B51)
    x = x ^ (x >> 15)
    x = x * np.uint32(0x31848BAB)
    x = x ^ (x >> 14)
    return x


def hash_words(*words):
    """Combine integer words (arrays broadcast together) into one uint32."""
    h = np.uint32(0x243F6A88)  # pi fraction
    for w in words:
        h = triple32((h + _GOLDEN) ^ jnp.asarray(w, jnp.uint32))
    return h


def uniform_from_bits(bits, lo=0.0, hi=1.0):
    """uint32 bits -> float32 uniform in [lo, hi). Uses the top 24 bits.

    The int32 hop is exact (bits >> 8 < 2^24) and keeps the conversion
    a signed one, which every backend lowers (the fused kernel included).
    """
    u = (bits >> np.uint32(8)).astype(jnp.int32).astype(jnp.float32) \
        * np.float32(1.0 / (1 << 24))
    return lo + u * (hi - lo)


def uniform(lo, hi, *words):
    """One uniform draw per element of the broadcast word arrays."""
    return uniform_from_bits(hash_words(*words), lo, hi)


def normal(*words):
    """One standard-normal draw per element of the broadcast word arrays.

    Box-Muller over two tag-salted counter streams — like `uniform`, a
    pure function of the words, so agent exploration noise derived from
    (per-env seed, global step) is bitwise independent of batch slot,
    sharding layout, or host count (the CLAUDE.md randomness invariant,
    extended from env randomness to agent randomness).
    """
    u1 = uniform_from_bits(hash_words(*words, np.uint32(0xB0)),
                           lo=np.float32(2.0 ** -24), hi=1.0)
    u2 = uniform_from_bits(hash_words(*words, np.uint32(0xB1)))
    return jnp.sqrt(-2.0 * jnp.log(u1)) * jnp.cos(
        np.float32(2.0 * np.pi) * u2)


def gumbel(*words):
    """One standard-Gumbel draw per element: g = -log(-log(u)).

    For Gumbel-max categorical sampling (argmax(logits + g) is an exact
    softmax sample). u is clamped to [2^-24, 1) so both logs are finite.
    Same counter-stream contract as `normal` — a pure function of the
    words, usable identically in XLA, Pallas kernels, and numpy."""
    u = uniform_from_bits(hash_words(*words, np.uint32(0xB2)),
                          lo=np.float32(2.0 ** -24), hi=1.0)
    return -jnp.log(-jnp.log(u))
