"""Device-resident experience replay.

Reference counterpart: `replay_memory.py::ReplayMemory.{add,batch}` — a
host-side numpy ring buffer of (s, a, r, s', done) with uniform minibatch
sampling, shared by the DQN/NAF/DDPG trainers (SURVEY.md §2a).

Redesign:
  * The buffer is a pytree of device arrays laid out `(num_envs,
    capacity_per_env, ...)` — the env axis is the SAME axis the environment
    batch is sharded on, so under a `Mesh(('data',))` sharding each chip
    inserts its own envs' transitions with zero cross-chip traffic, and
    uniform sampling over (env, slot) pairs is uniform over the global
    buffer by symmetry.
  * `add` writes one batch-row per env-step via a single
    `dynamic_update_slice_in_dim` at the ring cursor — no host round trip,
    no scatter.
  * Next-observations are not stored: the rollout stores obs[t] and
    obs[t+1] is read from the following slot at sample time, halving HBM
    footprint. A `valid` mask excludes the cursor slot (whose successor is
    stale) and episode boundaries are handled with the stored `done` flag
    (done transitions bootstrap with 0, so their stale successor obs is
    multiplied by zero — the standard trick, exact for 1-step TD).
"""

from __future__ import annotations

from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

class ReplayState(NamedTuple):
    """Ring-buffer contents. Leading dims: (num_envs, capacity_per_env)."""

    obs: jax.Array      # (B, C, obs_dim) float32
    action: jax.Array   # (B, C) int32 or (B, C, act_dim) float32
    reward: jax.Array   # (B, C) float32
    done: jax.Array     # (B, C) bool — episode ended at this transition
    cursor: jax.Array   # () int32 — next slot to write
    filled: jax.Array   # () int32 — number of valid slots (<= capacity)


class ReplayBuffer:
    """Static configuration + pure add/sample functions.

    obs_shape: per-env observation shape; (obs_dim,) for flat modes or
    (H, W, C) for pixels. quantize_obs=True stores frames as uint8
    ([0,1] float <-> 0..255), an 8x HBM saving that makes pixel replay
    feasible at thousands of envs (the reference stored raw frames in its
    numpy ring too, at far smaller scale).
    """

    def __init__(self, num_envs: int, capacity_per_env: int,
                 obs_dim: int | None = None, action_dim: int = 0,
                 discrete: bool = True, obs_shape: tuple | None = None,
                 quantize_obs: bool = False):
        if obs_shape is None:
            if obs_dim is None:
                raise ValueError("need obs_dim or obs_shape")
            obs_shape = (obs_dim,)
        self.num_envs = num_envs
        self.capacity = capacity_per_env
        self.obs_shape = tuple(obs_shape)
        self.obs_dim = obs_dim
        self.action_dim = action_dim
        self.discrete = discrete
        self.quantize_obs = quantize_obs
        # Pixel obs are stored FLAT: (B, C, H*W*ch) instead of
        # (B, C, H, W, ch). 48x48x18 = 41472 = 324 lanes exactly, so the
        # ring tiles with zero padding and XLA keeps the natural
        # minor-to-major layout — with the 5-D shape a layout assigner
        # may pick an env-minor layout and insert a full-ring relayout
        # copy, which can alone exhaust device memory at pixel scale.
        self._flat_dim = int(np.prod(self.obs_shape))

    def _encode_obs(self, obs):
        """(..., *obs_shape) -> (..., flat) in the storage dtype."""
        lead = obs.shape[:obs.ndim - len(self.obs_shape)]
        obs = obs.reshape(lead + (self._flat_dim,))
        if self.quantize_obs:
            if obs.dtype == jnp.uint8:  # env already quantized (obs_uint8)
                return obs
            return jnp.clip(obs * 255.0 + 0.5, 0.0, 255.0).astype(jnp.uint8)
        return obs.astype(jnp.float32)

    def _reshape_obs(self, stored):
        """(..., flat) -> (..., *obs_shape) in the STORAGE dtype
        (decode=False sampling: pixel encoders consume uint8
        directly with the same 1/255 scaling _decode_obs applies).
        """
        return stored.reshape(stored.shape[:-1] + self.obs_shape)

    def _decode_obs(self, stored):
        """(..., flat) -> (..., *obs_shape) float32."""
        out = stored.reshape(stored.shape[:-1] + self.obs_shape)
        if self.quantize_obs:
            return out.astype(jnp.float32) * jnp.float32(1.0 / 255.0)
        return out

    def init(self) -> ReplayState:
        b, c = self.num_envs, self.capacity
        if self.discrete:
            action = jnp.zeros((b, c), jnp.int32)
        else:
            action = jnp.zeros((b, c, self.action_dim), jnp.float32)
        obs_dtype = jnp.uint8 if self.quantize_obs else jnp.float32
        return ReplayState(
            obs=jnp.zeros((b, c, self._flat_dim), obs_dtype),
            action=action,
            reward=jnp.zeros((b, c), jnp.float32),
            done=jnp.zeros((b, c), bool),
            cursor=jnp.int32(0),
            filled=jnp.int32(0),
        )

    def add(self, rs: ReplayState, obs, action, reward, done) -> ReplayState:
        """Insert one transition per env at the ring cursor.

        obs: (B,) + obs_shape; action: (B,) or (B, act_dim);
        reward/done: (B,).
        """
        i = rs.cursor

        def put(buf, row):
            row = jnp.expand_dims(row.astype(buf.dtype), 1)
            return jax.lax.dynamic_update_slice_in_dim(buf, row, i, axis=1)

        return ReplayState(
            obs=put(rs.obs, self._encode_obs(obs)),
            action=put(rs.action, action),
            reward=put(rs.reward, reward),
            done=put(rs.done, done),
            cursor=(i + 1) % self.capacity,
            filled=jnp.minimum(rs.filled + 1, self.capacity),
        )

    def add_trajectory(self, rs: ReplayState, obs, action, reward,
                       done, aligned: bool = False) -> ReplayState:
        """Insert a time-major rollout chunk: obs (T, B, obs_dim) etc.

        Fast path (the one that runs in practice): when the chunk length
        divides the capacity and the cursor is chunk-aligned — always
        true when the buffer is fed only by fixed-length rollouts — the
        whole chunk lands as ONE batch-major dynamic_update_slice
        (~2 ms at 4096 envs x 32 steps). The fallback for odd
        shapes/cursors is a batch-major scatter on the wrapped slot
        indices — in-place like the DUS (a per-step scan here made XLA
        double-buffer the whole ring: the round-1 28.5 ms/chunk
        bottleneck, and a full-ring HLO-temp copy that OOMed pixel
        replay at 512 envs).

        aligned=True asserts the cursor-alignment invariant STATICALLY
        (callers that only ever insert fixed-length chunks: the agents,
        whose cursor starts at 0 and always advances by t). Motivation:
        the runtime `lax.cond` between fast and slow made XLA
        materialize TWO full-ring copies at the cond boundary every
        train step, dwarfing the actual insert on a multi-GB pixel
        ring. train.py
        re-aligns the cursor at the restore boundary so a checkpoint
        taken under a different rollout length cannot violate the
        invariant.
        """
        t = obs.shape[0]

        def slow(rs):
            i = rs.cursor
            # t > capacity: only the last `capacity` writes survive a
            # sequential ring pass — drop the overwritten prefix so the
            # scatter indices stay unique (duplicate-index set order is
            # unspecified).
            off = max(t - self.capacity, 0)
            tt = t - off
            idx = (i + off + jnp.arange(tt, dtype=jnp.int32)) % self.capacity

            def put(buf, rows):
                rows = jnp.moveaxis(rows[off:].astype(buf.dtype), 0, 1)
                return buf.at[:, idx].set(rows)

            return ReplayState(
                obs=put(rs.obs, self._encode_obs(obs)),
                action=put(rs.action, action),
                reward=put(rs.reward, reward),
                done=put(rs.done, done),
                cursor=(i + t) % self.capacity,
                filled=jnp.minimum(rs.filled + t, self.capacity),
            )

        if self.capacity % t != 0 or t > self.capacity:
            return slow(rs)

        def fast(rs):
            i = rs.cursor

            def put(buf, rows):
                # One batch-major DUS after a (T, B, flat) ->
                # (B, T, flat) relayout. Round 5 measured the "obvious"
                # alternative — T unrolled per-step DUS writes straight
                # from the time-major layout, saving the ~1 ms relayout
                # copy — at 551k vs 705k env-steps/s e2e at the pixel
                # operating point: XLA does not alias the sequential
                # DUS chain on the multi-GB ring inside the scan, so
                # each step paid far more than the transpose it saved.
                rows = jnp.moveaxis(rows.astype(buf.dtype), 0, 1)
                return jax.lax.dynamic_update_slice_in_dim(
                    buf, rows, i, axis=1)

            return ReplayState(
                obs=put(rs.obs, self._encode_obs(obs)),
                action=put(rs.action, action),
                reward=put(rs.reward, reward),
                done=put(rs.done, done),
                cursor=(i + t) % self.capacity,
                filled=jnp.minimum(rs.filled + t, self.capacity),
            )

        if aligned:
            return fast(rs)
        return jax.lax.cond(rs.cursor % t == 0, fast, slow, rs)

    def sample_columns(self, rs: ReplayState, key, batch_size: int,
                       decode: bool = True):
        """Column minibatch: whole ring COLUMNS (one random valid slot x
        all envs) instead of independent (env, slot) pairs.

        Rationale: `sample`'s per-row gather cost grows with the batch
        and at production batch sizes made the learner gather-bound. A
        column is k static dynamic-slices — contiguous, ~free. Statistically the batch stays diverse: the
        envs are thousands of INDEPENDENT chains (decorrelated pushes
        and resets by per-env counter RNG), so a synchronized column is
        an iid sample across envs; temporal diversity comes from drawing
        fresh slots every update. The column-sampling DDPG recipe was
        validated to balance the pole to the cap like uniform sampling.

        batch_size rows are returned: ceil(batch/B) columns, trimmed at
        a random env offset when batch_size is not a multiple of B.
        """
        b = self.num_envs
        k = -(-batch_size // b)  # columns needed
        k_slot, k_env = jax.random.split(key)
        n_valid = jnp.maximum(rs.filled - 1, 1)
        ages = jax.random.randint(k_slot, (k,), 1, n_valid + 1)
        slots = (rs.cursor - 1 - ages) % self.capacity

        def col(buf, s):
            return jax.lax.dynamic_slice_in_dim(buf, s, 1, axis=1)[:, 0]

        def cols(buf, ss):
            return jnp.concatenate([col(buf, ss[i]) for i in range(k)], 0)

        dec = (self._decode_obs if decode else
               self._reshape_obs)   # storage dtype, frame shape
        obs = dec(cols(rs.obs, slots))
        next_obs = dec(cols(rs.obs, (slots + 1) % self.capacity))
        action = cols(rs.action, slots)
        reward = cols(rs.reward, slots)
        done = cols(rs.done, slots)
        batch = (obs, action, reward, next_obs, done)
        if batch_size == k * b:
            return batch
        # Trim to batch_size at a random offset (wrap via double-concat).
        off = jax.random.randint(k_env, (), 0, k * b)

        def trim(x):
            return jax.lax.dynamic_slice_in_dim(
                jnp.concatenate([x, x], 0), off, batch_size, axis=0)

        return tuple(trim(x) for x in batch)

    def presample_columns(self, rs: ReplayState, keys, batch_size: int,
                          decode: bool = True):
        """All K update minibatches as ONE gather per ring buffer.

        Bitwise-equivalent to `jax.vmap(sample_columns)` over the K
        per-update keys (same randint draws per key, same
        column-concatenation row order), but the K x columns slot reads
        collapse into a single `jnp.take` along the slot axis per buffer
        — the vmapped form lowers to per-key dynamic-slice chains whose
        ~20 us fixed cost each lands on the serial op stream
        (docs/design.md §8d/§8e). Any batch_size: when it is not a whole
        number of columns, the per-update random-offset trim of
        sample_columns is applied as one batched wrap-around gather
        (bitwise the same rows; round 4 — the vmapped fallback this
        replaces compiled pathologically for pixel rings)."""
        b = self.num_envs
        k_cols = -(-batch_size // b)                # columns per update
        n_valid = jnp.maximum(rs.filled - 1, 1)

        def slots_for(key):
            k_slot, k_env = jax.random.split(key)
            ages = jax.random.randint(k_slot, (k_cols,), 1, n_valid + 1)
            off = jax.random.randint(k_env, (), 0, k_cols * b)
            return (rs.cursor - 1 - ages) % self.capacity, off

        slots, offs = jax.vmap(slots_for)(keys)     # (K, C), (K,) — tiny
        flat = slots.reshape(-1)                    # (K*C,)
        kk = keys.shape[0]
        trim = batch_size != k_cols * b
        # sample_columns trims `batch_size` rows at a random offset with
        # wraparound (dynamic_slice over a doubled axis); the same rows
        # via one modular take_along_axis per buffer, outside the scan.
        row_idx = (offs[:, None]
                   + jnp.arange(batch_size, dtype=jnp.int32)[None, :]) \
            % (k_cols * b)                          # (K, bs)

        def fetch(buf, idx):
            """(B, K*C, ...) columns from the ring, as one op or K*C
            dynamic slices. jnp.take along the slot axis is the right
            call for small (state) rings — one fused gather — but it
            can lower to a windowed sweep of the ENTIRE source for
            multi-GB pixel rings (reading 1.8 GB to select 16
            columns). Unrolled dynamic slices read only
            the selected columns (~6.9 MB each) at the cost of K*C
            serial ops — the winning trade exactly when rows are fat,
            which quantize_obs marks."""
            if self.quantize_obs:
                cols = [jax.lax.dynamic_slice_in_dim(buf, idx[i], 1,
                                                     axis=1)
                        for i in range(idx.shape[0])]
                return jnp.concatenate(cols, 1)
            return jnp.take(buf, idx, axis=1)

        def take(buf, idx):
            # (B, K*C, ...) -> (K, C*B, ...) in sample_columns's
            # concat order (column-major over envs within each update).
            out = fetch(buf, idx)
            out = jnp.moveaxis(out, 1, 0)
            out = out.reshape((kk, k_cols * b) + buf.shape[2:])
            if trim and self.quantize_obs:
                # Same wrap-around rows as the take_along_axis below,
                # via 2 dynamic slices per update on the doubled row
                # axis — the gather read the full K x column block
                # (2 x 113 MB/step at the pixel preset shape) to emit
                # the trimmed half.
                rows = [jax.lax.dynamic_slice_in_dim(
                    jnp.concatenate([out[k], out[k]], 0),
                    offs[k], batch_size, axis=0)
                    for k in range(kk)]
                out = jnp.stack(rows, 0)
            elif trim:
                ridx = row_idx.reshape((kk, batch_size)
                                       + (1,) * (out.ndim - 2))
                out = jnp.take_along_axis(out, ridx, axis=1)
            return out

        dec = (self._decode_obs if decode else
               self._reshape_obs)   # storage dtype, frame shape
        obs = dec(take(rs.obs, flat))
        next_obs = dec(
            take(rs.obs, (flat + 1) % self.capacity))
        return (obs, take(rs.action, flat), take(rs.reward, flat),
                next_obs, take(rs.done, flat))

    def sample_block(self, rs: ReplayState, key, batch_size: int,
                     decode: bool = True):
        """Block minibatch: one random valid slot x one ALIGNED
        contiguous block of envs (batch_size must divide num_envs).

        Motivation (measured, round 5): column sampling fetches the
        WHOLE (num_envs,)-row column and trims batch_size rows — at the
        570k pixel config that is 2 x 16 x 28 MB of uint8 ring reads
        per train call to keep 1/8th (hlo_stats: the two ~1.3 ms
        slice_bitcast fusions). An aligned env block is ONE
        (batch_size,)-high dynamic slice per buffer — 8x less read
        traffic at batch 256 / 2048 envs. Statistically: the slot is
        uniform over valid history exactly as in column mode; within a
        slot, envs are independent chains, and aligned blocks make
        every env's inclusion probability exactly batch_size/num_envs
        (an unaligned random window would under-sample edge envs).
        Co-occurrence is restricted to fixed partitions — irrelevant
        for mean-gradient SGD; quality was validated before it became
        the pixel-preset default."""
        b = self.num_envs
        if batch_size > b or b % batch_size:
            raise ValueError("block sampling needs batch_size | num_envs")
        k_slot, k_env = jax.random.split(key)
        n_valid = jnp.maximum(rs.filled - 1, 1)
        age = jax.random.randint(k_slot, (), 1, n_valid + 1)
        slot = (rs.cursor - 1 - age) % self.capacity
        blk = jax.random.randint(k_env, (), 0, b // batch_size)
        off = blk * batch_size

        def cut(buf, s):
            sl = jax.lax.dynamic_slice_in_dim(buf, off, batch_size, 0)
            return jax.lax.dynamic_slice_in_dim(sl, s, 1, axis=1)[:, 0]

        dec = (self._decode_obs if decode else self._reshape_obs)
        return (dec(cut(rs.obs, slot)), cut(rs.action, slot),
                cut(rs.reward, slot),
                dec(cut(rs.obs, (slot + 1) % self.capacity)),
                cut(rs.done, slot))

    def presample_block(self, rs: ReplayState, keys, batch_size: int,
                        decode: bool = True):
        """All K block minibatches, K x 2 unrolled dynamic slices per
        buffer — bitwise-equivalent to `jax.vmap(sample_block)` over
        the K per-update keys (identical randint draws), reading ONLY
        the batch_size x 1 tiles it returns."""
        b = self.num_envs
        if batch_size > b or b % batch_size:
            raise ValueError("block sampling needs batch_size | num_envs")
        n_valid = jnp.maximum(rs.filled - 1, 1)

        def draw(key):
            k_slot, k_env = jax.random.split(key)
            age = jax.random.randint(k_slot, (), 1, n_valid + 1)
            blk = jax.random.randint(k_env, (), 0, b // batch_size)
            return (rs.cursor - 1 - age) % self.capacity, blk * batch_size

        slots, offs = jax.vmap(draw)(keys)          # (K,), (K,) — tiny
        kk = keys.shape[0]

        def take(buf, next_slot: bool):
            outs = []
            for i in range(kk):
                s = (slots[i] + 1) % self.capacity if next_slot \
                    else slots[i]
                sl = jax.lax.dynamic_slice_in_dim(buf, offs[i],
                                                  batch_size, 0)
                outs.append(jax.lax.dynamic_slice_in_dim(sl, s, 1,
                                                         axis=1)[:, 0])
            return jnp.stack(outs, 0)               # (K, bs, ...)

        dec = (self._decode_obs if decode else self._reshape_obs)
        return (dec(take(rs.obs, False)), take(rs.action, False),
                take(rs.reward, False), dec(take(rs.obs, True)),
                take(rs.done, False))

    def presample_uniform(self, rs: ReplayState, keys, batch_size: int,
                          decode: bool = True):
        """All K uniform minibatches as ONE flat gather per ring buffer —
        bitwise-equivalent to `jax.vmap(sample)` over the K per-update
        keys (same (env, slot) draws), but the K x batch per-row gathers
        collapse into a single take over env*capacity-flattened buffers."""
        k_updates = keys.shape[0]

        def draw(key):
            k_env, k_slot = jax.random.split(key)
            env_idx = jax.random.randint(k_env, (batch_size,), 0,
                                         self.num_envs)
            n_valid = jnp.maximum(rs.filled - 1, 1)
            age = jax.random.randint(k_slot, (batch_size,), 1, n_valid + 1)
            slot = (rs.cursor - 1 - age) % self.capacity
            return env_idx, slot

        env_idx, slot = jax.vmap(draw)(keys)        # (K, Bm) each — tiny
        flat = (env_idx * self.capacity + slot).reshape(-1)
        flat_next = (env_idx * self.capacity
                     + (slot + 1) % self.capacity).reshape(-1)

        def take(buf, idx):
            flat_buf = buf.reshape((self.num_envs * self.capacity,)
                                   + buf.shape[2:])
            return jnp.take(flat_buf, idx, axis=0).reshape(
                (k_updates, batch_size) + buf.shape[2:])

        dec = (self._decode_obs if decode else
               self._reshape_obs)   # storage dtype, frame shape
        obs = dec(take(rs.obs, flat))
        next_obs = dec(take(rs.obs, flat_next))
        return (obs, take(rs.action, flat), take(rs.reward, flat),
                next_obs, take(rs.done, flat))

    def sample(self, rs: ReplayState, key, batch_size: int,
               decode: bool = True):
        """Uniform minibatch of (obs, action, reward, next_obs, done).

        Samples (env, slot) pairs uniformly over valid slots; next_obs is
        the chronologically next slot (slot+1 mod capacity). The slot just
        before the cursor is excluded because its successor has been
        overwritten (or never written).
        """
        k_env, k_slot = jax.random.split(key)
        env_idx = jax.random.randint(k_env, (batch_size,), 0, self.num_envs)
        # Valid "has a successor" slots: the filled ones minus the newest.
        n_valid = jnp.maximum(rs.filled - 1, 1)
        # Newest slot is cursor-1; oldest is cursor-filled. Draw an age in
        # [1, n_valid] behind the cursor so slot+1 is always also valid.
        age = jax.random.randint(k_slot, (batch_size,), 1, n_valid + 1)
        slot = (rs.cursor - 1 - age) % self.capacity
        nxt = (slot + 1) % self.capacity
        dec = (self._decode_obs if decode else
               self._reshape_obs)   # storage dtype, frame shape
        obs = dec(rs.obs[env_idx, slot])
        next_obs = dec(rs.obs[env_idx, nxt])
        action = rs.action[env_idx, slot]
        reward = rs.reward[env_idx, slot]
        done = rs.done[env_idx, slot]
        return obs, action, reward, next_obs, done
