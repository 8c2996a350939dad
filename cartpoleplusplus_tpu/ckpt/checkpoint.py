"""Checkpointing of full agent training states, with numpy and JSON only.

The unit of persistence is the agent's TrainState NamedTuple (ddpg.py
etc.) — a pure pytree of arrays. One checkpoint is a directory holding
`arrays.npz` (every leaf, keyed by its path in the tree, e.g.
`actor/torso/layers/0/dense/kernel`) and `manifest.json` (the step,
the top-level fields on disk, and each leaf's shape and dtype). A save
is written to a temporary directory and renamed into place, so a reader
never sees a half-written checkpoint. `CheckpointManager` adds the
periodic-save / retention / resume bookkeeping the reference exposed
via TF Saver + `--ckpt-dir`.

Restores land on the TARGET's placement: each leaf is put with the
sharding of the matching leaf of the provided state, so a checkpoint
written on one mesh restores onto another.

On a multi-process mesh (`dist.initialize_multihost`) every process
calls save and restore together: a save gathers the leaves that span
processes (a collective), process 0 alone writes, and all processes wait
for the write before going on. Every process reads the checkpoint to
restore, so the directory must be on a filesystem they share.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile

import jax
import numpy as np

MANIFEST = "manifest.json"
ARRAYS = "arrays.npz"
FORMAT_VERSION = 1


def _to_pytree(state, exclude=()):
    """NamedTuple -> plain nested dict (field-named).

    exclude: top-level field names to drop — e.g. ("replay",) for
    weights-only checkpoints when the replay buffer dwarfs the network
    (pixel replays easily exceed 1 GB; the reference's TF Saver likewise
    persisted only variables). Excluded fields restore to the values of
    the provided target (i.e. a fresh buffer), trading bit-exact resume
    for small, fast saves.
    """
    if hasattr(state, "_asdict"):
        return {k: _to_pytree(v) for k, v in state._asdict().items()
                if k not in exclude}
    return state


def _key_name(k) -> str:
    for attr in ("key", "name", "idx"):
        if hasattr(k, attr):
            return str(getattr(k, attr))
    return str(k)


def _leaves_by_name(tree) -> dict:
    """{'a/b/0/c': leaf} over every leaf of a nested container tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(_key_name(k) for k in path): leaf
            for path, leaf in flat}


def _storable(a: np.ndarray) -> np.ndarray:
    """numpy's .npy format has no code for ml_dtypes (bfloat16 etc.):
    store those as unsigned ints of the same width; the manifest keeps
    the real dtype."""
    if a.dtype.kind == "V" or a.dtype.type.__module__ == "ml_dtypes":
        return a.view(np.dtype(f"uint{8 * a.dtype.itemsize}"))
    return a


def _host_array(leaf) -> np.ndarray:
    """A leaf as one numpy array on this host; a leaf that spans
    processes is gathered (a collective: every process must call)."""
    if isinstance(leaf, jax.Array) and not leaf.is_fully_addressable:
        from jax.experimental import multihost_utils
        return np.asarray(multihost_utils.process_allgather(leaf, tiled=True))
    return np.asarray(leaf)


def _sync(tag: str) -> None:
    """Barrier across processes (no-op in a single-process run)."""
    if jax.process_count() > 1:
        from jax.experimental import multihost_utils
        multihost_utils.sync_global_devices(tag)


def _write(path: str, state, exclude: tuple, step=None) -> None:
    tree = _to_pytree(state, exclude)
    arrays = {name: _host_array(leaf)
              for name, leaf in _leaves_by_name(tree).items()}
    if jax.process_index() == 0:
        _write_files(os.path.abspath(path), arrays, {
            "format": FORMAT_VERSION,
            "step": step,
            "fields": sorted(tree) if isinstance(tree, dict) else [],
            "leaves": {name: {"shape": list(a.shape), "dtype": a.dtype.name}
                       for name, a in arrays.items()},
        })
    _sync(f"ckpt write {path}")


def _write_files(path: str, arrays: dict, manifest: dict) -> None:
    parent = os.path.dirname(path)
    os.makedirs(parent, exist_ok=True)
    tmp = tempfile.mkdtemp(prefix=".tmp-" + os.path.basename(path) + "-",
                           dir=parent)
    try:
        np.savez(os.path.join(tmp, ARRAYS),
                 **{n: _storable(a) for n, a in arrays.items()})
        with open(os.path.join(tmp, MANIFEST), "w") as f:
            json.dump(manifest, f, indent=1)
        if os.path.exists(path):   # overwrite: move the old one aside first
            old = path + ".old"
            shutil.rmtree(old, ignore_errors=True)
            os.replace(path, old)
            os.replace(tmp, path)
            shutil.rmtree(old, ignore_errors=True)
        else:
            os.replace(tmp, path)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def read_manifest(path: str) -> dict:
    with open(os.path.join(path, MANIFEST)) as f:
        return json.load(f)


def _place(value: np.ndarray, like):
    """Put a restored array where the target leaf lives."""
    if not isinstance(like, jax.Array):
        return value
    if like.is_fully_addressable:
        return jax.device_put(value, like.sharding)
    return jax.make_array_from_callback(value.shape, like.sharding,
                                        lambda idx: value[idx])


def _read(path: str, target, exclude: tuple = ()):
    """Restore the on-disk fields of `target` (minus `exclude`); fields
    missing on disk keep the target's values."""
    manifest = read_manifest(path)
    on_disk = set(manifest["fields"])
    want = _to_pytree(target, exclude)
    dropped = sorted(k for k in want if k not in on_disk)
    if dropped:
        print(f"ckpt: {', '.join(dropped)} not in checkpoint (weights-only "
              "save?); keeping fresh values", file=sys.stderr)
    request = {k: v for k, v in want.items() if k in on_disk}
    with np.load(os.path.join(path, ARRAYS)) as data:
        def load(name, like):
            meta = manifest["leaves"][name]
            a = data[name]
            dtype = np.dtype(jax.numpy.dtype(meta["dtype"]))
            if a.dtype != dtype:
                a = a.view(dtype)
            shape = tuple(np.shape(like))
            if tuple(a.shape) != shape:
                raise ValueError(f"ckpt leaf {name}: shape {a.shape} on "
                                 f"disk, target has {shape}")
            return _place(a, like)

        flat, treedef = jax.tree_util.tree_flatten_with_path(request)
        leaves = [load("/".join(_key_name(k) for k in p), leaf)
                  for p, leaf in flat]
    restored = jax.tree_util.tree_unflatten(treedef, leaves)
    return _merge_restored(target, restored)


def _merge_restored(template, tree):
    """Rebuild the NamedTuple structure of `template` from a plain dict;
    fields missing from `tree` (excluded at save time) keep the
    template's value."""
    if hasattr(template, "_asdict"):
        return type(template)(**{
            k: (_merge_restored(v, tree[k]) if k in tree else v)
            for k, v in template._asdict().items()})
    return tree


def save_checkpoint(path: str, state, force: bool = True,
                    exclude: tuple = ()) -> None:
    """Write one checkpoint to `path` (a directory). An existing
    checkpoint there is replaced only with force=True."""
    if os.path.exists(path) and not force:
        raise FileExistsError(path)
    _write(path, state, tuple(exclude))


def restore_checkpoint(path: str, target, exclude: tuple = ()):
    """Restore into the structure (and shardings) of `target` — pass the
    freshly-initialized agent state; arrays land with target's sharding,
    which makes this re-layout safe. Fields absent from the on-disk
    checkpoint (a weights-only save) keep target's values; `exclude`
    drops further fields from the request regardless."""
    return _read(os.path.abspath(path), target, tuple(exclude))


class CheckpointManager:
    """Periodic save / latest-resume over a checkpoint directory
    (`<directory>/<step>/`), keeping the newest `max_to_keep` (None or 0
    keeps all).

    Reference counterpart: the TF Saver save-every-N-steps loop. Saves
    are synchronous; `wait_until_finished` and `close` exist so callers
    need not know that.
    """

    def __init__(self, directory: str, save_interval_steps: int = 1,
                 max_to_keep: int = 3, exclude: tuple = ()):
        self.directory = os.path.abspath(directory)
        self._interval = max(int(save_interval_steps), 1)
        self._max_to_keep = max_to_keep
        self._exclude = tuple(exclude)
        os.makedirs(self.directory, exist_ok=True)

    def all_steps(self) -> list:
        return sorted(int(n) for n in os.listdir(self.directory)
                      if n.isdigit() and os.path.isfile(
                          os.path.join(self.directory, n, MANIFEST)))

    def latest_step(self):
        steps = self.all_steps()
        return steps[-1] if steps else None

    def should_save(self, step: int) -> bool:
        """Whether the interval policy would save at `step`: a multiple
        of the interval, newer than the latest checkpoint."""
        latest = self.latest_step()
        return (step % self._interval == 0
                and (latest is None or step > latest))

    def save(self, step: int, state, force: bool = False) -> bool:
        """Save if the interval policy says so; returns whether saved.

        force=True bypasses the policy — REQUIRED when the caller's save
        cadence is windowed (train.py's chunked dispatch lands on step
        indices like 511, 1007 that satisfy the caller's interval window
        but not `step % interval == 0`)."""
        if not force and not self.should_save(step):
            return False
        _write(os.path.join(self.directory, str(step)), state,
               self._exclude, step=step)
        if self._max_to_keep and jax.process_index() == 0:
            for old in self.all_steps()[:-self._max_to_keep]:
                shutil.rmtree(os.path.join(self.directory, str(old)),
                              ignore_errors=True)
        _sync(f"ckpt retention {self.directory} {step}")
        return True

    def restore(self, target, step: int | None = None):
        """Restore `step` (default: latest) into `target`'s structure.

        Adapts to the checkpoint's save-time exclusion: fields missing
        on disk keep `target`'s values (so `--eval-only` works on a
        weights-only save without re-passing `--no-ckpt-full`)."""
        step = self.latest_step() if step is None else step
        if step is None:
            raise FileNotFoundError("no checkpoint to restore")
        return _read(os.path.join(self.directory, str(step)), target,
                     self._exclude)

    def wait_until_finished(self):
        pass

    def close(self):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
