"""Typed run configuration + dataclass-driven CLI flags.

Reference counterpart: the argparse option system of
rebcabin/cartpoleplusplus — each module contributes `add_opts(parser)` and
the opts object threads through constructors (SURVEY.md §1 L4, §5 config
row).

Redesign: configuration is a tree of frozen dataclasses (physics/env
params in physics/params.py, agent configs in agents/*.py, run settings
here). `add_dataclass_args` auto-generates argparse flags from dataclass
fields — the composition the reference did by hand — and `from_args`
rebuilds the dataclass, so every flag stays in one place and is hashable
for jit static arguments.
"""

from __future__ import annotations

import argparse
import dataclasses
import typing
from typing import get_origin


def _field_types(cls) -> dict:
    """Resolved (non-string) annotation per field. With `from __future__
    import annotations` in config modules, `field.type` is a string;
    get_type_hints resolves it so bool/tuple/nested-dataclass dispatch
    below actually fires."""
    try:
        return typing.get_type_hints(cls)
    except Exception:
        return {f.name: f.type for f in dataclasses.fields(cls)}


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Top-level settings for a training run (train.py CLI)."""

    agent: str = "ddpg"              # ddpg | dqn | naf | lrpg | random
    # "" (agent defaults = the QUALITY recipes), "fast", or "pixels":
    # lift unset run/agent fields to a tuned recipe (train.py
    # _PRESETS; explicitly-typed flags always win). fast = the
    # throughput cadences with an end-of-budget canary; pixels = the
    # pixel-learning recipe (grayscale uint8 frames, frame-diff).
    preset: str = ""
    num_envs: int = 4096
    obs_mode: str = "pose_stack"     # pose_stack | state | pixels
    # Pixel-obs rendering knobs (obs_mode=pixels; env/pixels.py):
    render_size: int = 48            # square frame edge (pixels)
    render_grayscale: bool = False   # 1 channel per camera instead of 3
    render_dtype: str = "float32"    # ray-cast compute dtype (bfloat16 = 2x)
    render_obs_uint8: bool = False   # quantize pixel obs to uint8 (4x HBM)
    # stack [latest frame, consecutive-frame diffs] instead of R raw
    # frames (same shape; explicit motion signal — RenderConfig.frame_diff)
    render_frame_diff: bool = False
    # diff-plane contrast gain (RenderConfig.frame_diff_gain; 4-8 keeps
    # the small inter-repeat amplitudes above the uint8 rounding floor)
    render_frame_diff_gain: float = 1.0
    total_env_steps: int = 100_000   # per-env steps to train for
    seed: int = 0
    log_interval: int = 10           # train_steps between metric prints
    # Train steps per jitted dispatch (agents.make_train_scan). >1 scans
    # K train steps inside ONE jit call, amortizing the per-dispatch
    # enqueue constant (same math bitwise — tests/test_agents.py). Saves
    # and metric prints then land on dispatch boundaries; keep 1 when an
    # exact per-step checkpoint cadence matters.
    steps_per_dispatch: int = 1
    ckpt_dir: str = ""               # empty = no checkpointing
    ckpt_interval: int = 100         # train_steps between saves
    ckpt_full: bool = True           # False = weights-only (exclude replay)
    event_log: str = ""              # empty = no event log
    event_log_envs: int = 0          # log only the first k envs (0 = all)
    use_mesh: bool = True            # shard envs over all local devices
    learner: str = "spmd"            # spmd (partitioner) | shardmap (explicit)
    eval_only: bool = False          # restore from ckpt_dir, evaluate, exit
    final_eval: bool = False         # greedy-policy eval line after training
    eval_steps: int = 400            # env-steps per eval run
    eval_render: str = ""            # with --eval-only: dump frames of env 0 here
    profile_dir: str = ""            # empty = no profiler trace
    # Collapse-detection canary: at `canary_env_steps` per-env
    # steps, run a deterministic eval; if mean episode length <
    # `canary_min_eval`, RESTART training from a re-seeded init (seed +
    # 1000 per attempt, up to `canary_max_restarts`). Motivation: the
    # high-throughput cadences sit near a mediocre attractor that
    # catches ~1 in 4 seeds (every static knob that rescued one seed
    # sank another); an eval + random restart is the robust fix. 0 = off.
    canary_env_steps: int = 0
    canary_min_eval: float = 100.0
    canary_max_restarts: int = 2


def _flag(name: str) -> str:
    return "--" + name.replace("_", "-")


def add_dataclass_args(parser: argparse.ArgumentParser, cls,
                       prefix: str = "") -> None:
    """One argparse flag per field. bools become --x/--no-x pairs; tuples
    take space-separated values. Nested dataclasses get a dotted prefix."""
    types = _field_types(cls)
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        ftype = types.get(f.name, f.type)
        default = (f.default if f.default is not dataclasses.MISSING
                   else f.default_factory())
        if dataclasses.is_dataclass(ftype):
            add_dataclass_args(parser, ftype, prefix=name + ".")
        elif ftype is bool:
            parser.add_argument(_flag(name), dest=name,
                                action=argparse.BooleanOptionalAction,
                                default=default)
        elif ftype is tuple or get_origin(ftype) is tuple:
            elem = type(default[0]) if default else int
            parser.add_argument(_flag(name), dest=name, nargs="*",
                                type=elem, default=default)
        else:
            typ = ftype if callable(ftype) and not isinstance(ftype, str) \
                else str
            parser.add_argument(_flag(name), dest=name, type=typ,
                                default=default)


def explicit_dests(parser: argparse.ArgumentParser, argv) -> set:
    """Dest names of the flags actually present on the command line.

    Re-parses `argv` with every default suppressed, so the resulting
    namespace contains ONLY user-provided flags — the reliable way to
    distinguish "--x <default value>" from an omitted flag (train.py uses
    this to merge env presets without clobbering explicit overrides).
    Mutates `parser`'s defaults; pass a throwaway parser.
    """
    for a in parser._actions:
        if a.dest != "help":
            a.default = argparse.SUPPRESS
    return set(vars(parser.parse_args(argv)))


def from_args(cls, args: argparse.Namespace, prefix: str = ""):
    """Rebuild a dataclass instance from parsed args (tuples re-tupled)."""
    types = _field_types(cls)
    kw = {}
    for f in dataclasses.fields(cls):
        name = prefix + f.name
        if dataclasses.is_dataclass(types.get(f.name, f.type)):
            kw[f.name] = from_args(types[f.name], args, prefix=name + ".")
        else:
            v = getattr(args, name)
            kw[f.name] = tuple(v) if isinstance(v, list) else v
    return cls(**kw)
