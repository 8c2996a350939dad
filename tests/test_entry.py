"""Entry-point plumbing: compile-cache placement and chip_smoke.py's
refusal to run without a GPU."""

import os
import shutil
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_SHOW_CACHE_DIR = (
    "import jax; from cartpoleplusplus_tpu.train import enable_compile_cache;"
    "enable_compile_cache(); print(jax.config.jax_compilation_cache_dir)")


def _run(args, env_update, cwd=ROOT, drop=()):
    env = {k: v for k, v in os.environ.items() if k not in drop}
    env.update({"JAX_PLATFORMS": "cpu", **env_update})
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_cache_dir_from_environment(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set, the cache is where it says:
    the helper sets no directory of its own."""
    p = _run(["-c", _SHOW_CACHE_DIR],
             {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")})
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == str(tmp_path / "cc")


def test_cache_dir_default_in_checkout():
    """Unset, the cache goes to <checkout>/.jax_cache, a fixed path."""
    p = _run(["-c", _SHOW_CACHE_DIR], {},
             drop=("JAX_COMPILATION_CACHE_DIR",))
    assert p.returncode == 0, p.stderr
    assert p.stdout.strip().splitlines()[-1] == os.path.join(ROOT,
                                                             ".jax_cache")


def test_chip_smoke_refuses_cpu():
    p = _run([os.path.join(ROOT, "chip_smoke.py")], {})
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "needs a GPU" in p.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """Copied away from the repo it has nothing to drive: it stops at the
    missing package, before it looks for a device — non-zero exit, no ok
    line."""
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    p = _run([str(tmp_path / "chip_smoke.py")], {}, cwd=tmp_path,
             drop=("PYTHONPATH",))
    assert p.returncode != 0
    assert '"ok": true' not in p.stdout
    assert "checkout of the repo" in p.stderr
    assert "needs a GPU" not in p.stderr
