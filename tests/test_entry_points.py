"""Entry points that need a GPU refuse to run without one, and the one
compile-cache rule every entry point shares."""

import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from qpsk_tpu.utils import compile_cache

ROOT = Path(__file__).resolve().parents[1]


@pytest.mark.parametrize("env", [None, "/somewhere/else/cache"])
def test_compile_cache_dir(monkeypatch, env):
    """JAX_COMPILATION_CACHE_DIR wins when set; otherwise the cache is the
    fixed <checkout>/.jax_cache, which git ignores."""
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
        assert compile_cache.cache_dir() == str(ROOT / ".jax_cache")
        assert ".jax_cache/" in (ROOT / ".gitignore").read_text().split()
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
        assert compile_cache.cache_dir() == env


def _run(args, cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


@pytest.mark.parametrize("script", ["chip_smoke.py", "bench.py"])
def test_gpu_entry_points_fail_on_cpu(script):
    """On the CPU both exit non-zero and print no result."""
    r = _run([str(ROOT / script)], ROOT)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout and r.stdout.strip() == ""
    assert "no GPU" in r.stderr


def test_chip_smoke_alone_fails(tmp_path):
    """In a directory holding chip_smoke.py and nothing else of the repo
    it exits non-zero and prints no result."""
    shutil.copy(ROOT / "chip_smoke.py", tmp_path)
    r = _run(["chip_smoke.py"], tmp_path)
    assert r.returncode != 0 and '"ok": true' not in r.stdout
