"""Process-level settings (tpudab.utils.runtime) and chip_smoke.py's refusal
to report anything without a GPU."""

import os
import shutil
import subprocess
import sys

import jax
import pytest

from tpudab.utils import runtime

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def restore_cache_dir():
    before = jax.config.jax_compilation_cache_dir
    yield
    jax.config.update("jax_compilation_cache_dir", before)


def test_compile_cache_follows_env_var(monkeypatch, restore_cache_dir):
    before = jax.config.jax_compilation_cache_dir
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
    assert runtime.enable_compile_cache() == "/elsewhere/cache"
    assert jax.config.jax_compilation_cache_dir == before   # left to JAX


def test_compile_cache_default_is_fixed_repo_dir(monkeypatch,
                                                 restore_cache_dir):
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    path = runtime.enable_compile_cache()
    assert path == os.path.join(_REPO, ".jax_cache")
    assert jax.config.jax_compilation_cache_dir == path
    assert runtime.enable_compile_cache() == path            # stable
    with open(os.path.join(_REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_platform_is_cpu_under_tests():
    assert runtime.platform() == "cpu"


def _run_smoke(cwd):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, "chip_smoke.py"], cwd=cwd,
                          env=env, capture_output=True, text=True,
                          timeout=300)


def test_chip_smoke_fails_without_gpu():
    r = _run_smoke(_REPO)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
    assert "not 'gpu'" in r.stdout + r.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    shutil.copy(os.path.join(_REPO, "chip_smoke.py"), tmp_path)
    r = _run_smoke(tmp_path)
    assert r.returncode != 0
    assert '"ok": true' not in r.stdout
