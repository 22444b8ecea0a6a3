"""Runtime configuration: where the persistent compile cache goes."""

import os
import subprocess
import sys

import jax
import pytest

from strugatzki_tpu.runtime import platform as P

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("env", [None, "/elsewhere/jax-cache"])
def test_configure_places_compile_cache(monkeypatch, env):
    """With ``JAX_COMPILATION_CACHE_DIR`` set, configure() leaves JAX's own
    reading of it alone; unset, the cache goes to ``<repo>/.jax_cache``."""
    calls = {}
    monkeypatch.setattr(P, "_configured", False)
    monkeypatch.setattr(jax.config, "update",
                        lambda k, v: calls.__setitem__(k, v))
    monkeypatch.delenv("STRUGATZKI_PLATFORM", raising=False)
    if env is None:
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    else:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", env)
    P.configure()
    if env is None:
        assert calls["jax_compilation_cache_dir"] == P.REPO_CACHE_DIR
        assert P.compile_cache_dir() == os.path.join(REPO, ".jax_cache")
    else:
        assert "jax_compilation_cache_dir" not in calls
        assert P.compile_cache_dir() == env


def test_repo_cache_is_gitignored():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_cache_written_only_where_the_variable_says(tmp_path):
    """A fresh process with the variable set writes its compiled program
    there, and nothing under its HOME."""
    cache, home = tmp_path / "cache", tmp_path / "home"
    home.mkdir()
    code = (
        "import jax, jax.numpy as jnp\n"
        "from strugatzki_tpu.runtime.platform import configure\n"
        "configure()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', -1)\n"
        "jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(7)).block_until_ready()\n")
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache),
               HOME=str(home), JAX_PLATFORMS="cpu",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    r = subprocess.run([sys.executable, "-c", code], env=env, cwd=tmp_path,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert any(cache.iterdir())
    assert not any(home.rglob("*"))


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit) as e:
        P.require_gpu()
    assert "no GPU" in str(e.value.code)


def test_card_line_without_nvidia_smi(monkeypatch):
    monkeypatch.setenv("PATH", "")
    assert "nvidia-smi" in P.card_line()
