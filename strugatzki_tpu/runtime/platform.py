"""JAX platform/runtime configuration.

Called once on first import of any compute module:

* ``STRUGATZKI_PLATFORM`` (``cpu`` or ``gpu``) overrides the JAX platform
  via ``jax.config`` — the escape hatch for running a GPU host's CLI on
  the CPU (``JAX_PLATFORMS`` does the same when set before JAX starts).
* A persistent compilation cache, so CLI invocations and benchmark runs
  reuse compiled programs.  Where ``JAX_COMPILATION_CACHE_DIR`` is set,
  JAX reads it itself and nothing here overrides it; otherwise the cache
  lives at the fixed :data:`REPO_CACHE_DIR` (``<repo>/.jax_cache``,
  git-ignored), so the program writes nothing outside its checkout.
"""

from __future__ import annotations

import os

_configured = False

#: Compile-cache directory used when ``JAX_COMPILATION_CACHE_DIR`` is unset.
REPO_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))), ".jax_cache")


def compile_cache_dir() -> str:
    """The directory the persistent compile cache uses in this process."""
    return os.environ.get("JAX_COMPILATION_CACHE_DIR") or REPO_CACHE_DIR


def configure() -> None:
    global _configured
    if _configured:
        return
    _configured = True

    import jax

    plat = os.environ.get("STRUGATZKI_PLATFORM")
    if plat:
        try:
            jax.config.update("jax_platforms", plat)
        except Exception as e:
            # never silently lose the documented escape hatch — a backend
            # initialized before this import cannot be switched anymore
            import warnings
            warnings.warn(f"STRUGATZKI_PLATFORM={plat!r} could not be "
                          f"applied ({e!r}); the already-initialized JAX "
                          f"backend stays active", RuntimeWarning)

    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", REPO_CACHE_DIR)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def require_gpu():
    """JAX's devices, which must be GPUs; raise :class:`SystemExit` (non-zero)
    otherwise.  Measurement entry points call this: a number taken on the
    CPU backend is not a device number, so there is no fallback."""
    import jax

    devs = jax.devices()
    if devs[0].platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is {devs[0].platform} "
                         f"({devs[0].device_kind})")
    return devs


def card_line() -> str:
    """``nvidia-smi --query-gpu=name,power.limit`` output (one line per
    card, joined by ``"; "``), read by a child process that does not
    import JAX."""
    import subprocess

    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=30)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    cards = [line.strip() for line in r.stdout.splitlines() if line.strip()]
    return "; ".join(cards) or f"nvidia-smi failed: {r.stderr.strip()}"
