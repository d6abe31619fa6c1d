"""Where the program runs: the one module that decides the platform.

* ``on_gpu()`` — whether JAX's default backend is a GPU: the one backend
  check in the program.
* ``kernel_interpret(interpret)`` — how a Pallas kernel runs. On the GPU it
  is compiled for the card; the Pallas interpreter runs it only when the
  caller passes ``interpret=True`` (the CPU tests do). Any other backend
  is an error, never a silent interpreter run.
* ``pick_platform(force_cpu, x64)`` — the experiment drivers' start-up:
  ``--cpu`` runs on the CPU in f64 (the reference's numeric regime);
  otherwise a GPU must be present, or the driver exits naming ``--cpu``.
* ``enable_compile_cache()`` — the persistent compile cache. Where
  ``JAX_COMPILATION_CACHE_DIR`` is set JAX reads it itself and nothing is
  set here; otherwise the cache is ``<checkout>/.jax_cache``.
* ``gpu_name_and_power_limit()`` — the card's name and power limit as
  ``nvidia-smi`` reports them, read in a child process that never imports
  JAX (so it takes no share of the card's memory).
"""

from __future__ import annotations

import os
import subprocess

__all__ = ["on_gpu", "kernel_interpret", "pick_platform", "enable_compile_cache",
           "gpu_name_and_power_limit", "CHECKOUT"]

CHECKOUT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def on_gpu() -> bool:
    """True when JAX's default backend is a GPU."""
    import jax

    return jax.default_backend() == "gpu"


def kernel_interpret(interpret: bool = False) -> bool:
    """The ``interpret=`` value to hand a Pallas kernel: ``True`` only when
    the caller asked for the interpreter, ``False`` on the GPU, and an
    error on any other backend."""
    import jax

    if interpret:
        return True
    if not on_gpu():
        backend = jax.default_backend()
        raise RuntimeError(
            f"the Pallas kernels compile for the GPU, and this process runs "
            f"on {backend!r}. Pass interpret=True to run them in the Pallas "
            "interpreter, or use the XLA path (fused=False).")
    return False


def enable_compile_cache() -> str:
    """Turn on JAX's persistent compile cache and return its directory."""
    import jax

    env = os.environ.get("JAX_COMPILATION_CACHE_DIR")
    if env:
        return env
    path = os.path.join(CHECKOUT, ".jax_cache")
    jax.config.update("jax_compilation_cache_dir", path)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0)
    return path


def pick_platform(force_cpu: bool = False, x64: bool = False):
    """Experiment start-up. ``force_cpu`` (``--cpu``): the local CPU in f64,
    the reference's numeric regime. Otherwise the GPU, in f32 unless
    ``x64`` (``--f64``: native f64 on the card). Without a GPU the driver
    exits with an error that names ``--cpu``; it never falls back."""
    import jax

    enable_compile_cache()
    if force_cpu:
        jax.config.update("jax_platforms", "cpu")
        jax.config.update("jax_enable_x64", True)
        return
    try:
        gpu = on_gpu()
    except RuntimeError as err:  # no backend at all came up
        raise SystemExit(f"no GPU found ({err}); pass --cpu to run on the "
                         "CPU") from None
    if not gpu:
        raise SystemExit(f"no GPU found (JAX backend "
                         f"{jax.default_backend()!r}); pass --cpu to run on "
                         "the CPU")
    if x64:
        jax.config.update("jax_enable_x64", True)
    else:
        # the GPU path runs f32: the f64-to-f32 truncation of the numpy
        # problem data is intended, not a bug — silence the per-array warning
        import warnings

        warnings.filterwarnings(
            "ignore", message=".*requested dtype float64.*", category=UserWarning
        )


def gpu_name_and_power_limit() -> str:
    """``name, power.limit`` of every card, one line each, from nvidia-smi
    (the empty string where there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True).stdout
    except (OSError, subprocess.SubprocessError):
        return ""
    return out.strip()
