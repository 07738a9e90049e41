"""Runtime setup for drivers and benchmarks: compile cache, precision, PRNG.

The reference computes everything in float64 on CPU.  On a GPU, float32 is the
fast path, so drivers default to float64 only when JAX runs on the CPU (the
bitwise-comparable parity surface).  The platform itself is JAX's own choice
(``JAX_PLATFORMS``).  Environment:

* ``JAX_COMPILATION_CACHE_DIR`` - where JAX keeps its persistent compile
  cache; when unset, :func:`configure_runtime` puts it in ``.jax_cache`` at the
  root of the checkout;
* ``MGMC_X64=0|1``                - disable/enable float64 (default: enabled on
  the CPU, disabled on an accelerator);
* ``MGMC_PRNG_IMPL=auto|rbg|threefry2x32`` - PRNG key implementation for the
  sampling drivers/bench (default auto: ``rbg`` on an accelerator,
  ``threefry2x32`` on the CPU).
"""

from __future__ import annotations

import os
from pathlib import Path

import jax

#: compile cache used when ``JAX_COMPILATION_CACHE_DIR`` is unset: a fixed
#: path inside the checkout (the path is part of the cache key)
DEFAULT_CACHE_DIR = Path(__file__).resolve().parents[2] / ".jax_cache"


def on_accelerator() -> bool:
    """Whether JAX's default device is an accelerator.  Samplers build their
    arrays and programs for that device unless a caller places them on a mesh,
    so this, not the number of devices, decides the single-device engine
    choices (distilled subtree, band doubling).  Raises if no backend
    initialises."""
    return jax.devices()[0].platform != "cpu"


def configure_runtime(default_x64: bool = True) -> None:
    """Persistent compile cache and float64 policy for drivers and benchmarks."""
    if not os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        jax.config.update("jax_compilation_cache_dir", str(DEFAULT_CACHE_DIR))
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 5.0)
    x64_env = os.environ.get("MGMC_X64")
    if x64_env is not None:
        jax.config.update("jax_enable_x64", x64_env not in ("0", "false", ""))
    else:
        jax.config.update("jax_enable_x64",
                          default_x64 and not on_accelerator())


def sampling_key(seed: int, impl: str | None = None) -> jax.Array:
    """Typed PRNG key for the sampling drivers / bench.

    ``impl=None`` reads ``MGMC_PRNG_IMPL`` (default ``auto``): on an
    accelerator the ``rbg`` implementation uses XLA's RngBitGenerator, with the
    same sampling distribution as threefry (its speed on the GPU against
    threefry is not measured yet); on the CPU ``threefry2x32`` keeps runs
    bitwise reproducible against the float64 parity surface.
    """
    impl = impl or os.environ.get("MGMC_PRNG_IMPL", "auto")
    if impl == "auto":
        impl = "rbg" if on_accelerator() else "threefry2x32"
    return jax.random.key(seed, impl=impl)
