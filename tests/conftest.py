"""Test configuration: CPU backend with 8 virtual devices and float64.

Tests run on a virtual 8-device CPU mesh (multi-device sharding on real cards is
checked by ``chip_smoke.py --four``) and in float64 so
the deterministic oracles (smoother fixed points at 1e-12, solver tolerances at
1e-13, cf. SURVEY.md section 4) are meaningful.  Must run before jax backends
initialise; the platform is forced through jax.config as well as the
environment."""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in flags:
    os.environ["XLA_FLAGS"] = (
        flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
