"""Runtime helpers: accelerator decision, compile-cache placement, float64
policy and PRNG key selection."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import pytest

from multigridmc_tpu.utils import runtime
from multigridmc_tpu.utils.runtime import sampling_key

REPO = Path(__file__).resolve().parents[1]


class FakeDevice:
    def __init__(self, platform):
        self.platform = platform


def fake_devices(monkeypatch, platform, count):
    monkeypatch.setattr(runtime.jax, "devices",
                        lambda *a, **k: [FakeDevice(platform)] * count)


def test_sampling_key_default_cpu_is_threefry():
    k = sampling_key(7)
    assert "threefry" in str(jax.random.key_impl(k))


def test_sampling_key_explicit_rbg():
    k = sampling_key(7, impl="rbg")
    assert "rbg" in str(jax.random.key_impl(k))
    # rbg keys drive the full sampling API (fold_in/split/normal)
    xi = jax.random.normal(jax.random.fold_in(k, 3), (64,))
    assert bool(jnp.isfinite(xi).all())


def test_sampling_key_auto_rbg_on_accelerator(monkeypatch):
    fake_devices(monkeypatch, "gpu", 1)
    monkeypatch.delenv("MGMC_PRNG_IMPL", raising=False)
    k = sampling_key(7)
    monkeypatch.undo()
    assert "rbg" in str(jax.random.key_impl(k))


@pytest.mark.parametrize("platform,count,accelerator", [
    ("cpu", 1, False),
    ("cpu", 8, False),
    ("gpu", 1, True),
    ("gpu", 4, True),  # a sampler on the default device of a multi-GPU host
])
def test_accelerator_decision(monkeypatch, platform, count, accelerator):
    fake_devices(monkeypatch, platform, count)
    assert runtime.on_accelerator() is accelerator


def test_accelerator_decision_does_not_default_to_cpu(monkeypatch):
    """A backend that fails to initialise is an error, not a CPU run."""
    def broken(*a, **k):
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.setattr(runtime.jax, "devices", broken)
    with pytest.raises(RuntimeError, match="cuda"):
        runtime.on_accelerator()


@pytest.mark.parametrize("platform,x64", [("cpu", True), ("gpu", False)])
def test_configure_runtime_float64_policy(monkeypatch, platform, x64):
    monkeypatch.delenv("MGMC_X64", raising=False)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    fake_devices(monkeypatch, platform, 1)
    old_dir = jax.config.jax_compilation_cache_dir
    try:
        runtime.configure_runtime()
        assert jax.config.jax_enable_x64 is x64
    finally:
        jax.config.update("jax_enable_x64", True)
        jax.config.update("jax_compilation_cache_dir", old_dir)


def test_default_cache_dir_is_in_the_checkout():
    assert runtime.DEFAULT_CACHE_DIR == REPO / ".jax_cache"


def _run(code, cwd, env):
    env = dict(env, PYTHONPATH=str(REPO), JAX_PLATFORMS="cpu")
    return subprocess.run([sys.executable, "-c", code], cwd=str(cwd), env=env,
                          capture_output=True, text=True, timeout=120)


def test_cache_dir_default_from_another_directory(tmp_path):
    """Without JAX_COMPILATION_CACHE_DIR the cache goes to <checkout>/.jax_cache,
    whatever the working directory."""
    env = {k: v for k, v in os.environ.items() if k != "JAX_COMPILATION_CACHE_DIR"}
    r = _run("import jax; from multigridmc_tpu.utils.runtime import configure_runtime; "
             "configure_runtime(); print(jax.config.jax_compilation_cache_dir)",
             tmp_path, env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(REPO / ".jax_cache")


def test_cache_dir_from_environment_receives_the_cache(tmp_path):
    """With JAX_COMPILATION_CACHE_DIR set the program sets no directory of its
    own, and compiled programs land in the named directory."""
    cache = tmp_path / "cache"
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(cache))
    code = (
        "import jax, jax.numpy as jnp\n"
        "from multigridmc_tpu.utils.runtime import configure_runtime\n"
        "configure_runtime()\n"
        "jax.config.update('jax_persistent_cache_min_compile_time_secs', 0)\n"
        "jax.config.update('jax_persistent_cache_min_entry_size_bytes', 0)\n"
        "print(jax.config.jax_compilation_cache_dir)\n"
        "jax.block_until_ready(jax.jit(lambda x: jnp.sin(x) * 3)(jnp.ones(8)))\n"
    )
    r = _run(code, tmp_path, env)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip().splitlines()[-1] == str(cache)
    assert cache.is_dir() and any(cache.iterdir())
