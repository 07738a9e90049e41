"""Multi-chip sharding tests on the virtual 8-device CPU mesh.

The reference is strictly single-core (SURVEY.md section 2.2); scaling over a
device mesh is a new first-class component of this build.  These tests verify
that lattice-sharded execution is *numerically identical* to single-device
execution: stencil apply, smoother sweeps, and the full MGMC step (same keys =>
same samples, up to reduction order)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import NamedSharding, PartitionSpec as P

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fd, shiftedlaplace_fem
from multigridmc_tpu.parallel.mesh import factor_devices, field_spec, lattice_mesh, shard_field
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu.smoothers import SSORSmoother
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner

pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 virtual devices"
)


def test_factor_devices():
    assert factor_devices(8, 2) == (4, 2)
    assert factor_devices(4, 2) == (2, 2)
    assert factor_devices(6, 2) == (3, 2)
    assert factor_devices(8, 3) == (2, 2, 2)


def make_posterior(nx=32):
    lattice = Lattice((nx, nx))
    prior = shiftedlaplace_fem(lattice, ConstantCorrelationLengthModel(0.3))
    rng = np.random.default_rng(7)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(size=(6, 2)),
        mean=rng.normal(size=6),
        variance=0.1 * (1 + rng.uniform(size=6)),
    )
    return measured_operator(prior, params)


def test_sharded_apply_matches_unsharded():
    op = make_posterior(32)
    mesh = lattice_mesh(2, n_devices=8)
    rng = np.random.default_rng(1)
    x = jnp.asarray(rng.normal(size=op.vshape))
    expected = op.apply(x)
    xs = shard_field(x, 2, mesh)
    out = jax.jit(op.apply)(xs)
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-13, atol=1e-14)


def test_sharded_smoother_matches_unsharded():
    op = make_posterior(32)
    mesh = lattice_mesh(2, n_devices=8)
    sm = SSORSmoother(op, omega=1.0)
    rng = np.random.default_rng(2)
    x = jnp.asarray(rng.normal(size=op.vshape))
    b = jnp.asarray(rng.normal(size=op.vshape))
    expected = sm.apply(b, x)
    out = jax.jit(sm.apply)(shard_field(b, 2, mesh), shard_field(x, 2, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-12, atol=1e-13)


def test_sharded_mgmc_step_matches_unsharded():
    """Same PRNG keys => bitwise-comparable samples under sharding."""
    op = make_posterior(32)
    mesh = lattice_mesh(2, n_devices=8)
    sampler = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=1)
    key = jax.random.PRNGKey(0)
    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.normal(size=op.vshape))
    x = jnp.zeros(op.vshape)
    expected = sampler.apply(key, f, x)
    spec = field_spec(2, mesh)

    @jax.jit
    def step(key, f, x):
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
        return sampler.apply(key, f, x)

    out = step(key, shard_field(f, 2, mesh), shard_field(x, 2, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-11, atol=1e-12)


def test_sharded_batched_chains():
    """Chains (dp) x lattice (spatial) composite sharding."""
    op = make_posterior(16)
    devices = np.asarray(jax.devices()[:8]).reshape(2, 2, 2)
    from jax.sharding import Mesh

    mesh = Mesh(devices, ("chains", "ly", "lx"))
    sampler = MultigridMCSampler(op, nlevel=2, smoother="SSOR", cycle=1)
    key = jax.random.PRNGKey(5)
    rng = np.random.default_rng(4)
    f = jnp.asarray(rng.normal(size=op.vshape))
    x = jnp.zeros((4,) + op.vshape)
    expected = sampler.apply(key, f, x)
    spec = P("chains", "ly", "lx")
    xs = jax.jit(lambda v: jax.lax.with_sharding_constraint(v, NamedSharding(mesh, spec)))(x)

    @jax.jit
    def step(key, f, x):
        x = jax.lax.with_sharding_constraint(x, NamedSharding(mesh, spec))
        return sampler.apply(key, f, x)

    out = step(key, f, xs)
    assert out.shape == x.shape
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-11, atol=1e-12)


def test_sharded_multigrid_solver():
    op = make_posterior(32)
    mesh = lattice_mesh(2, n_devices=8)
    pre = MultigridPreconditioner(op, nlevel=3, smoother="SSOR")
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=op.vshape))
    expected = pre.apply(b)
    out = jax.jit(pre.apply)(shard_field(b, 2, mesh))
    np.testing.assert_allclose(np.asarray(out), np.asarray(expected), rtol=1e-11, atol=1e-12)
