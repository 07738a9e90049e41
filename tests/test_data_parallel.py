"""Chains-data-parallel execution (parallel/data_parallel.py).

Two gates:

1. the DP sampler is a valid sampler: statistical mean/covariance gate
   (``test_sampler.hh:113-153``) across 8 shards with per-shard key streams;
2. per-shard streams are independent and the wrapper is deterministic.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fd
from multigridmc_tpu.parallel.data_parallel import DataParallelMGMCSampler, chains_mesh

from test_sampler import make_posterior_2d, mean_covariance_error, tier


def _posterior_f32(nx=24):
    lattice = Lattice((nx, nx))
    prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(0.3),
                              dtype=jnp.float32)
    rng = np.random.default_rng(5)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(4, 2)),
        mean=rng.normal(size=4),
        variance=0.5 + rng.uniform(size=4),  # O(1): f32 exactness comparison
    )
    return measured_operator(prior, params)


def test_dp_sampler_deterministic_and_independent():
    op = _posterior_f32()
    mesh = chains_mesh(8)
    dp = DataParallelMGMCSampler(op, nlevel=3, mesh=mesh,
                                 distill=True, cycle=2, smoother="SOR")
    assert dp.sampler.distilled is not None
    rng = np.random.default_rng(2)
    f = jnp.asarray(rng.normal(size=op.vshape), jnp.float32)
    x = jnp.zeros((16,) + op.vshape, jnp.float32)
    key = jax.random.PRNGKey(0)
    out = dp.apply(key, f, x)
    out2 = dp.apply(key, f, x)
    assert out.shape == x.shape
    assert bool(jnp.isfinite(out).all())
    assert bool((out == out2).all()), "DP step not deterministic"
    # chains on different shards see different noise (per-shard fold)
    blocks = np.asarray(out).reshape(8, 2, -1)
    for i in range(1, 8):
        assert np.max(np.abs(blocks[0] - blocks[i])) > 1e-3
    # wrong chain count is rejected
    with pytest.raises(ValueError):
        dp.apply(key, f, jnp.zeros((9,) + op.vshape, jnp.float32))


def test_dp_sampler_statistical_gate():
    """The DP sampler passes the reference mean/covariance oracle: 8 shards x
    chains with per-shard independent streams and the distilled subtree
    active per shard."""
    op = make_posterior_2d(8)
    mesh = chains_mesh(8)
    dp = DataParallelMGMCSampler(
        op, nlevel=3, mesh=mesh, distill=True,
        smoother="SSOR", cycle=2,
    )
    nchains, nsteps, tol = tier(1024, 400, 4e-3)
    em, ec = mean_covariance_error(op, dp, nchains=nchains, nwarmup=20,
                                   nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)
