"""End-to-end posterior sampling example.

Build a Matern-like GMRF prior on a 2d lattice, condition it on point
measurements, and estimate the posterior mean/variance field with batched MGMC
chains - the library-API version of the ``drivers.mgmc`` experiment.

Run: ``python examples/posterior_sampling.py`` (CPU ok; uses the GPU if present).
"""

import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import numpy as np
import jax
import jax.numpy as jnp

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import (
    MeasurementParameters,
    measured_operator,
    posterior_mean,
)
from multigridmc_tpu.models.prior import shiftedlaplace_fd
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu.utils.vtk import VTKWriter


def main():
    # 1. prior: shifted-Laplace GMRF with correlation length 0.2 on a 64x64 lattice
    lattice = Lattice((64, 64))
    prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(Lambda=0.2))

    # 2. posterior: condition on 6 noisy point observations
    rng = np.random.default_rng(42)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.15, 0.85, size=(6, 2)),
        mean=rng.normal(1.0, 0.5, size=6),
        variance=np.full(6, 1e-4),
    )
    op = measured_operator(prior, params)

    # 3. MGMC sampler: 4-level W-cycle, forward/backward SOR Gibbs smoothing
    sampler = MultigridMCSampler(op, nlevel=4, smoother="SOR", cycle=2)

    # recommended float32 protocol: sample the zero-mean posterior fluctuation
    # e ~ N(0, Q^-1) on device and add the exact mean computed on the host
    mu = posterior_mean(op, np.zeros(op.vshape), params.y())

    nchains, nwarmup, nsteps = 64, 30, 200
    f = jnp.zeros(op.vshape, dtype=op.coeffs.dtype)
    x = jnp.zeros((nchains,) + op.vshape, dtype=op.coeffs.dtype)
    key = jax.random.PRNGKey(0)

    @jax.jit
    def run(x, key):
        def warm(k, x):
            return sampler.apply(jax.random.fold_in(key, k), f, x)

        x = jax.lax.fori_loop(0, nwarmup, warm, x)

        def step(carry, k):
            x, s1, s2 = carry
            x = sampler.apply(jax.random.fold_in(key, nwarmup + k), f, x)
            return (x, s1 + x.sum(0), s2 + (x * x).sum(0)), 0.0

        (x, s1, s2), _ = jax.lax.scan(
            step, (x, jnp.zeros(op.vshape), jnp.zeros(op.vshape)), jnp.arange(nsteps)
        )
        return s1 / (nchains * nsteps), s2 / (nchains * nsteps)

    e_mean, e_sq = run(x, key)
    mean_field = mu + np.asarray(e_mean)
    var_field = np.asarray(e_sq) - np.asarray(e_mean) ** 2
    print(f"{nchains * nsteps} samples on {jax.default_backend()}")
    print(f"posterior mean range: [{mean_field.min():.3f}, {mean_field.max():.3f}]")
    print(f"posterior sd at measurements ~ {np.sqrt(var_field).min():.4f} (pinned)")
    print(f"posterior sd far field       ~ {np.sqrt(var_field).max():.4f}")

    writer = VTKWriter("posterior_example.vtk", lattice)
    writer.add_state(mean_field, "mean")
    writer.add_state(var_field, "variance")
    writer.write()
    print("wrote posterior_example.vtk")


if __name__ == "__main__":
    main()
