"""Generate the reference's headline convergence diagnostic (q_k ratio table)
for MGMC vs SSOR on a 32x32 posterior, CPU float64."""
import sys
from pathlib import Path
sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
import jax
jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)
import numpy as np, jax.numpy as jnp
from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator, measurement_vector, observed_mean_and_variance, posterior_mean
from multigridmc_tpu.models.prior import shiftedlaplace_fd
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu.samplers.sor import SSORSampler

lattice = Lattice((32, 32))
prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(0.2))
rng = np.random.default_rng(0)
params = MeasurementParameters(
    measurement_locations=rng.uniform(0.1, 0.9, size=(8, 2)),
    mean=rng.normal(2.0, 1.0, size=8),
    variance=1e-6 * (1 + rng.uniform(size=8)),
    sample_location=np.array([0.5, 0.5]),
)
op = measured_operator(prior, params)
mu = posterior_mean(op, np.zeros(op.vshape), params.y())
f = jnp.asarray(np.asarray(op.apply(jnp.asarray(mu))))
w = measurement_vector(lattice, params.sample_location, 0.0)
wj = jnp.asarray(w)
mean_exact, var_exact = observed_mean_and_variance(op, np.zeros(op.vshape), params.y(), w)

nsteps, nrep = 12, 4000
for label, sampler in (
    ("multigridmc", MultigridMCSampler(op, nlevel=4, smoother="SOR", cycle=2)),
    ("ssor", SSORSampler(op, omega=1.0)),
):
    @jax.jit
    def run(key):
        x = jnp.zeros((nrep,) + op.vshape)
        def step(x, k):
            x = sampler.apply(jax.random.fold_in(key, k), f, x)
            return x, jnp.tensordot(x, wj, axes=2)
        _, zs = jax.lax.scan(step, x, jnp.arange(nsteps))
        return zs
    zs = np.asarray(run(jax.random.PRNGKey(1)))
    qm = np.abs(zs.mean(axis=1) - mean_exact)
    qv = np.abs((zs**2).mean(axis=1) - zs.mean(axis=1)**2 - var_exact)
    print(f"\n### {label}: |E[z_k] - E[z]| and ratio q_k/q_(k-1)  ({nrep} replica chains)")
    print(f"{'k':>3} {'q_mean':>12} {'ratio':>8} {'q_var':>12} {'ratio':>8}")
    for k in range(nsteps):
        rm = qm[k]/qm[k-1] if k else float('nan')
        rv = qv[k]/qv[k-1] if k else float('nan')
        print(f"{k+1:>3} {qm[k]:12.3e} {rm:8.3f} {qv[k]:12.3e} {rv:8.3f}")
