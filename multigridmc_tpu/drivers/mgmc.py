"""MGMC sampling experiment driver.

Counterpart of ``src/driver_mgmc.cc``: reads a config file, builds the
posterior operator, runs the configured samplers (Cholesky / SSOR / MGMC), and
reports per-sample timings, observed mean/variance vs the exact posterior
(``measure_sampling_time``, ``driver_mgmc.cc:40-107``), warmup convergence tables
(``measure_convergence``, ``driver_mgmc.cc:188-314``), and the posterior
mean/variance field as VTK (``posterior_statistics``, ``driver_mgmc.cc:118-171``).

Usage: ``python -m multigridmc_tpu.drivers.mgmc CONFIGFILE``
"""

from __future__ import annotations

import sys
import time

import jax
import jax.numpy as jnp
import numpy as np

from ..models.posterior import (
    measurement_vector,
    observed_mean_and_variance,
    posterior_mean,
)
from ..samplers.base import MeanShiftedSampler
from ..samplers.cholesky import BandCholeskySampler, DenseCholeskySampler
from ..samplers.mgmc import MultigridMCSampler
from ..samplers.sor import SSORSampler
from ..utils.config import echo_config, load_config
from ..utils.vtk import VTKWriter, write_vtk_circle
from ..utils.runtime import configure_runtime, sampling_key
from .common import build_operators


def make_samplers(config, op):
    samplers = {}
    if config.general.do_cholesky:
        t0 = time.perf_counter()
        factorisation = config.cholesky.factorisation
        if factorisation == "dense":
            samplers["cholesky"] = DenseCholeskySampler(op)
        elif factorisation in ("sparse", "band"):
            samplers["cholesky"] = BandCholeskySampler(op)
        else:
            raise ValueError(f"invalid Cholesky factorisation '{factorisation}'")
        t1 = time.perf_counter()
        print(f"time for Cholesky factorisation = {t1 - t0:.4f} s")
    if config.general.do_ssor:
        samplers["ssor"] = SSORSampler(op, config.smoother.omega, config.smoother.nsmooth)
    if config.general.do_multigridmc:
        mg = config.multigrid
        samplers["multigridmc"] = MultigridMCSampler(
            op,
            nlevel=mg.nlevel,
            smoother=mg.smoother,
            coarse_solver=mg.coarse_solver,
            npresmooth=mg.npresmooth,
            npostsmooth=mg.npostsmooth,
            ncoarsesmooth=mg.ncoarsesmooth,
            omega=mg.omega,
            cycle=mg.cycle,
            coarse_scaling=mg.coarse_scaling,
            cholesky_factorisation=config.cholesky.factorisation,
            verbose=mg.verbose,
            sweep_schedule=mg.sweep_schedule,
            distill_precision=mg.distill_precision,
        )
    return samplers


def exact_setup(prior, op, mparams):
    """Exact posterior mean and rhs f = Q_post mean (driver_mgmc.cc:51-64)."""
    xbar = np.zeros(op.lattice.vshape)
    y = mparams.y()
    mean_x_exact = posterior_mean(op, xbar, y) if op.lowrank is not None else xbar
    f = np.asarray(op.apply(jnp.asarray(mean_x_exact)))
    sample_vec = measurement_vector(
        op.lattice, mparams.sample_location, mparams.radius
    )
    return xbar, y, mean_x_exact, f, sample_vec


def measure_sampling_time(label, sampler, op, config, f, sample_vec, xbar, y, filename):
    """cf. ``measure_sampling_time`` (``driver_mgmc.cc:40-107``)."""
    sp = config.sampling
    fj = jnp.asarray(f)
    svec = jnp.asarray(sample_vec)
    key = sampling_key(5418513)
    x = jnp.zeros(op.lattice.vshape)

    # The chain is sequential (reference semantics, driver_mgmc.cc:72-78) but
    # the per-step host round trip is not: run the chain in device-side scan
    # chunks that emit the observable z_k = <w, x_k> per step - one dispatch
    # per chunk instead of per sample.
    def chain(x, k0, n):
        def step(x, k):
            x = sampler.apply_indexed(jax.random.fold_in(key, k), fj, x, k)
            return x, jnp.tensordot(x, svec, axes=op.lattice.dim,
                                    precision=jax.lax.Precision.HIGHEST)

        return jax.lax.scan(step, x, k0 + jnp.arange(n))

    chain_j = jax.jit(chain, static_argnums=2)

    sampler.fix_rhs(fj)
    done = 0
    while done < sp.nwarmup:
        n = min(512, sp.nwarmup - done)
        x, _ = chain_j(x, jnp.int32(done), n)
        done += n
    # pre-compile every chunk length the timed loop will use (each distinct
    # static n is a separate XLA program; compiling inside the timed region
    # would pollute the per-sample figure) - run them on a throwaway state
    # with far-offset keys so the real chain stream is untouched
    for n in {min(512, sp.nsamples), sp.nsamples % 512 or 512}:
        jax.block_until_ready(
            chain_j(x, jnp.int32(sp.nwarmup + sp.nsamples + 10_000), n))
    jax.block_until_ready(x)

    data = np.empty(sp.nsamples)
    t0 = time.perf_counter()
    done = 0
    while done < sp.nsamples:
        n = min(512, sp.nsamples - done)
        x, z = chain_j(x, jnp.int32(sp.nwarmup + done), n)
        data[done:done + n] = np.asarray(z)
        done += n
    jax.block_until_ready(x)
    t_elapsed = (time.perf_counter() - t0) * 1e3 / sp.nsamples
    print(f"  {label:>12s} time per sample = {t_elapsed:12.4f} ms")
    np.savetxt(filename, data)

    x_avg = float(np.mean(data))
    variance = float(np.mean(data**2) - x_avg**2)
    x_error = np.sqrt(variance / sp.nsamples)
    mean_exact, variance_exact = observed_mean_and_variance(op, xbar, y, sample_vec)
    print(f"  {label:>12s} mean     = {x_avg:12.4e} +/- {x_error:12.4e} [ignoring IACT]")
    print(f"  {'exact':>12s} mean     = {mean_exact:12.4e}")
    print(f"  {label:>12s} variance = {variance:12.4e}")
    print(f"  {'exact':>12s} variance = {variance_exact:12.4e}\n")
    sampler.unfix_rhs()
    return t_elapsed


def measure_convergence(label, sampler, op, config, f, sample_vec, xbar, y, filename):
    """cf. ``measure_convergence`` (``driver_mgmc.cc:188-314``): decay of
    |E[z^k] - E[z]| and |Var[z^k] - Var[z]| over the first chain steps, batched
    over independent replica chains on device."""
    sp = config.sampling
    nsteps = sp.nstepsconvergence
    nsamples = sp.nsamplesconvergence
    fj = jnp.asarray(f)
    svec = jnp.asarray(sample_vec)
    key = sampling_key(2813741)

    @jax.jit
    def run_chains(key):
        x = jnp.zeros((nsamples,) + op.lattice.vshape)

        def step(x, k):
            x = sampler.apply_indexed(jax.random.fold_in(key, k), fj, x, k)
            z = jnp.tensordot(x, svec, axes=op.lattice.dim,
                              precision=jax.lax.Precision.HIGHEST)
            return x, z

        _, zs = jax.lax.scan(step, x, jnp.arange(nsteps))
        return zs  # (nsteps, nsamples)

    zs = np.asarray(run_chains(key))
    zs = np.concatenate([np.zeros((1, nsamples)), zs])  # j=0 row (x=0)
    x_avg = zs.mean(axis=1)
    x2_avg = (zs**2).mean(axis=1)
    x3_avg = (zs**3).mean(axis=1)
    x4_avg = (zs**4).mean(axis=1)

    mean_exact, variance_exact = observed_mean_and_variance(op, xbar, y, sample_vec)
    diff_mean = np.abs(x_avg - mean_exact)
    diff_variance = np.abs(x2_avg - x_avg**2 - variance_exact)
    sigma_sq = nsamples / (nsamples - 1.0) * (x2_avg - x_avg**2)
    mu4 = x4_avg - 4 * x_avg * x3_avg + 6 * x_avg**2 * x2_avg - 3 * x_avg**4
    error_diff_mean = np.sqrt(sigma_sq / nsamples)
    error_diff_variance = np.sqrt(
        np.maximum(mu4 - (nsamples - 3.0) / (nsamples - 1.0) * sigma_sq**2, 0.0) / nsamples
    )

    with open(filename, "w") as out:
        for q, (label_q, diff, err) in enumerate(
            [
                ("mean", diff_mean, error_diff_mean),
                ("variance", diff_variance, error_diff_variance),
            ]
        ):
            out.write(
                "**** q_k = |E[z^k] - E[z]| **** \n"
                if q == 0
                else "**** q_k = |Var[z^k] - Var[z]| **** \n"
            )
            out.write(f"  {'':12s}   {'k':>3s} : {'q_k':>12s} {'q_k/q_0':>35s} {'q_k/q_{k-1}':>35s}\n")
            diff_0 = diff[0] if diff[0] != 0 else 1.0
            for j in range(nsteps + 1):
                line = (
                    f"  {label_q:>12s}   {j:3d} : {diff[j]:12.8f} +/- {err[j]:12.8f}"
                    f"       {diff[j] / diff_0:12.8f} +/- {err[j] / diff_0:12.8f}      "
                )
                if j > 0 and diff[j - 1] != 0:
                    rel = diff[j] / diff[j - 1] * np.sqrt(
                        (err[j] / max(diff[j], 1e-300)) ** 2
                        + (err[j - 1] / max(diff[j - 1], 1e-300)) ** 2
                    )
                    line += f" {diff[j] / diff[j - 1]:12.8f} +/- {rel:12.8f} \n"
                else:
                    line += f" {'---':>12s}\n"
                out.write(line)
            out.write("\n")


def posterior_statistics(sampler, op, config, f, mean_x_exact, mparams):
    """cf. ``posterior_statistics`` (``driver_mgmc.cc:118-171``)."""
    sp = config.sampling
    fj = jnp.asarray(f)
    key = sampling_key(815747)
    x = jnp.zeros(op.lattice.vshape)

    @jax.jit
    def warm(x, key):
        def body(k, x):
            return sampler.apply_indexed(jax.random.fold_in(key, k), fj, x, k)

        return jax.lax.fori_loop(0, sp.nwarmup, body, x)

    @jax.jit
    def collect(x, key):
        def step(carry, k):
            x, m, v = carry
            x = sampler.apply_indexed(jax.random.fold_in(key, k), fj, x, k)
            m = m + (x - m) / (k + 1.0)
            v = v + (x * x - v) / (k + 1.0)
            return (x, m, v), 0.0

        (x, m, v), _ = jax.lax.scan(
            step, (x, jnp.zeros_like(x), jnp.zeros_like(x)), jnp.arange(sp.nsamples)
        )
        return m, v

    x = warm(x, jax.random.fold_in(key, 0))
    mean, var2 = collect(x, jax.random.fold_in(key, 1))
    mean = np.asarray(mean)
    variance = np.asarray(var2) - mean * mean

    writer = VTKWriter("posterior.vtk", op.lattice, 1)
    writer.add_state(mean, "mean")
    writer.add_state(variance, "variance")
    writer.add_state(mean_x_exact, "mean_exact")
    writer.write()
    if op.lattice.dim == 2 and mparams.sample_location is not None:
        write_vtk_circle(mparams.sample_location, mparams.radius, "sample_location.vtk")


def main(argv=None):
    configure_runtime()
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Usage: python -m multigridmc_tpu.drivers.mgmc CONFIGURATIONFILE")
        sys.exit(-1)
    t_start = time.perf_counter()
    print()
    print("+--------------------------------+")
    print("! Multigrid Monte Carlo sampling !")
    print("+--------------------------------+")
    print()
    config = load_config(argv[0])
    echo_config(config)
    prior, op, mparams = build_operators(config)
    samplers = make_samplers(config, op)
    xbar, y, mean_x_exact, f, sample_vec = exact_setup(prior, op, mparams)

    # float32 zero-mean protocol (samplers/base.py MeanShiftedSampler): wrap
    # the samplers so the exactly-known (host float64) posterior mean is
    # carried outside the f32 chain.  The Cholesky samplers need it too: their
    # Woodbury mean solve Q^{-1} f cancels terms of size Sigma^{-1} ~ 1e6 and
    # loses the mean in float32 (the band sampler read -11.4 against an exact
    # 0.83 on the flagship posterior)
    ms = config.general.mean_shift.lower()
    if ms == "on" or (ms == "auto" and jnp.zeros(()).dtype == jnp.float32):
        for label in ("cholesky", "ssor", "multigridmc"):
            if label in samplers:
                samplers[label] = MeanShiftedSampler(samplers[label], mean_x_exact)
        if ms == "auto":
            print("float32 run: zero-mean sampling protocol enabled "
                  "(general.mean_shift = auto)")

    for label, sampler in samplers.items():
        measure_sampling_time(
            label, sampler, op, config, f, sample_vec, xbar, y, f"timeseries_{label}.txt"
        )
    if config.general.measure_convergence:
        for label in ("ssor", "multigridmc"):
            if label in samplers:
                measure_convergence(
                    label, samplers[label], op, config, f, sample_vec, xbar, y,
                    f"convergence_{label}.txt",
                )
    if config.general.save_posterior_statistics and "multigridmc" in samplers:
        posterior_statistics(samplers["multigridmc"], op, config, f, mean_x_exact, mparams)

    t_elapsed = time.perf_counter() - t_start
    hours, rem = divmod(int(t_elapsed), 3600)
    mins, secs = divmod(rem, 60)
    print(f"total run time: {hours:d}h {mins:02d}m {secs:02d}s")


if __name__ == "__main__":
    main()
