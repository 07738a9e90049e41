"""Smoke test of the program's main path on an NVIDIA GPU.

Drives the flagship deployment (tests/fixtures/flagship.cfg: 2d posterior on
a 256x256 lattice, 255^2 unknowns, 8 point measurements, 5-level SOR W-cycle
MGMC in float32) through the entry points a user calls, and checks the
numbers against the repository's float64 references:

1. drivers   ``drivers.mgmc`` and ``drivers.mg`` on the flagship config; the
             time series of its Cholesky and MGMC samplers against the exact
             posterior.
2. moments   ``MultigridMCSampler.apply`` on 256 chains (zero-mean float32
             protocol), 100 warm-up and 400 collected steps: the point
             observable's mean and variance against the exact float64
             posterior, with tau_int estimated from the chains.  The exact
             band-Cholesky sampler passes the same gate.
3. numerics  One noise-free W-cycle of ``MultigridPreconditioner`` in float32
             on the card against the float64 host reference
             (``multigridmc_tpu.reference``) at 255^2 and at 63^3.
4. size      One MGMC step program at 1023^2 and at 63^3 (256 chains):
             compile, memory analysis, 20 steps, finite output.

``--four`` runs, on four GPUs, only the multi-device paths and what they are
compared with: data-parallel chains against the per-shard emulation on one
card plus the moment gate, and the explicit-halo lattice-sharded sampler at
1023^2 on meshes (1, 2, 2) and (1, 4, 1) against the one-device run
("global" noise) plus the moment gate ("sharded" noise).  Its programs are
compiled concurrently before any check runs.

Usage::

    python chip_smoke.py                 # one GPU, phases 1-4
    python chip_smoke.py --phases 2,3    # a subset of the one-GPU phases
    python chip_smoke.py --four          # four GPUs, multi-device paths only

Without a GPU, outside a checkout of the repository, or when a phase fails,
the script exits non-zero and prints no result.  Otherwise the last line of
standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

REPO = Path(__file__).resolve().parent
FLAGSHIP = REPO / "tests" / "fixtures" / "flagship.cfg"
NCHAINS = 256


# ------------------------------------------------------------------ plumbing
def card_identity() -> str:
    """Name and power limit of the card(s), read by a child process that
    stays off JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def result_line(devices) -> str:
    """The last line of standard output: the contract's keys, nothing more."""
    d = devices[0]
    return json.dumps({"ok": True, "device": {
        "platform": d.platform, "kind": d.device_kind, "count": len(devices)}})


def log(msg: str) -> None:
    print(msg, flush=True)


def peak_bytes(device) -> int:
    stats = device.memory_stats() or {}
    return int(stats.get("peak_bytes_in_use", 0))


def compile_and_run(label: str, fn, *args, static_argnums=()):
    """Compile ``fn`` for ``args``, print compile time and memory analysis,
    run it once and print the step time (host clock ended by
    ``block_until_ready``).  Returns the output."""
    import jax

    t0 = time.perf_counter()
    compiled = jax.jit(fn, static_argnums=static_argnums).lower(*args).compile()
    t_compile = time.perf_counter() - t0
    mem = compiled.memory_analysis()
    if mem is not None:
        log(f"  [{label}] memory analysis: arguments {mem.argument_size_in_bytes} B, "
            f"outputs {mem.output_size_in_bytes} B, temporaries "
            f"{mem.temp_size_in_bytes} B, generated code "
            f"{mem.generated_code_size_in_bytes} B")
    dyn = [a for i, a in enumerate(args) if i not in static_argnums]
    t0 = time.perf_counter()
    out = jax.block_until_ready(compiled(*dyn))
    t_run = time.perf_counter() - t0
    log(f"  [{label}] compile {t_compile:.3f} s, run {t_run:.6f} s")
    return out


def check(label: str, value: float, bound: float) -> None:
    """Print a comparison beside its tolerance; fail when it is exceeded."""
    ok = value <= bound
    log(f"  [{label}] {value:.6e} <= {bound:.6e}: {'pass' if ok else 'FAIL'}")
    if not ok:
        raise AssertionError(f"{label}: {value:.6e} exceeds {bound:.6e}")


# ------------------------------------------------------------------ problems
def flagship_config(nx: int | None = None):
    from multigridmc_tpu.utils.config import load_config

    config = load_config(FLAGSHIP)
    if nx is not None:
        config.lattice.nx = config.lattice.ny = nx
    return config


def flagship_operator(nx: int | None = None):
    """The flagship posterior (optionally at another lattice size), its
    measurement parameters and the observation vector at sample_location."""
    from multigridmc_tpu.drivers.common import build_operators
    from multigridmc_tpu.models.posterior import measurement_vector

    config = flagship_config(nx)
    _, op, mparams = build_operators(config)
    w = measurement_vector(op.lattice, mparams.sample_location, mparams.radius)
    return config, op, mparams, w


def posterior_3d(n: int):
    """3d shifted-Laplace FD posterior on an n^3 lattice with 8 point
    measurements of variance about 1e-6 (Lambda = 0.2, as the flagship)."""
    import numpy as np

    from multigridmc_tpu.lattice import Lattice
    from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
    from multigridmc_tpu.models.prior import shiftedlaplace_fd

    rng = np.random.default_rng(20260816)
    prior = shiftedlaplace_fd(Lattice((n, n, n)), ConstantCorrelationLengthModel(0.2))
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(8, 3)),
        mean=rng.normal(2.0, 1.0, size=8),
        variance=1e-6 * (1.0 + rng.uniform(size=8)),
    )
    return measured_operator(prior, params)


def exact_observation(op, mparams, w):
    """Posterior mean field and the observable's exact mean and variance,
    in float64 on the host."""
    import numpy as np

    from multigridmc_tpu.models.posterior import observed_mean_and_variance, posterior_mean

    xbar = np.zeros(op.vshape)
    y = mparams.y()
    mean_field = posterior_mean(op, xbar, y)
    mean, var = observed_mean_and_variance(op, xbar, y, w)
    return mean_field, mean, var


# -------------------------------------------------------------------- gates
def chain_block(step, w, key, block: int):
    """``run(x, k0)``: ``block`` steps ``x <- step(fold_in(key, k), x)`` for
    k = k0, k0 + 1, ... and the observable ``<w, x>`` after each step, shape
    (block, nchains)."""
    import jax
    import jax.numpy as jnp

    def run(x, k0):
        wj = jnp.asarray(w, x.dtype)

        def body(x, k):
            x = step(jax.random.fold_in(key, k), x)
            return x, jnp.tensordot(x, wj, axes=wj.ndim,
                                    precision=jax.lax.Precision.HIGHEST)
        return jax.lax.scan(body, x, k0 + jnp.arange(block))
    return run


def observe_chains(run, x, nwarm: int, ncollect: int, block: int):
    """Run nwarm + ncollect steps as blocks of ``run`` (a jitted or compiled
    ``chain_block``) and return the observable of the collected steps, shape
    (ncollect, nchains), and the final state."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    assert nwarm % block == 0 and ncollect % block == 0
    zs = []
    t0 = time.perf_counter()
    for b in range((nwarm + ncollect) // block):
        x, z = run(x, jnp.int32(b * block))
        if b * block >= nwarm:
            zs.append(np.asarray(z, dtype=np.float64))
        if b == 0:
            jax.block_until_ready(x)
            log(f"    first block ({block} steps, with compile if not compiled) "
                f"{time.perf_counter() - t0:.3f} s")
            t0 = time.perf_counter()
    x = jax.block_until_ready(x)
    nrest = (nwarm + ncollect) // block - 1
    if nrest:
        log(f"    {nrest * block} steps in {time.perf_counter() - t0:.3f} s")
    return np.concatenate(zs).reshape(ncollect, -1), x


def moment_gate(label: str, z, exact_mean: float, exact_var: float,
                k_max: int = 50) -> dict:
    """Mean and variance of the observable against the exact values:
    |mean - exact| < 6 sqrt(var tau / N) and
    |var - exact| < 5 sqrt(2 tau / N) var + 5e-3 var, tau estimated from the
    chains (utils/statistics.py)."""
    import numpy as np

    from multigridmc_tpu.utils.statistics import tau_int_chains

    z = np.asarray(z, dtype=np.float64)
    n = z.size
    tau = tau_int_chains(z, min(k_max, z.shape[0] // 4))
    mean = float(z.mean())
    var = float(np.mean(z * z) - mean * mean)
    log(f"  [{label}] {n} samples, tau_int {tau:.4f}; mean {mean:.6e} "
        f"(exact {exact_mean:.6e}), variance {var:.6e} (exact {exact_var:.6e})")
    check(f"{label} |mean - exact|", abs(mean - exact_mean),
          6.0 * np.sqrt(exact_var * tau / n))
    check(f"{label} |var - exact|", abs(var - exact_var),
          5.0 * np.sqrt(2.0 * tau / n) * exact_var + 5e-3 * exact_var)
    return dict(mean=mean, var=var, tau=tau, n=n)


# ------------------------------------------------------------------- phases
def phase_drivers(config_path=FLAGSHIP, workdir=None) -> None:
    """Phase 1: the sampling and solver drivers on a config, in this process;
    each must finish and write its output files.  The single-chain time
    series that ``drivers.mgmc`` writes for the exact (Cholesky) and the MGMC
    sampler must pass the moment gate against the exact posterior; SSOR
    mixes too slowly for a run of this length to be held to it."""
    import numpy as np

    from multigridmc_tpu.drivers import mg, mgmc
    from multigridmc_tpu.drivers.common import build_operators
    from multigridmc_tpu.models.posterior import measurement_vector
    from multigridmc_tpu.utils.config import load_config

    config = load_config(config_path)
    workdir = Path(workdir or tempfile.mkdtemp(prefix="chip_smoke_drivers_"))
    with contextlib.chdir(workdir):
        t0 = time.perf_counter()
        mgmc.main([str(Path(config_path).resolve())])
        log(f"  [drivers.mgmc] {time.perf_counter() - t0:.3f} s")
        t0 = time.perf_counter()
        mg.main([str(Path(config_path).resolve())])
        log(f"  [drivers.mg] {time.perf_counter() - t0:.3f} s")
    g = config.general
    expected = ["solution.vtk"] + [
        f"timeseries_{name}.txt" for name, on in
        (("cholesky", g.do_cholesky), ("ssor", g.do_ssor),
         ("multigridmc", g.do_multigridmc)) if on]
    missing = [name for name in expected if not (workdir / name).exists()]
    if missing:
        raise AssertionError(f"drivers wrote no {', '.join(missing)}")
    log(f"  [drivers] wrote {', '.join(expected)}")
    _, op, mparams = build_operators(config)
    w = measurement_vector(op.lattice, mparams.sample_location, mparams.radius)
    _, exact_mean, exact_var = exact_observation(op, mparams, w)
    for label, on in (("cholesky", g.do_cholesky), ("multigridmc", g.do_multigridmc)):
        if on:
            z = np.loadtxt(workdir / f"timeseries_{label}.txt").reshape(-1, 1)
            moment_gate(f"drivers.mgmc {label}", z, exact_mean, exact_var, k_max=10)


def phase_moments(nx: int | None = None, nlevel: int | None = None,
                  nchains: int = NCHAINS,
                  nwarm: int = 100, ncollect: int = 400, block: int = 100,
                  ncholesky: int = 64) -> dict:
    """Phase 2: moment gates of the batched MGMC sampler (zero-mean float32
    protocol, as in drivers/mgmc.py) and of the exact band-Cholesky sampler."""
    import jax
    import jax.numpy as jnp

    from multigridmc_tpu.samplers.base import MeanShiftedSampler
    from multigridmc_tpu.samplers.cholesky import BandCholeskySampler
    from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
    from multigridmc_tpu.utils.runtime import sampling_key

    config, op, mparams, w = flagship_operator(nx)
    mg = config.multigrid
    t0 = time.perf_counter()
    mean_field, exact_mean, exact_var = exact_observation(op, mparams, w)
    log(f"  [exact] float64 host posterior {time.perf_counter() - t0:.3f} s")
    t0 = time.perf_counter()
    sampler = MultigridMCSampler(
        op, nlevel=nlevel or mg.nlevel, smoother=mg.smoother, coarse_solver=mg.coarse_solver,
        omega=mg.omega, cycle=mg.cycle, coarse_scaling=mg.coarse_scaling)
    log(f"  [mgmc] setup {time.perf_counter() - t0:.3f} s, distilled level "
        f"{sampler.distill_level}")
    dtype = op.coeffs.dtype
    mgmc = MeanShiftedSampler(sampler, mean_field)
    f = jnp.zeros(op.vshape, dtype)
    x0 = jnp.broadcast_to(jnp.asarray(mean_field, dtype), (nchains,) + op.vshape)
    run = jax.jit(chain_block(lambda k, x: mgmc.apply(k, f, x), w,
                              sampling_key(5418513), block))
    z, x = observe_chains(run, x0, nwarm, ncollect, block)
    if not bool(jnp.isfinite(x).all()):
        raise AssertionError("non-finite MGMC chain state")
    out = {"mgmc": moment_gate("mgmc", z, exact_mean, exact_var)}

    t0 = time.perf_counter()
    band = BandCholeskySampler(op)
    log(f"  [cholesky] band setup {time.perf_counter() - t0:.3f} s, "
        f"recursive doubling {band.factor.parallel}")
    exact = MeanShiftedSampler(band, mean_field)
    run = jax.jit(chain_block(lambda k, x: exact.apply(k, f, x), w,
                              sampling_key(815747), ncholesky))
    z, _ = observe_chains(run, x0, 0, ncholesky, ncholesky)
    out["cholesky"] = moment_gate("cholesky", z, exact_mean, exact_var)
    log(f"  [moments] peak device memory {peak_bytes(jax.devices()[0])} B")
    return out


def phase_numerics(nx: int | None = None, nlevel: int | None = None,
                   n3d: int = 64, nlevel_3d: int = 4,
                   nrhs: int = 4, tol: float = 1e-4) -> dict:
    """Phase 3: one noise-free W-cycle of MultigridPreconditioner on the
    device against the float64 host reference, in 2d (flagship) and 3d."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from multigridmc_tpu import reference
    from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner

    config, op2, _, _ = flagship_operator(nx)
    mg = config.multigrid
    cases = [("2d", op2, nlevel or mg.nlevel), ("3d", posterior_3d(n3d), nlevel_3d)]
    rel = {}
    for label, op, nlevel in cases:
        pc = MultigridPreconditioner(op, nlevel=nlevel, smoother=mg.smoother,
                                     omega=mg.omega, cycle=mg.cycle)
        b = np.random.default_rng(7).standard_normal((nrhs,) + op.vshape)
        out = compile_and_run(f"{label} {op.vshape} W-cycle", pc.apply,
                              jnp.asarray(b, op.coeffs.dtype))
        out = np.asarray(out, dtype=np.float64).reshape(nrhs, -1)
        t0 = time.perf_counter()
        levels = reference.hierarchy(op, nlevel, [o.offsets for o in pc.hierarchy.operators])
        exp = reference.multigrid_cycle(levels, b.reshape(nrhs, -1), omega=mg.omega,
                                        cycle=mg.cycle, coarse_scaling=mg.coarse_scaling)
        log(f"  [{label}] float64 reference {time.perf_counter() - t0:.3f} s, "
            f"distilled level {pc.distill_level}")
        rel[label] = float(np.linalg.norm(out - exp) / np.linalg.norm(exp))
        check(f"{label} {op.vshape} relative L2 difference", rel[label], tol)
    log(f"  [numerics] peak device memory {peak_bytes(jax.devices()[0])} B")
    return rel


def phase_size(nx: int = 1024, nlevel: int = 7, n3d: int = 64,
               nlevel_3d: int = 4, nchains: int = NCHAINS, nsteps: int = 20) -> None:
    """Phase 4: an MGMC step program at a size that fills a real run, in 2d
    and 3d: compile, memory analysis, nsteps steps, finite output."""
    import jax
    import jax.numpy as jnp

    from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
    from multigridmc_tpu.utils.runtime import sampling_key

    config, op2, _, _ = flagship_operator(nx)
    mg = config.multigrid
    for label, op, nlevel_ in (("2d", op2, nlevel), ("3d", posterior_3d(n3d), nlevel_3d)):
        sampler = MultigridMCSampler(op, nlevel=nlevel_, smoother=mg.smoother,
                                     omega=mg.omega, cycle=mg.cycle)
        dtype = op.coeffs.dtype
        x = jnp.zeros((nchains,) + op.vshape, dtype)
        f = jnp.zeros(op.vshape, dtype)

        def steps(key, f, x, sampler=sampler):
            return jax.lax.fori_loop(
                0, nsteps,
                lambda k, x: sampler.apply(jax.random.fold_in(key, k), f, x), x)

        out = compile_and_run(
            f"{label} {nchains} x {op.vshape}, {nsteps} steps, distilled level "
            f"{sampler.distill_level}", steps, sampling_key(3), f, x)
        if not bool(jnp.isfinite(out).all()):
            raise AssertionError(f"{label}: non-finite chain state")
        del out, x
    log(f"  [size] peak device memory {peak_bytes(jax.devices()[0])} B")


def compile_all(jobs: dict) -> dict:
    """Lower every ``label: (fn, args)`` in turn, then compile them all at
    once in threads (XLA compiles without holding the GIL); prints each
    compile time and returns ``label: compiled``."""
    from concurrent.futures import ThreadPoolExecutor

    import jax

    def compile_one(lowered):
        t0 = time.perf_counter()
        return lowered.compile(), time.perf_counter() - t0

    lowered = {label: jax.jit(fn).lower(*args) for label, (fn, args) in jobs.items()}
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(lowered)) as pool:
        futures = {label: pool.submit(compile_one, lo) for label, lo in lowered.items()}
        compiled = {}
        for label, future in futures.items():
            compiled[label], dt = future.result()
            log(f"  [{label}] compile {dt:.3f} s")
    log(f"  [compile] {len(jobs)} programs in {time.perf_counter() - t0:.3f} s")
    return compiled


def phase_four(nx_sharded: int = 1024, nlevel_sharded: int = 5,
               sharded_chains: int = 16, nx_dp: int | None = None,
               nlevel_dp: int | None = None,
               nchains: int = NCHAINS, nwarm: int = 100, ncollect: int = 400,
               sharded_ncollect: int = 200, block: int = 100, ndev: int = 4) -> None:
    """Four devices: chains data parallelism and lattice sharding.  Every
    program is compiled up front, concurrently; the checks run after."""
    from concurrent.futures import ThreadPoolExecutor

    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multigridmc_tpu.parallel.cycle import ShardedMGMCSampler, pad_field
    from multigridmc_tpu.parallel.data_parallel import DataParallelMGMCSampler, chains_mesh
    from multigridmc_tpu.utils.runtime import sampling_key

    devices = jax.devices()[:ndev]
    if len(devices) < ndev:
        raise AssertionError(f"{ndev} devices needed, {len(devices)} present")
    t0 = time.perf_counter()
    jobs = {}

    # --- chains data parallelism against the per-shard emulation -----------
    config, op, mparams, w = flagship_operator(nx_dp)
    mg = config.multigrid
    dtype = op.coeffs.dtype
    dmesh = chains_mesh(ndev, devices)
    dp = DataParallelMGMCSampler(op, nlevel_dp or mg.nlevel, dmesh, smoother=mg.smoother,
                                 omega=mg.omega, cycle=mg.cycle)
    f = jnp.zeros(op.vshape, dtype)
    mean_field, exact_mean, exact_var = exact_observation(op, mparams, w)
    mean_j = jnp.asarray(mean_field, dtype)
    x0 = jax.device_put(jnp.broadcast_to(mean_j, (nchains,) + op.vshape),
                        NamedSharding(dmesh, P("chains")))
    key = sampling_key(11)
    cb = nchains // ndev
    x_shard = jnp.zeros((cb,) + op.vshape, dtype)
    jobs["data-parallel step"] = (dp.apply, (key, f, x0))
    jobs["per-shard emulation step"] = (dp.sampler.apply, (key, f, x_shard))
    jobs["data-parallel gate"] = (chain_block(
        lambda k, x: mean_j + dp.apply(k, f, x - mean_j), w, key, block),
        (x0, jnp.int32(0)))

    # --- lattice sharding (explicit halos) -----------------------------------
    config, op_s, mparams_s, w_s = flagship_operator(nx_sharded)
    vs = op_s.vshape
    axes = ("chains", "ly", "lx")
    kw = dict(nlevel=nlevel_sharded, smoother=mg.smoother, omega=mg.omega,
              cycle=mg.cycle, agglomerate_below=8)
    rng = np.random.default_rng(1)
    fp = pad_field(jnp.asarray(rng.standard_normal(vs), dtype), vs)
    xp = pad_field(jnp.zeros((sharded_chains,) + vs, dtype), vs)
    key_s = sampling_key(0)
    mesh1 = Mesh(np.asarray(devices[:1]).reshape(1, 1, 1), axes)
    jobs["1 device global noise"] = (
        ShardedMGMCSampler(op_s, mesh=mesh1, noise_mode="global", **kw).apply,
        (key_s, fp, xp))
    w_p = pad_field(jnp.asarray(w_s, dtype), vs)
    zero_p = jnp.zeros_like(fp)
    meshes = [(1, 2, 2), (1, 4, 1)]
    states = {}
    for shape in meshes:
        mesh = Mesh(np.asarray(devices).reshape(shape), axes)
        jobs[f"mesh {shape} global noise"] = (
            ShardedMGMCSampler(op_s, mesh=mesh, noise_mode="global", **kw).apply,
            (key_s, fp, xp))
        sh = ShardedMGMCSampler(op_s, mesh=mesh, noise_mode="sharded", **kw)
        states[shape] = jax.device_put(jnp.zeros((sharded_chains,) + fp.shape, dtype),
                                       NamedSharding(mesh, P(None, "ly", "lx")))
        jobs[f"mesh {shape} sharded-noise gate"] = (chain_block(
            lambda k, x, sh=sh: sh.apply(k, zero_p, x), w_p, sampling_key(17), block),
            (states[shape], jnp.int32(0)))
    log(f"  [four] samplers built in {time.perf_counter() - t0:.3f} s")
    with ThreadPoolExecutor(1) as pool:  # the host posterior while XLA compiles
        t0 = time.perf_counter()
        exact_s = pool.submit(exact_observation, op_s, mparams_s, w_s)
        compiled = compile_all(jobs)
        mean_field_s, exact_mean_s, exact_var_s = exact_s.result()
        log(f"  [exact] {vs} float64 host posterior done after "
            f"{time.perf_counter() - t0:.3f} s")

    out = jax.block_until_ready(compiled["data-parallel step"](key, f, x0 - mean_j))
    if len(out.sharding.device_set) != ndev:
        raise AssertionError(f"DP output lives on {len(out.sharding.device_set)} devices")
    emul = np.concatenate([
        np.asarray(compiled["per-shard emulation step"](
            jax.random.fold_in(key, i), f, x_shard)) for i in range(ndev)])
    check("data-parallel vs per-shard emulation, max |diff|",
          float(np.max(np.abs(np.asarray(out) - emul))),
          1e-5 * max(float(np.max(np.abs(emul))), 1.0))
    z, x = observe_chains(compiled["data-parallel gate"], x0, nwarm, ncollect, block)
    if len(x.sharding.device_set) != ndev:
        raise AssertionError("DP chain state is not sharded over all devices")
    moment_gate("data-parallel mgmc", z, exact_mean, exact_var)
    del x, out

    # the sharded-noise chains run zero-mean (the float32 protocol); the
    # observable of the posterior mean is added back on the host
    shift = float(np.tensordot(mean_field_s, np.asarray(w_s, np.float64), axes=len(vs)))
    ref1 = np.asarray(compiled["1 device global noise"](key_s, fp, xp))
    scale = float(np.max(np.abs(ref1)))
    for shape in meshes:
        out = jax.block_until_ready(compiled[f"mesh {shape} global noise"](key_s, fp, xp))
        if len(out.sharding.device_set) != ndev:
            raise AssertionError(f"mesh {shape}: output on {len(out.sharding.device_set)} devices")
        check(f"mesh {shape} global noise vs 1 device, max |diff|",
              float(np.max(np.abs(np.asarray(out) - ref1))), 1e-4 * max(scale, 1.0))
        z, x = observe_chains(compiled[f"mesh {shape} sharded-noise gate"], states[shape],
                              nwarm, sharded_ncollect, block)
        if len(x.sharding.device_set) != ndev:
            raise AssertionError(f"mesh {shape}: chain state not on {ndev} devices")
        moment_gate(f"mesh {shape} sharded-noise mgmc", shift + z, exact_mean_s, exact_var_s)
        del x, out
    for d in devices:
        log(f"  [four] {d} peak device memory {peak_bytes(d)} B")


# --------------------------------------------------------------------- main
PHASES = {1: ("drivers", phase_drivers), 2: ("moments", phase_moments),
          3: ("numerics", phase_numerics), 4: ("size", phase_size)}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--four", action="store_true",
                        help="run only the four-GPU paths")
    parser.add_argument("--phases", default="1,2,3,4",
                        help="comma-separated one-GPU phases to run")
    args = parser.parse_args(argv)
    try:
        import multigridmc_tpu  # noqa: F401  (the checkout must be present)
    except ImportError as e:
        print(f"chip_smoke: the repository is not beside this script ({e})",
              file=sys.stderr)
        return 2
    import jax

    from multigridmc_tpu.utils.runtime import configure_runtime

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"chip_smoke: no GPU (JAX's devices are {devices})", file=sys.stderr)
        return 1
    log("card (nvidia-smi name, power.limit):")
    log(card_identity())
    log(f"jax {jax.__version__}, devices {devices}")
    configure_runtime(default_x64=False)
    if args.four:
        phases = [("four", phase_four)]
    else:
        phases = [PHASES[int(p)] for p in args.phases.split(",")]
    t_all = time.perf_counter()
    for name, fn in phases:
        log(f"== phase {name}")
        t0 = time.perf_counter()
        try:
            fn()
        except Exception:
            log(f"== phase {name} FAILED after {time.perf_counter() - t0:.3f} s")
            raise
        log(f"== phase {name} passed in {time.perf_counter() - t0:.3f} s")
    log(f"all phases passed in {time.perf_counter() - t_all:.3f} s")
    print(result_line(jax.devices()), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
