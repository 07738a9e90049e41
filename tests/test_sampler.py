"""Sampler statistical tests, mirroring ``src/sampler/test_sampler.hh:163-323``.

The oracle is the reference's own: draw many samples, compare the chain mean to
``Q^{-1} f`` and the sample covariance to ``Q^{-1}`` in the L-infinity norm
(``test_sampler.hh:113-153``).  Here the chain batches: C independent chains x
S steps replace one long chain - the stationary distribution is identical and
independent chains only *reduce* estimator autocorrelation.

Fixture: the reference's ``TestOperator1d`` (``test_sampler.hh:47-88``) - an
8-cell 1d lattice (7 interior vertices), tridiag(-1, 6, -1), optionally with the
rank-2 update B[3,0]=B[4,1]=10, Sigma=diag(4.2, 9.3); and the 2d FEM posterior
of ``TestMultigridMCSampler2d`` (``test_sampler.hh:266-320``).
"""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

#: two-tier test budget, cf. the reference's THOROUGH_TESTING flag
#: (src/config.h.in:3-10): MGMC_THOROUGH=1 scales sample counts up ~4x and
#: tightens tolerances toward the thorough-tier gates (test_sampler.hh:318-320)
THOROUGH = os.environ.get("MGMC_THOROUGH", "0") == "1"


def tier(nchains, nsteps, tol):
    """Scale a (nchains, nsteps, tol) budget by the active tier."""
    if THOROUGH:
        return 2 * nchains, 2 * nsteps, tol / 2
    return nchains, nsteps, tol

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import PeriodicCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fem
from multigridmc_tpu.ops.stencil import LowRank, StencilOperator
from multigridmc_tpu.samplers.cholesky import BandCholeskySampler, DenseCholeskySampler
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu.samplers.sor import SSORSampler


def make_operator_1d(lowrank: bool) -> StencilOperator:
    """cf. ``TestOperator1d`` (``test_sampler.hh:47-88``)."""
    lattice = Lattice((8,))
    n = lattice.nvertex  # 7
    coeffs = jnp.stack(
        [
            jnp.full((n,), -1.0),  # offset -1
            jnp.full((n,), 6.0),  # offset 0
            jnp.full((n,), -1.0),  # offset +1
        ]
    )
    lr = None
    if lowrank:
        B = np.zeros((2, n))
        B[0, 3] = 10.0
        B[1, 4] = 10.0
        lr = LowRank(B=jnp.asarray(B), Sigma_diag=jnp.asarray([4.2, 9.3]))
    return StencilOperator(
        coeffs=coeffs, offsets=((-1,), (0,), (1,)), lattice=lattice, lowrank=lr
    ).normalized()


def mean_covariance_error(op, sampler, nchains, nwarmup, nsteps, seed=1342517):
    """Batched version of ``SamplerTest::mean_covariance_error``
    (``test_sampler.hh:113-153``)."""
    n = op.lattice.nvertex
    rng = np.random.default_rng(seed)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f_flat = Q @ mean_exact
    f = jnp.asarray(f_flat.reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    key = jax.random.PRNGKey(seed)
    x = jnp.zeros((nchains,) + op.lattice.vshape)

    @jax.jit
    def warmup(x, key):
        def body(i, x):
            return sampler.apply(jax.random.fold_in(key, i), f, x)

        return jax.lax.fori_loop(0, nwarmup, body, x)

    @jax.jit
    def collect(x, key):
        def step(carry, i):
            x, sx, sxx = carry
            x = sampler.apply(jax.random.fold_in(key, i), f, x)
            xf = x.reshape(nchains, n)
            sx = sx + xf.sum(axis=0)
            sxx = sxx + xf.T @ xf
            return (x, sx, sxx), 0.0

        (x, sx, sxx), _ = jax.lax.scan(
            step, (x, jnp.zeros((n,)), jnp.zeros((n, n))), jnp.arange(nsteps)
        )
        return sx, sxx

    x = warmup(x, jax.random.fold_in(key, 0))
    sx, sxx = collect(x, jax.random.fold_in(key, 1))
    total = nchains * nsteps
    Ex = np.asarray(sx) / total
    Exx = np.asarray(sxx) / total
    cov = Exx - np.outer(Ex, Ex)
    error_mean = np.max(np.abs(Ex - mean_exact))
    error_cov = np.max(np.abs(cov - cov_exact))
    return error_mean, error_cov


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "lowrank"])
def test_dense_cholesky_sampler_1d(lowrank):
    """cf. ``TestDenseCholeskySampler1d`` - tolerance 2e-3 at ~500k samples."""
    op = make_operator_1d(lowrank)
    sampler = DenseCholeskySampler(op)
    nchains, nsteps, tol = tier(2048, 250, 2e-3)
    em, ec = mean_covariance_error(op, sampler, nchains=nchains, nwarmup=2, nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "lowrank"])
def test_band_cholesky_sampler_1d(lowrank):
    """cf. ``TestSparseCholeskySampler1d`` (host band-Cholesky backend).

    The band sampler is not jittable, so fewer samples / looser tolerance.
    """
    op = make_operator_1d(lowrank)
    sampler = BandCholeskySampler(op)
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)
    key = jax.random.PRNGKey(0)
    nchains, nsteps = 4096, 30  # direct sampler: iid draws, no warmup needed
    x = jnp.zeros((nchains,) + op.lattice.vshape)
    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, i), jnp.broadcast_to(f, x.shape), x)
        xf = np.asarray(x).reshape(nchains, n)
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex, Exx = sx / total, sxx / total
    cov = Exx - np.outer(Ex, Ex)
    assert np.max(np.abs(Ex - mean_exact)) < 4e-3
    assert np.max(np.abs(cov - cov_exact)) < 4e-3


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "lowrank"])
def test_ssor_sampler_1d(lowrank):
    """cf. ``TestSSORSampler1d``: omega=0.8, tolerance 2e-3 at ~500k samples."""
    op = make_operator_1d(lowrank)
    sampler = SSORSampler(op, omega=0.8)
    nchains, nsteps, tol = tier(2048, 250, 2e-3)
    em, ec = mean_covariance_error(op, sampler, nchains=nchains, nwarmup=50, nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "lowrank"])
def test_multigridmc_sampler_1d(lowrank):
    """cf. ``TestMultigridMCSampler1d``: 3 levels, SSOR smoother, Cholesky coarse
    sampler, tolerance 2e-3 at ~500k samples."""
    op = make_operator_1d(lowrank)
    sampler = MultigridMCSampler(
        op, nlevel=3, smoother="SSOR", coarse_solver="Cholesky", omega=1.0, cycle=1
    )
    nchains, nsteps, tol = tier(2048, 250, 2e-3)
    em, ec = mean_covariance_error(op, sampler, nchains=nchains, nwarmup=20, nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)


def make_posterior_2d(nx=8):
    """cf. ``TestMultigridMCSampler2d`` fixture (``test_sampler.hh:266-301``)."""
    lattice = Lattice((nx, nx))
    model = PeriodicCorrelationLengthModel(Lambda_min=1.2, Lambda_max=2.3)
    prior = shiftedlaplace_fem(lattice, model)
    rng = np.random.default_rng(1212417)
    params = MeasurementParameters(
        measurement_locations=np.array(
            [[0.25, 0.25], [0.25, 0.75], [0.75, 0.25], [0.75, 0.75]]
        ),
        mean=np.zeros(4),
        variance=1.0 + 2.0 * rng.uniform(size=4),
        variance_scaling=1e-4,
        radius=0.05,
    )
    return measured_operator(prior, params)


def test_multigridmc_sampler_2d():
    """cf. ``TestMultigridMCSampler2d``: fast tier 8x8 / ~400k samples / 4e-3;
    thorough tier at the reference scale - 16x16, 2M+ samples, tol 2.2e-3
    (``test_sampler.hh:318-320``)."""
    op = make_posterior_2d(16 if THOROUGH else 8)
    sampler = MultigridMCSampler(
        op, nlevel=3, smoother="SSOR", coarse_solver="Cholesky", omega=1.0, cycle=1
    )
    if THOROUGH:
        nchains, nsteps, tol = 2048, 1000, 2.2e-3  # 2.048M samples
    else:
        nchains, nsteps, tol = 1024, 400, 4e-3
    em, ec = mean_covariance_error(op, sampler, nchains=nchains, nwarmup=20, nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)


def test_ssor_sampler_float32():
    """The float32 sampling path (the accelerator production dtype) still meets the
    statistical tolerance - accumulation in float64, samples in float32."""
    op32 = make_operator_1d(False)
    import jax

    op32 = jax.tree.map(
        lambda v: v.astype(jnp.float32) if hasattr(v, "astype") else v, op32
    )
    sampler = SSORSampler(op32, omega=0.8)
    n = op32.lattice.nvertex
    rng = np.random.default_rng(77)
    mean_exact = rng.uniform(size=n)
    Q = op32.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op32.lattice.vshape), dtype=jnp.float32)
    cov_exact = np.linalg.inv(Q)
    key = jax.random.PRNGKey(7)
    nchains, nwarmup, nsteps = 2048, 50, 200

    x = jnp.zeros((nchains,) + op32.lattice.vshape, dtype=jnp.float32)

    @jax.jit
    def warmup(x, key):
        def body(i, x):
            return sampler.apply(jax.random.fold_in(key, i), f, x)

        return jax.lax.fori_loop(0, nwarmup, body, x)

    @jax.jit
    def collect(x, key):
        def step(carry, i):
            x, sx, sxx = carry
            x = sampler.apply(jax.random.fold_in(key, i), f, x)
            xf = x.reshape(nchains, n).astype(jnp.float64)
            return (x, sx + xf.sum(axis=0), sxx + xf.T @ xf), 0.0

        (x, sx, sxx), _ = jax.lax.scan(
            step,
            (x, jnp.zeros((n,), jnp.float64), jnp.zeros((n, n), jnp.float64)),
            jnp.arange(nsteps),
        )
        return sx, sxx

    x = warmup(x, jax.random.fold_in(key, 0))
    sx, sxx = collect(x, jax.random.fold_in(key, 1))
    total = nchains * nsteps
    Ex = np.asarray(sx) / total
    cov = np.asarray(sxx) / total - np.outer(Ex, Ex)
    assert np.max(np.abs(Ex - mean_exact)) < 4e-3
    assert np.max(np.abs(cov - cov_exact)) < 4e-3


def test_multigridmc_sampler_3d():
    """3d MGMC statistical smoke test (the reference only tests 1d/2d samplers;
    3d is exercised through driver configs): 4x4x6 FD posterior, mean/cov vs
    dense inverse."""
    from multigridmc_tpu.models.prior import shiftedlaplace_fd

    lattice = Lattice((4, 4, 6))
    model = PeriodicCorrelationLengthModel(Lambda_min=1.2, Lambda_max=2.3)
    prior = shiftedlaplace_fd(lattice, model)
    rng = np.random.default_rng(5)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.2, 0.8, size=(3, 3)),
        mean=np.zeros(3),
        variance=0.05 * (1 + rng.uniform(size=3)),
    )
    op = measured_operator(prior, params)
    sampler = MultigridMCSampler(
        op, nlevel=2, smoother="SSOR", coarse_solver="Cholesky", omega=1.0, cycle=1
    )
    em, ec = mean_covariance_error(op, sampler, nchains=1024, nwarmup=40, nsteps=300)
    assert em < 8e-3 and ec < 8e-3, (em, ec)


def test_multigridmc_sampler_biharmonic_2d():
    """MGMC on the squared shifted-Laplace (biharmonic) prior: exercises the
    5-colour sweep ordering and the 5x5-box Galerkin coarsening end-to-end."""
    from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu.models.prior import squared_shiftedlaplace_fd

    lattice = Lattice((8, 8))
    op = squared_shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(1.0))
    sampler = MultigridMCSampler(
        op, nlevel=2, smoother="SSOR", coarse_solver="Cholesky", omega=1.0, cycle=1
    )
    # the 13-point stencil needs >= 5 colours
    assert sampler.presamplers[0].forward.smoother.coloring.n_colors >= 5
    # light tier (runtime): 1024 x 100 samples, tol 1e-2 - the reference's
    # fast/thorough two-tier idiom (test_sampler.hh:318-320)
    em, ec = mean_covariance_error(op, sampler, nchains=512, nwarmup=30, nsteps=80)
    assert em < 1.5e-2 and ec < 1.5e-2, (em, ec)


def test_mean_shifted_sampler():
    """The zero-mean (mean_shift) protocol is exact: wrapping a sampler with
    the known mean reproduces the same mean/covariance through the fluctuation
    chain."""
    from multigridmc_tpu.samplers.base import MeanShiftedSampler

    op = make_operator_1d(True)
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    inner = SSORSampler(op, omega=1.0)
    sampler = MeanShiftedSampler(inner, mean_exact.reshape(op.lattice.vshape))

    key = jax.random.PRNGKey(99)
    nchains, nwarmup, nsteps = 2048, 50, 250
    x = jnp.zeros((nchains,) + op.lattice.vshape)

    @jax.jit
    def run(x, key):
        def body(i, x):
            return sampler.apply(jax.random.fold_in(key, i), f, x)

        x = jax.lax.fori_loop(0, nwarmup, body, x)

        def step(carry, i):
            x, sx, sxx = carry
            x = sampler.apply(jax.random.fold_in(key, nwarmup + i), f, x)
            xf = x.reshape(nchains, n)
            return (x, sx + xf.sum(axis=0), sxx + xf.T @ xf), 0.0

        (x, sx, sxx), _ = jax.lax.scan(
            step, (x, jnp.zeros((n,)), jnp.zeros((n, n))), jnp.arange(nsteps)
        )
        return sx, sxx

    sx, sxx = run(x, key)
    total = nchains * nsteps
    Ex = np.asarray(sx) / total
    cov = np.asarray(sxx) / total - np.outer(Ex, Ex)
    assert np.max(np.abs(Ex - mean_exact)) < 2e-3
    assert np.max(np.abs(cov - cov_exact)) < 2e-3


def test_dense_cholesky_sampler_multidim_batch():
    """Multi-dimensional chain batches (c1, c2, *vshape) sample correctly
    (a moveaxis once produced a rank-3 rhs the triangular solve rejected)."""
    op = make_operator_1d(False)
    sampler = DenseCholeskySampler(op)
    n = op.lattice.nvertex
    rng = np.random.default_rng(11)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    x = jnp.zeros((16, 64) + op.lattice.vshape)
    key = jax.random.PRNGKey(123)
    acc = np.zeros(n)
    nsteps = 40
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, i), f, x)
        acc += np.asarray(x).reshape(-1, n).mean(axis=0)
    assert x.shape == (16, 64) + op.lattice.vshape
    assert np.max(np.abs(acc / nsteps - mean_exact)) < 2e-2


def test_band_factor_device_solves():
    """BandFactor blocked device solves == scipy band solves, and the
    stencil-only band stays narrow in the presence of measurements
    (device-resident band triangular solves)."""
    import scipy.linalg
    from multigridmc_tpu.samplers.cholesky import (
        BandFactor,
        _band_matrix_stencil,
        _np_band_solve,
    )

    op = make_posterior_2d(8)  # 7x7 grid, 4 measurements with radius > 0
    ab, b = _band_matrix_stencil(op)
    n = ab.shape[1]
    assert b == 8  # minor extent + 1 (9-point FEM stencil), NOT widened by B
    cb = scipy.linalg.cholesky_banded(ab, lower=True)
    factor = BandFactor(cb, jnp.float64)
    rng = np.random.default_rng(5)
    v = rng.normal(size=(3, n))
    np.testing.assert_allclose(
        np.asarray(factor.solve_L(jnp.asarray(v))),
        scipy.linalg.solve_banded((b, 0), cb, v.T).T,
        rtol=1e-12, atol=1e-13,
    )
    np.testing.assert_allclose(
        np.asarray(factor.solve(jnp.asarray(v))),
        _np_band_solve(cb, v.T).T,
        rtol=1e-10, atol=1e-12,
    )
    # jittability: the sampler's full apply compiles
    sampler = BandCholeskySampler(op)
    f = jnp.asarray(rng.normal(size=op.vshape))
    step = jax.jit(lambda k, x: sampler.apply(k, f, x))
    x = step(jax.random.PRNGKey(0), jnp.zeros((4,) + op.vshape))
    assert x.shape == (4,) + op.vshape and bool(jnp.isfinite(x).all())


def test_band_factor_recursive_doubling():
    """The recursive-doubling (parallel-prefix) substitution strategy matches
    the sequential scan and scipy to f64 round-off for several block-count /
    bandwidth shapes, including nb=1 (no levels) and non-divisible n."""
    import scipy.linalg
    from multigridmc_tpu.samplers.cholesky import BandFactor

    rng = np.random.default_rng(0)
    for n, b in [(40, 3), (65, 7), (128, 16), (30, 1), (5, 2)]:
        A = np.zeros((n, n))
        for i in range(n):
            A[i, max(0, i - b):i] = rng.uniform(-0.3, 0.3, size=min(i, b))
            A[i, i] = b + 1.0
        Q = A @ A.T
        ab = np.zeros((b + 1, n))
        for k in range(b + 1):
            ab[k, : n - k] = np.diagonal(Q, -k)
        cb = scipy.linalg.cholesky_banded(ab, lower=True)
        seq = BandFactor(cb, jnp.float64, parallel=False)
        par = BandFactor(cb, jnp.float64, parallel=True)
        v = rng.standard_normal((3, n))
        for name in ("solve_L", "solve_LT", "solve"):
            a = np.asarray(getattr(seq, name)(jnp.asarray(v)))
            c = np.asarray(getattr(par, name)(jnp.asarray(v)))
            np.testing.assert_allclose(c, a, rtol=1e-11, atol=1e-12,
                                       err_msg=f"{name} n={n} b={b}")
        np.testing.assert_allclose(
            np.asarray(par.solve_L(jnp.asarray(v))),
            scipy.linalg.solve_banded((b, 0), cb, v.T).T,
            rtol=1e-11, atol=1e-12,
        )


def test_band_factor_doubling_f32_ill_conditioned():
    """Advisor r3: the auto-enabled doubling strategy changes production
    solve numerics (explicit prefix products M^(l) can amplify rounding), and
    accuracy was only gated at f64 on well-conditioned bands.  Gate the f32
    residual ||L g - v|| / ||v|| on a production-like band: the 2d FD
    posterior precision at 32^2 (bandwidth 31, kappa^2 ~ 25 vs off-diag
    ~ -1024: locally dominant but globally ill-conditioned, cond(Q) ~ 1e4)
    and a deliberately weakly-dominant synthetic band."""
    import scipy.linalg
    from multigridmc_tpu.samplers.cholesky import BandFactor, _band_matrix_stencil

    from multigridmc_tpu.lattice import Lattice
    from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu.models.prior import shiftedlaplace_fd

    rng = np.random.default_rng(7)

    def check(cb, b, n, label, tol):
        seq = BandFactor(cb.astype(np.float32), jnp.float32, parallel=False)
        par = BandFactor(cb.astype(np.float32), jnp.float32, parallel=True)
        v = rng.standard_normal((4, n)).astype(np.float32)
        g_seq = np.asarray(seq.solve_L(jnp.asarray(v)), np.float64)
        g_par = np.asarray(par.solve_L(jnp.asarray(v)), np.float64)
        # residual of the doubling solve against the f64 band operator
        L = np.zeros((n, n))
        for k in range(b + 1):
            L[np.arange(k, n), np.arange(n - k)] = cb[k, : n - k]
        for name, g in (("seq", g_seq), ("par", g_par)):
            r = np.linalg.norm(g @ L.T - v, axis=1) / np.linalg.norm(v, axis=1)
            assert np.max(r) < tol, (label, name, np.max(r))
        # and the doubling must not be materially worse than the scan
        r_seq = np.linalg.norm(g_seq @ L.T - v) / np.linalg.norm(v)
        r_par = np.linalg.norm(g_par @ L.T - v) / np.linalg.norm(v)
        assert r_par < 50 * max(r_seq, 1e-7), (label, r_seq, r_par)

    # production-like: 32^2 FD prior precision band (the BandCholeskySampler
    # factors exactly this stencil part)
    lattice = Lattice((32, 32))
    op = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(0.2))
    ab, b = _band_matrix_stencil(op)
    cb = scipy.linalg.cholesky_banded(ab, lower=True)
    check(cb, b, ab.shape[1], "fd32", 5e-4)

    # weakly dominant synthetic band (diag barely exceeds the row sum)
    n, b2 = 96, 6
    A = np.zeros((n, n))
    for i in range(n):
        A[i, max(0, i - b2):i] = rng.uniform(-1.0, 1.0, size=min(i, b2))
        A[i, i] = 1.05 * (np.abs(A[i, max(0, i - b2):i]).sum() + 0.1)
    Q = A @ A.T
    ab2 = np.zeros((b2 + 1, n))
    for k in range(b2 + 1):
        ab2[k, : n - k] = np.diagonal(Q, -k)
    cb2 = scipy.linalg.cholesky_banded(ab2, lower=True)
    check(cb2, b2, n, "weak", 1e-3)


# ----------------------------------------------- band assembly and strategy
@pytest.mark.parametrize("shape,assemble", [
    ((16, 20), "fd"), ((16, 20), "fem"), ((6, 8, 10), "fd")], ids=["fd", "fem", "fd3d"])
def test_band_matrix_matches_dense(shape, assemble):
    """The band is assembled from the stencil planes without densifying and
    equals the lower diagonals of the dense stencil matrix."""
    from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu.models.prior import shiftedlaplace_fd
    from multigridmc_tpu.samplers.cholesky import _band_matrix_stencil

    build = shiftedlaplace_fd if assemble == "fd" else shiftedlaplace_fem
    op = build(Lattice(shape), ConstantCorrelationLengthModel(0.3))
    ab, b = _band_matrix_stencil(op)
    A = op.to_dense_stencil()
    n = A.shape[0]
    assert b == max(abs(k) for k in range(-n + 1, n) if np.any(np.diagonal(A, k)))
    for i in range(b + 1):
        np.testing.assert_array_equal(ab[i, : n - i], np.diagonal(A, -i))
        np.testing.assert_array_equal(ab[i, n - i:], 0.0)


def _band_sampler_on_gpu(monkeypatch, bytes_limit):
    from multigridmc_tpu.samplers import cholesky

    monkeypatch.setattr(cholesky, "on_accelerator", lambda: True)
    monkeypatch.setattr(cholesky, "_device_bytes_limit", lambda: bytes_limit)
    op = make_posterior_2d(32)
    return BandCholeskySampler(op)


@pytest.mark.parametrize("limit,parallel", [(2**40, True), (2**20, False)],
                         ids=["fits", "too-large"])
def test_band_doubling_follows_device_memory(monkeypatch, limit, parallel):
    """On an accelerator the doubling level tensors are built when they fit
    in an eighth of the device's memory limit (32^2 posterior: 31 blocks of
    31^2, 5 levels, about 1.2 MB)."""
    assert _band_sampler_on_gpu(monkeypatch, limit).factor.parallel is parallel


def test_band_doubling_needs_a_memory_limit(monkeypatch):
    with pytest.raises(RuntimeError, match="memory limit"):
        _band_sampler_on_gpu(monkeypatch, None)


def test_exact_posterior_sparse_solver_matches_dense():
    """Above 4096 vertices the exact diagnostics solve with a sparse LU
    factorisation; it agrees with a dense solve."""
    from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
    from multigridmc_tpu.models.posterior import (
        measurement_vector,
        observed_mean_and_variance,
        posterior_mean,
    )
    from multigridmc_tpu.models.prior import shiftedlaplace_fd

    prior = shiftedlaplace_fd(Lattice((72, 72)), ConstantCorrelationLengthModel(0.2))
    rng = np.random.default_rng(4)
    op = measured_operator(prior, MeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(3, 2)),
        mean=rng.normal(size=3), variance=1e-6 * (1 + rng.uniform(size=3))))
    assert op.lattice.nvertex > 4096
    A = prior.to_dense_stencil()

    def dense(v):
        return np.linalg.solve(A, np.asarray(v).reshape(-1)).reshape(op.vshape)

    xbar = np.zeros(op.vshape)
    y = rng.normal(size=3)
    w = measurement_vector(op.lattice, [0.5, 0.5], 0.0)
    np.testing.assert_allclose(posterior_mean(op, xbar, y),
                               posterior_mean(op, xbar, y, solve=dense),
                               rtol=1e-9, atol=1e-12)
    np.testing.assert_allclose(observed_mean_and_variance(op, xbar, y, w),
                               observed_mean_and_variance(op, xbar, y, w, solve=dense),
                               rtol=1e-9)
