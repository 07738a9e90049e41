"""Full-cycle explicit-halo distributed MGMC tests (parallel/cycle.py).

Three-layer validation of the production multi-chip path:

1. deterministic mode (noise off) against the single-device
   MultigridPreconditioner on the unpadded operator - exact up to fp roundoff,
   proving the padded layout, halo exchange, psum Woodbury, restriction,
   prolongation, and agglomerated coarse solve all match;
2. bitwise-trajectory equivalence between a 1-device mesh and an 8-device
   (2 chains x 2 x 2 lattice) mesh in "global" noise mode - proving the
   distributed execution is numerically identical to the replicated one;
3. statistical mean/covariance oracle vs the dense inverse in "sharded"
   (production per-shard PRNG) mode - proving the distributed sampler targets
   the exact posterior (test_sampler.hh:113-153 oracle).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
from jax.sharding import Mesh

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import PeriodicCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import (
    shiftedlaplace_fd,
    shiftedlaplace_fem,
    squared_shiftedlaplace_fd,
)
from multigridmc_tpu.parallel.cycle import (
    ShardedMGMCSampler,
    pad_field,
    unpad_field,
)
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner


def make_posterior(nx=16, prior_kind="fd"):
    lattice = Lattice((nx, nx))
    if prior_kind == "biharm":
        from multigridmc_tpu.models.correlation import (
            ConstantCorrelationLengthModel,
        )

        prior = squared_shiftedlaplace_fd(
            lattice, ConstantCorrelationLengthModel(1.0)
        )
    else:
        model = PeriodicCorrelationLengthModel(Lambda_min=1.2, Lambda_max=2.3)
        assemble = shiftedlaplace_fem if prior_kind == "fem" else shiftedlaplace_fd
        prior = assemble(lattice, model)
    rng = np.random.default_rng(1212417)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.2, 0.8, size=(4, 2)),
        mean=np.zeros(4),
        variance=1.0 + 2.0 * rng.uniform(size=4),
    )
    return measured_operator(prior, params)


def lattice_mesh_2d(ly, lx, chains=None):
    n = ly * lx * (chains or 1)
    devs = np.asarray(jax.devices()[:n])
    if chains:
        return Mesh(devs.reshape(chains, ly, lx), ("chains", "ly", "lx"))
    return Mesh(devs.reshape(ly, lx), ("ly", "lx"))


@pytest.mark.parametrize(
    "prior_kind", ["fd", "fem", "biharm"], ids=["fd5pt", "fem9pt", "biharm13pt"]
)
@pytest.mark.parametrize("cycle", [1, 2], ids=["V", "W"])
def test_deterministic_cycle_matches_preconditioner(prior_kind, cycle):
    """Sharded deterministic cycle == single-device MultigridPreconditioner -
    incl. the 13-point biharmonic stencil whose sweeps/residual need width-2
    halos (squared_shiftedlaplace_fd_operator.cc:58-94)."""
    op = make_posterior(nx=16, prior_kind=prior_kind)
    mesh = lattice_mesh_2d(2, 2)
    sh = ShardedMGMCSampler(
        op, nlevel=3, mesh=mesh, smoother="SOR", cycle=cycle,
        agglomerate_below=4, deterministic=True,
    )
    ref = MultigridPreconditioner(op, nlevel=3, smoother="SOR", cycle=cycle)
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.normal(size=op.vshape))
    bp = pad_field(b, op.vshape)
    xp = jnp.zeros_like(bp)
    out = sh.apply(jax.random.PRNGKey(0), bp, xp)
    out_valid = unpad_field(out, op.vshape)
    expected = ref.apply(b)
    np.testing.assert_allclose(
        np.asarray(out_valid), np.asarray(expected), rtol=1e-11, atol=1e-12
    )
    # padding stays exactly zero
    pad_mask = np.ones(tuple(m + 1 for m in op.vshape), dtype=bool)
    pad_mask[tuple(slice(0, m) for m in op.vshape)] = False
    assert float(jnp.abs(jnp.asarray(np.asarray(out)[..., pad_mask])).max()) == 0.0


@pytest.mark.parametrize("prior_kind", ["fd", "biharm"], ids=["fd5pt", "biharm13pt"])
def test_global_noise_mesh_equivalence(prior_kind):
    """Identical trajectories on a 1-device mesh and an 8-device composite
    chains x lattice mesh under 'global' noise (the dryrun_multichip assert);
    the biharmonic case runs the stochastic sweeps across width-2 halos."""
    op = make_posterior(nx=16, prior_kind=prior_kind)
    kwargs = dict(
        nlevel=3, smoother="SOR", cycle=2, agglomerate_below=4,
        noise_mode="global",
    )
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1), ("chains", "ly", "lx"))
    mesh8 = lattice_mesh_2d(2, 2, chains=2)
    s1 = ShardedMGMCSampler(op, mesh=mesh1, **kwargs)
    s8 = ShardedMGMCSampler(op, mesh=mesh8, **kwargs)

    rng = np.random.default_rng(4)
    nchains = 4
    f = pad_field(jnp.asarray(rng.normal(size=op.vshape)), op.vshape)
    x = pad_field(
        jnp.asarray(rng.normal(size=(nchains,) + op.vshape)), op.vshape
    )
    key = jax.random.PRNGKey(7)
    y1, y8 = x, x
    for step in range(3):
        k = jax.random.fold_in(key, step)
        y1 = s1.apply(k, f, y1)
        y8 = s8.apply(k, f, y8)
    np.testing.assert_allclose(
        np.asarray(y1), np.asarray(y8), rtol=1e-10, atol=1e-11
    )


def test_replicated_finest_fallback():
    """A mesh whose lattice axes leave the finest level unshardable must run
    fully REPLICATED over the lattice (with a warning) and still match the
    1-device trajectory - not crash with a shard_map shape mismatch
    (round-5 review finding)."""
    import warnings

    op = make_posterior(nx=16, prior_kind="fd")
    kwargs = dict(nlevel=2, smoother="SOR", cycle=1, noise_mode="global")
    mesh1 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1, 1),
                 ("chains", "ly", "lx"))
    # 16-padded extents over a 4-way ly axis leave 4-row blocks; a threshold
    # above that forces even level 0 replicated
    mesh8 = lattice_mesh_2d(4, 2, chains=1)
    s1 = ShardedMGMCSampler(op, mesh=mesh1, agglomerate_below=4, **kwargs)
    with warnings.catch_warnings(record=True) as w:
        warnings.simplefilter("always")
        s8 = ShardedMGMCSampler(op, mesh=mesh8, agglomerate_below=64,
                                **kwargs)
    assert any("REPLICATED" in str(wi.message) for wi in w)
    assert not s8.levels[0].sharded

    rng = np.random.default_rng(9)
    nchains = 2
    f = pad_field(jnp.asarray(rng.normal(size=op.vshape)), op.vshape)
    x = pad_field(jnp.asarray(rng.normal(size=(nchains,) + op.vshape)),
                  op.vshape)
    key = jax.random.PRNGKey(3)
    y1 = s1.apply(key, f, x)
    y8 = s8.apply(key, f, x)
    np.testing.assert_allclose(np.asarray(y1), np.asarray(y8),
                               rtol=1e-10, atol=1e-11)


def test_sharded_sampler_statistics():
    """Production mode (per-shard PRNG): chain mean vs Q^{-1} f and sample
    covariance vs Q^{-1} on the full 8-device mesh."""
    op = make_posterior(nx=8)
    mesh = lattice_mesh_2d(2, 2, chains=2)
    sampler = ShardedMGMCSampler(
        op, nlevel=2, mesh=mesh, smoother="SSOR", cycle=1,
        agglomerate_below=2, noise_mode="sharded",
    )
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    fp = pad_field(f, op.vshape)
    nchains, nwarmup, nsteps = 512, 25, 150
    x = jnp.zeros((nchains,) + tuple(m + 1 for m in op.vshape))
    key = jax.random.PRNGKey(99)

    vsel = np.ones(tuple(m + 1 for m in op.vshape), dtype=bool)
    vsel[-1, :] = False
    vsel[:, -1] = False

    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    for i in range(nwarmup):
        x = sampler.apply(jax.random.fold_in(key, i), fp, x)
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, nwarmup + i), fp, x)
        xf = np.asarray(x)[:, vsel]
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - cov_exact))
    assert em < 6e-3 and ec < 6e-3, (em, ec)


def test_sharded_sampler_statistics_wcycle_16():
    """Scaled production-mode gate (round-2 review item 7): sharded-noise
    W-cycle SOR at 16^2 with nlevel 3, crossing a sharded -> replicated
    agglomeration transition on the full 8-device mesh; mean vs Q^{-1} f and
    covariance vs Q^{-1} (test_sampler.hh:113-153 oracle)."""
    import os

    thorough = os.environ.get("MGMC_THOROUGH", "0") == "1"
    op = make_posterior(nx=16)
    mesh = lattice_mesh_2d(2, 2, chains=2)
    sampler = ShardedMGMCSampler(
        op, nlevel=3, mesh=mesh, smoother="SOR", cycle=2,
        agglomerate_below=4, noise_mode="sharded",
    )
    # L0 (16-padded) and L1 (8-padded) are lattice-sharded, L2 is replicated:
    # the cycle crosses the agglomeration transition every descent
    assert [lv.sharded for lv in sampler.levels] == [True, True, False]
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    fp = pad_field(f, op.vshape)
    nchains, nwarmup, nsteps = (1024, 50, 300) if thorough else (512, 40, 150)
    tol = 8e-3 if thorough else 1.2e-2
    x = jnp.zeros((nchains,) + tuple(m + 1 for m in op.vshape))
    key = jax.random.PRNGKey(77)

    vsel = np.ones(tuple(m + 1 for m in op.vshape), dtype=bool)
    vsel[-1, :] = False
    vsel[:, -1] = False

    @jax.jit
    def warm(x, key):
        def body(i, x):
            return sampler._apply(
                jax.random.fold_in(key, i), fp, x, chains_total=nchains)
        return jax.lax.fori_loop(0, nwarmup, body, x)

    x = warm(x, jax.random.fold_in(key, 0))
    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, 1 + i), fp, x)
        xf = np.asarray(x)[:, vsel]
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - cov_exact))
    assert em < tol and ec < tol, (em, ec)


def test_sharded_sampler_statistics_biharmonic():
    """Production sharded-noise mode through width-2 halos: the 13-point
    biharmonic posterior on a 2x2 lattice mesh, mean/cov vs the dense
    inverse."""
    op = make_posterior(nx=8, prior_kind="biharm")
    mesh = lattice_mesh_2d(2, 2, chains=2)
    sampler = ShardedMGMCSampler(
        op, nlevel=2, mesh=mesh, smoother="SSOR", cycle=1,
        agglomerate_below=2, noise_mode="sharded",
    )
    n = op.lattice.nvertex
    rng = np.random.default_rng(24601)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    fp = pad_field(f, op.vshape)
    nchains, nwarmup, nsteps = 512, 30, 120
    x = jnp.zeros((nchains,) + tuple(m + 1 for m in op.vshape))
    key = jax.random.PRNGKey(31)
    vsel = np.ones(tuple(m + 1 for m in op.vshape), dtype=bool)
    vsel[-1, :] = False
    vsel[:, -1] = False
    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    for i in range(nwarmup):
        x = sampler.apply(jax.random.fold_in(key, i), fp, x)
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, nwarmup + i), fp, x)
        xf = np.asarray(x)[:, vsel]
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - cov_exact))
    assert em < 2e-2 and ec < 2e-2, (em, ec)


def test_sharded_distilled_subtree_statistics():
    """With the replicated coarse subtree swapped for its
    distilled affine-Gaussian map (distill=True forces past the CPU auto
    gate), the production sharded-noise W-cycle still targets the exact
    posterior.  Level 1 is replicated (agglomerate_below=8) and is the
    distill level; the global-noise and deterministic modes must stay
    undistilled (bitwise mesh-equivalence contract)."""
    op = make_posterior(nx=16)
    mesh = lattice_mesh_2d(2, 2, chains=2)
    sampler = ShardedMGMCSampler(
        op, nlevel=3, mesh=mesh, smoother="SOR", cycle=2,
        agglomerate_below=8, noise_mode="sharded", distill=True,
    )
    assert [lv.sharded for lv in sampler.levels] == [True, False, False]
    assert sampler.distill_level == 1 and sampler.distilled is not None
    # composed sub-level recursion is gone: the map IS the subtree
    assert "distill_Tm" in sampler.levels[1].arrays

    for kwargs in (dict(noise_mode="global", distill=True),
                   dict(noise_mode="sharded", distill=True,
                        deterministic=True)):
        s2 = ShardedMGMCSampler(
            op, nlevel=3, mesh=mesh, smoother="SOR", cycle=2,
            agglomerate_below=8, **kwargs)
        assert s2.distilled is None

    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.lattice.vshape))
    cov_exact = np.linalg.inv(Q)

    fp = pad_field(f, op.vshape)
    nchains, nwarmup, nsteps = 512, 40, 150
    x = jnp.zeros((nchains,) + tuple(m + 1 for m in op.vshape))
    key = jax.random.PRNGKey(55)
    vsel = np.ones(tuple(m + 1 for m in op.vshape), dtype=bool)
    vsel[-1, :] = False
    vsel[:, -1] = False

    @jax.jit
    def warm(x, key):
        def body(i, x):
            return sampler._apply(
                jax.random.fold_in(key, i), fp, x, chains_total=nchains)
        return jax.lax.fori_loop(0, nwarmup, body, x)

    x = warm(x, jax.random.fold_in(key, 0))
    sx = np.zeros(n)
    sxx = np.zeros((n, n))
    for i in range(nsteps):
        x = sampler.apply(jax.random.fold_in(key, 1 + i), fp, x)
        xf = np.asarray(x)[:, vsel]
        sx += xf.sum(axis=0)
        sxx += xf.T @ xf
    total = nchains * nsteps
    Ex = sx / total
    cov = sxx / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - cov_exact))
    assert em < 1.2e-2 and ec < 1.2e-2, (em, ec)
