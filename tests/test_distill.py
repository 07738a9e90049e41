"""Affine subtree distillation tests (multigridmc_tpu/samplers/distill.py).

The distilled map ``x = T f + S xi`` must be *distributionally identical* to
the composed sub-level recursion it replaces (the recursion is affine-Gaussian
from its zero-initialised entry state, ``multigridmc_sampler.cc:122``).  The
oracle is three-fold:

1. exact: T equals the deterministic (noise-free) subtree map - checked to
   machine precision against the composed MultigridPreconditioner recursion;
2. statistical: the empirical mean/covariance of the composed *stochastic*
   subtree matches ``(T f, S S^T)`` within Monte-Carlo tolerance;
3. end-to-end: the full MGMC sampler with distillation enabled passes the
   reference's mean/covariance gate (``test_sampler.hh:113-153``) unchanged.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import shiftedlaplace_fd
from multigridmc_tpu.samplers.distill import (
    DistilledSubtree,
    distill_subtree,
    pick_distill_level,
)
from multigridmc_tpu.samplers.mgmc import MultigridMCSampler
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner

from test_sampler import make_posterior_2d, mean_covariance_error, tier


def make_posterior(nx=16, m=4, variance=1e-3):
    lattice = Lattice((nx, nx))
    prior = shiftedlaplace_fd(lattice, ConstantCorrelationLengthModel(0.2))
    rng = np.random.default_rng(0)
    params = MeasurementParameters(
        measurement_locations=rng.uniform(0.1, 0.9, size=(m, 2)),
        mean=rng.normal(size=m),
        variance=variance * (1 + rng.uniform(size=m)),
    )
    return measured_operator(prior, params)


def test_pick_distill_level():
    op = make_posterior(nx=32)
    sampler = MultigridMCSampler(op, nlevel=4, smoother="SOR", distill=False)
    ops = sampler.hierarchy.operators
    assert [o.lattice.nvertex for o in ops] == [961, 225, 49, 9]
    assert pick_distill_level(ops) == 1  # largest sub-level within budget
    assert pick_distill_level(ops, max_n=100) == 2
    assert pick_distill_level(ops, max_n=5) is None  # nothing fits
    assert pick_distill_level(ops[:2], max_n=10**6) is None  # only coarsest


@pytest.mark.parametrize("smoother,cycle", [("SOR", 2), ("SSOR", 1)])
def test_distilled_T_matches_deterministic_subtree(smoother, cycle):
    """T is the exact noise-free subtree map: machine-precision agreement
    with the composed deterministic recursion (MultigridPreconditioner), and
    the noise=True propagation leaves T untouched (f-basis rows never see
    noise injections)."""
    op = make_posterior()
    pc = MultigridPreconditioner(op, nlevel=3, smoother=smoother, cycle=cycle,
                                 distill=False)
    li = pick_distill_level(pc.hierarchy.operators)
    assert li == 1
    args = (pc.hierarchy.operators[li:], pc.presmoothers[li:],
            pc.postsmoothers[li:], pc.coarse_solver, pc.cycle,
            pc.coarse_scaling)
    det = distill_subtree(*args, noise=False)
    assert det.S_T is None
    cop = pc.hierarchy.operators[li]
    rng = np.random.default_rng(3)
    b = jnp.asarray(rng.normal(size=(3,) + cop.vshape))
    err = float(jnp.max(jnp.abs(pc._solve(li, b) - det.solve(b))))
    assert err < 1e-12, err

    # stochastic distillation from the sampler shares the identical T
    s = MultigridMCSampler(op, nlevel=3, smoother=smoother, cycle=cycle,
                           distill=False)
    sto = distill_subtree(s.hierarchy.operators[li:], s.presamplers[li:],
                          s.postsamplers[li:], s.coarse_sampler, s.cycle,
                          s.coarse_scaling, noise=True)
    # the two specs differ only in the coarse-solve code path (sampler
    # triangular solves vs solver cho_solve) - one-ulp rounding allowed
    assert float(jnp.max(jnp.abs(sto.Tm - det.Tm))) < 1e-14


def test_distilled_subtree_moments():
    """Empirical mean/covariance of the composed stochastic subtree match
    (T f, S S^T) within Monte-Carlo tolerance - the direct distributional
    identity the distillation claims."""
    op = make_posterior()
    s = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=2, distill=False)
    li = 1
    d = distill_subtree(s.hierarchy.operators[li:], s.presamplers[li:],
                        s.postsamplers[li:], s.coarse_sampler, s.cycle,
                        s.coarse_scaling, noise=True)
    cop = s.hierarchy.operators[li]
    n = cop.lattice.nvertex
    assert d.info["n"] == n and d.info["K"] > n
    rng = np.random.default_rng(11)
    f = jnp.asarray(rng.normal(size=cop.vshape))
    nbatch, nrep = 500, 200  # 100k draws

    @jax.jit
    def draw(key):
        ff = jnp.broadcast_to(f, (nbatch,) + cop.vshape)
        return s._sample(li, key, ff, jnp.zeros_like(ff)).reshape(nbatch, n)

    outs = np.concatenate(
        [np.asarray(draw(jax.random.PRNGKey(i))) for i in range(nrep)]
    )
    nsamp = outs.shape[0]
    emp_mean = outs.mean(axis=0)
    emp_cov = np.cov(outs.T)
    Tf = np.asarray(jnp.tensordot(f.reshape(-1), d.Tm, axes=([0], [0])))
    C = np.asarray(d.S_T, dtype=np.float64).T @ np.asarray(d.S_T, np.float64)
    sd = np.sqrt(np.diag(C))
    # mean: componentwise z-scores (max over n=49 components -> allow 5 sigma)
    z = np.max(np.abs(emp_mean - Tf) / (sd / np.sqrt(nsamp)))
    assert z < 5.0, z
    # covariance: max-entry error within ~6x the per-entry MC sigma
    cov_err = np.max(np.abs(emp_cov - C)) / np.max(np.abs(C))
    assert cov_err < 6.0 / np.sqrt(nsamp), cov_err


def test_multigridmc_distilled_statistical_gate():
    """End-to-end: the flagship MGMC sampler with the distilled subtree active
    passes the reference mean/covariance oracle (``test_sampler.hh:113-153``)
    - same fixture and budget as test_multigridmc_sampler_2d."""
    op = make_posterior_2d(8)
    sampler = MultigridMCSampler(
        op, nlevel=3, smoother="SSOR", coarse_solver="Cholesky", omega=1.0,
        cycle=2, distill=True,
    )
    assert sampler.distilled is not None and sampler.distill_level == 1
    nchains, nsteps, tol = tier(1024, 400, 4e-3)
    em, ec = mean_covariance_error(op, sampler, nchains=nchains, nwarmup=20,
                                   nsteps=nsteps)
    assert em < tol and ec < tol, (em, ec)


def test_distilled_preconditioner_in_solver():
    """The distilled deterministic subtree leaves the multigrid-preconditioned
    Richardson solver's iterates bitwise-stable (batched rhs path) and the
    solver still converges to the reference gate."""
    from multigridmc_tpu.solvers.loop import IterativeSolverParameters, LoopSolver

    op = make_posterior()
    pc_off = MultigridPreconditioner(op, nlevel=3, smoother="SOR", cycle=2,
                                     distill=False)
    pc_on = MultigridPreconditioner(op, nlevel=3, smoother="SOR", cycle=2,
                                    distill=True)
    assert pc_on.distilled is not None
    rng = np.random.default_rng(5)
    b = jnp.asarray(rng.normal(size=(4,) + op.vshape))
    err = float(jnp.max(jnp.abs(pc_off.apply(b) - pc_on.apply(b))))
    assert err < 1e-12, err

    solver = LoopSolver(
        op, pc_on, IterativeSolverParameters(rtol=1e-12, atol=1e-9, maxiter=100)
    )
    res = solver.solve(b)
    assert res.converged, res.rnorm


# ------------------------------------------------ engine choice and precision
def _on_one_gpu(monkeypatch):
    """Let the auto gates see an accelerator."""
    from multigridmc_tpu.samplers import mgmc
    from multigridmc_tpu.solvers import multigrid

    monkeypatch.setattr(mgmc, "on_accelerator", lambda: True)
    monkeypatch.setattr(multigrid, "on_accelerator", lambda: True)


def test_distill_auto_is_off_on_cpu():
    op = make_posterior()
    assert MultigridMCSampler(op, nlevel=4, smoother="SOR").distilled is None
    assert MultigridPreconditioner(op, nlevel=4, smoother="SOR").distilled is None


def test_distill_default_precision_on_gpu_is_highest(monkeypatch):
    """On one GPU the auto gate distils the subtree, and its matmuls default
    to HIGHEST: the lower tiers run TF32 there and their bias is unchecked."""
    _on_one_gpu(monkeypatch)
    sampler = MultigridMCSampler(make_posterior(), nlevel=4, smoother="SOR")
    assert sampler.distilled is not None
    assert sampler.distilled.precision == jax.lax.Precision.HIGHEST


def test_preconditioner_auto_distills_on_gpu(monkeypatch):
    _on_one_gpu(monkeypatch)
    pc = MultigridPreconditioner(make_posterior(), nlevel=4, smoother="SOR")
    assert pc.distilled is not None
    assert pc.distilled.precision == jax.lax.Precision.HIGHEST


@pytest.mark.parametrize("tier,expected", [
    ("highest", jax.lax.Precision.HIGHEST),
    ("high", jax.lax.Precision.HIGH),
    ("default", jax.lax.Precision.DEFAULT),
])
def test_distill_precision_tiers(monkeypatch, tier, expected):
    """An explicit tier reaches the distilled map."""
    _on_one_gpu(monkeypatch)
    sampler = MultigridMCSampler(make_posterior(), nlevel=4, smoother="SOR",
                                 distill_precision=tier)
    assert sampler.distilled.precision == expected


def test_distill_precision_invalid_tier():
    from multigridmc_tpu.samplers.distill import resolve_precision

    with pytest.raises(ValueError, match="invalid distill precision"):
        resolve_precision("bf16")


def test_config_without_distill_precision_is_highest(tmp_path):
    """A config that names no tier gets HIGHEST, whatever the environment."""
    from multigridmc_tpu.utils.config import load_config

    cfg = tmp_path / "p.cfg"
    cfg.write_text('multigrid = { nlevel = 4; cycle = 2; };\n')
    config = load_config(cfg)
    assert config.multigrid.distill_precision is None
    sampler = MultigridMCSampler(make_posterior(), nlevel=config.multigrid.nlevel,
                                 smoother="SOR", distill=True,
                                 distill_precision=config.multigrid.distill_precision)
    assert sampler.distilled.precision == jax.lax.Precision.HIGHEST
