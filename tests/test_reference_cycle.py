"""The composed multigrid cycle against the float64 host reference.

``multigridmc_tpu.reference`` rebuilds every building block of a level visit
from its matrix definition - the stencil as a sparse matrix (checked against
``op.to_dense()``), the colour masks, the banded transfer matrices (checked
against ``restrict``/``prolongate``), Galerkin triple products and the
Woodbury factor.  Each case runs the program's composed XLA path with noise
off and compares it with the reference:

    descend visit: sweep -> Woodbury -> r = f - A x -> restrict
    ascend visit:  prolongate_add -> sweep -> Woodbury

for priors and posteriors, shared and batched right-hand sides, odd chain
counts, 2d and 3d, SOR and SSOR, FD, FEM and biharmonic stencils, point
measurements, and the full W-cycle of the preconditioner and of the MGMC
sampler.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from multigridmc_tpu import reference as ref
from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.models.correlation import ConstantCorrelationLengthModel
from multigridmc_tpu.models.posterior import MeasurementParameters, measured_operator
from multigridmc_tpu.models.prior import (
    shiftedlaplace_fd,
    shiftedlaplace_fem,
    squared_shiftedlaplace_fd,
)
from multigridmc_tpu.ops.coarsen import galerkin_coarsen
from multigridmc_tpu.ops.coloring import coloring_for
from multigridmc_tpu.ops.intergrid import prolongate, prolongate_add, restrict
from multigridmc_tpu.smoothers import (
    BACKWARD,
    FORWARD,
    SORSmoother,
    SSORSmoother,
    color_order,
    compute_B_bar,
    sor_sweep,
)
from multigridmc_tpu.solvers.multigrid import MultigridPreconditioner

RTOL = 1e-10


def _operator(shape=(24, 24), lowrank=True, assemble=shiftedlaplace_fd,
              variance_scale=None, seed=5):
    op = assemble(Lattice(shape), ConstantCorrelationLengthModel(0.3))
    if lowrank:
        rng = np.random.default_rng(seed)
        m = 4
        variance = (variance_scale * (1.0 + rng.uniform(size=m)) if variance_scale
                    else 0.5 + rng.uniform(size=m))
        op = measured_operator(op, MeasurementParameters(
            measurement_locations=rng.uniform(0.1, 0.9, size=(m, len(shape))),
            mean=rng.normal(size=m), variance=variance))
    return op


def _flat(a, batch):
    return np.asarray(a, dtype=np.float64).reshape(batch, -1)


def _close(got, exp, rtol=RTOL):
    got = np.asarray(got, dtype=np.float64).reshape(np.shape(exp))
    scale = max(float(np.max(np.abs(exp))), 1.0)
    assert float(np.max(np.abs(got - exp))) <= rtol * scale


def _descend(op, f, x, omega=1.0, smoother=None):
    """Program: pre-sweep, residual, restriction."""
    smoother = smoother or SORSmoother(op, omega, 1, FORWARD)
    x1 = smoother.apply(f, x)
    return x1, restrict(f - op.apply(x1), dim=op.lattice.dim)


def _ref_descend(level, f, x, omega=1.0, ssor=False):
    x1 = (ref.ssor(level, f, x, omega) if ssor
          else ref.smooth(level, f, x, omega, ref.FORWARD))
    r = f - level.apply(x1)
    return x1, (ref.restriction_matrix(level.vshape) @ r.T).T


def _ref_ascend(level, f, x, xc, omega, gamma, ssor=False):
    x = x + gamma * (ref.restriction_matrix(level.vshape).T @ xc.T).T
    return (ref.ssor(level, f, x, omega) if ssor
            else ref.smooth(level, f, x, omega, ref.BACKWARD))


def _fields(op, C, f_batched=False, seed=1):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=((C,) if f_batched else ()) + op.vshape)
    x = rng.normal(size=(C,) + op.vshape)
    return f, x


# ------------------------------------------------------------ reference pieces
@pytest.mark.parametrize("case", ["fd", "fem", "biharmonic", "fd3d"])
def test_stencil_matrix_matches_dense(case):
    assemble, shape = {
        "fd": (shiftedlaplace_fd, (12, 14)),
        "fem": (shiftedlaplace_fem, (12, 14)),
        "biharmonic": (squared_shiftedlaplace_fd, (12, 14)),
        "fd3d": (shiftedlaplace_fd, (6, 8, 10)),
    }[case]
    op = _operator(shape, assemble=assemble)
    np.testing.assert_allclose(ref.stencil_matrix(op).toarray(),
                               op.to_dense_stencil(), rtol=0, atol=1e-12)
    np.testing.assert_allclose(ref.level_of(op).dense(), op.to_dense(),
                               rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("shape", [(13, 17), (9, 11, 13)], ids=["2d", "3d"])
def test_restriction_matrix_matches_transfers(shape):
    rng = np.random.default_rng(2)
    R = ref.restriction_matrix(shape)
    x = rng.normal(size=(3,) + shape)
    _close(restrict(jnp.asarray(x), dim=len(shape)), (R @ _flat(x, 3).T).T)
    xc = rng.normal(size=(3,) + tuple(m // 2 for m in shape))
    _close(prolongate(jnp.asarray(xc), shape), (R.T @ _flat(xc, 3).T).T)


@pytest.mark.parametrize("assemble", [shiftedlaplace_fd, shiftedlaplace_fem],
                         ids=["fd", "fem"])
def test_galerkin_hierarchy_matches_reference(assemble):
    op = _operator((16, 16), assemble=assemble)
    coarse = galerkin_coarsen(op)
    levels = ref.hierarchy(op, 2, [op.offsets, coarse.offsets])
    np.testing.assert_allclose(levels[1].A.toarray(), coarse.to_dense_stencil(),
                               rtol=1e-12, atol=1e-12)
    np.testing.assert_allclose(levels[1].B, _flat(coarse.lowrank.B, 4),
                               rtol=1e-12, atol=1e-14)


@pytest.mark.parametrize("direction", [FORWARD, BACKWARD])
def test_woodbury_factor_matches_reference(direction):
    op = _operator()
    sm = SORSmoother(op, 0.9, 1, direction)
    exp = ref.woodbury_factor(ref.level_of(op), 0.9, direction)
    _close(compute_B_bar(op, sm.masks, 0.9, sm.order), exp)


# -------------------------------------------------------------------- sweeps
@pytest.mark.parametrize("assemble", [shiftedlaplace_fd, shiftedlaplace_fem],
                         ids=["fd5pt", "fem9pt"])
@pytest.mark.parametrize("direction", [FORWARD, BACKWARD])
def test_sweep_matches_reference(assemble, direction):
    op = _operator(lowrank=False, assemble=assemble)
    coloring = coloring_for(op.offsets, op.vshape)
    masks = jnp.asarray(coloring.masks())
    order = color_order(coloring.n_colors, direction)
    b, x = _fields(op, 4, f_batched=True)
    got = sor_sweep(op, masks, 0.9, order, jnp.asarray(b), jnp.asarray(x))
    exp = ref.sor_sweep(ref.level_of(op), _flat(b, 4), _flat(x, 4), 0.9, direction)
    _close(got, exp)


def test_sweep_3d_matches_reference():
    op = _operator((8, 10, 12), lowrank=False)
    coloring = coloring_for(op.offsets, op.vshape)
    b, x = _fields(op, 2, f_batched=True)
    got = sor_sweep(op, jnp.asarray(coloring.masks()), 1.0,
                    color_order(coloring.n_colors, FORWARD), jnp.asarray(b), jnp.asarray(x))
    exp = ref.sor_sweep(ref.level_of(op), _flat(b, 2), _flat(x, 2), 1.0, ref.FORWARD)
    _close(got, exp)


def test_batched_sweep_matches_single():
    """Chains stepped in one batched sweep equal chains swept one by one."""
    op = _operator(lowrank=True)
    sm = SORSmoother(op, 1.0, 1, FORWARD)
    b, x = _fields(op, 8, f_batched=True)
    out = np.asarray(sm.apply(jnp.asarray(b), jnp.asarray(x)))
    for c in range(8):
        np.testing.assert_allclose(
            out[c], np.asarray(sm.apply(jnp.asarray(b[c]), jnp.asarray(x[c]))),
            rtol=1e-12, atol=1e-12)


# -------------------------------------------------------------------- visits
@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
@pytest.mark.parametrize("f_batched", [False, True], ids=["fshared", "fbatched"])
def test_descend_visit_matches_reference(lowrank, f_batched):
    op = _operator(lowrank=lowrank)
    f, x = _fields(op, 4, f_batched)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x))
    fr = np.broadcast_to(f, x.shape)
    ex1, efc = _ref_descend(ref.level_of(op), _flat(fr, 4), _flat(x, 4))
    _close(x1, ex1)
    _close(fc, efc)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_ascend_visit_matches_reference(lowrank):
    op = _operator(lowrank=lowrank)
    f, x = _fields(op, 4, seed=2)
    xc = np.random.default_rng(3).normal(size=(4,) + tuple(m // 2 for m in op.vshape))
    post = SORSmoother(op, 0.9, 1, BACKWARD)
    got = post.apply(jnp.asarray(f),
                     prolongate_add(0.75, jnp.asarray(xc), jnp.asarray(x), dim=2))
    exp = _ref_ascend(ref.level_of(op), _flat(np.broadcast_to(f, x.shape), 4),
                      _flat(x, 4), _flat(xc, 4), 0.9, 0.75)
    _close(got, exp)


def test_descend_visit_odd_chain_count():
    op = _operator(lowrank=False)
    f, x = _fields(op, 3, seed=3)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x))
    ex1, efc = _ref_descend(ref.level_of(op), _flat(np.broadcast_to(f, x.shape), 3),
                            _flat(x, 3))
    _close(x1, ex1)
    _close(fc, efc)


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_visits_3d_match_reference(lowrank):
    op = _operator((10, 12, 14), lowrank=lowrank, seed=21)
    f, x = _fields(op, 4, seed=4)
    level = ref.level_of(op)
    fr = _flat(np.broadcast_to(f, x.shape), 4)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x))
    ex1, efc = _ref_descend(level, fr, _flat(x, 4))
    _close(x1, ex1)
    _close(fc, efc)
    xc = np.random.default_rng(5).normal(size=(4,) + tuple(m // 2 for m in op.vshape))
    got = SORSmoother(op, 1.0, 1, BACKWARD).apply(
        jnp.asarray(f), prolongate_add(0.5, jnp.asarray(xc), jnp.asarray(x), dim=3))
    _close(got, _ref_ascend(level, fr, _flat(x, 4), _flat(xc, 4), 1.0, 0.5))


@pytest.mark.parametrize("lowrank", [False, True], ids=["prior", "posterior"])
def test_ssor_visits_match_reference(lowrank):
    op = _operator(lowrank=lowrank)
    f, x = _fields(op, 4, seed=9)
    level = ref.level_of(op)
    fr = _flat(np.broadcast_to(f, x.shape), 4)
    ssor = SSORSmoother(op, 0.9, 1)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x), smoother=ssor)
    ex1, efc = _ref_descend(level, fr, _flat(x, 4), 0.9, ssor=True)
    _close(x1, ex1)
    _close(fc, efc)
    xc = np.random.default_rng(10).normal(size=(4,) + tuple(m // 2 for m in op.vshape))
    got = ssor.apply(jnp.asarray(f),
                     prolongate_add(0.75, jnp.asarray(xc), jnp.asarray(x), dim=2))
    _close(got, _ref_ascend(level, fr, _flat(x, 4), _flat(xc, 4), 0.9, 0.75, ssor=True))


def test_biharmonic_visits_match_reference():
    """13-point biharmonic stencil (width-2 offsets, 5 colours)."""
    op = _operator(assemble=squared_shiftedlaplace_fd)
    assert coloring_for(op.offsets, op.vshape).n_colors == 5
    f, x = _fields(op, 4, seed=11)
    level = ref.level_of(op)
    fr = _flat(np.broadcast_to(f, x.shape), 4)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x))
    ex1, efc = _ref_descend(level, fr, _flat(x, 4))
    _close(x1, ex1)
    _close(fc, efc)
    xc = np.random.default_rng(12).normal(size=(4,) + tuple(m // 2 for m in op.vshape))
    got = SORSmoother(op, 1.0, 1, BACKWARD).apply(
        jnp.asarray(f), prolongate_add(0.75, jnp.asarray(xc), jnp.asarray(x), dim=2))
    _close(got, _ref_ascend(level, fr, _flat(x, 4), _flat(xc, 4), 1.0, 0.75))


@pytest.mark.parametrize("shape", [(24, 24), (10, 12, 14)], ids=["2d", "3d"])
def test_point_measurement_visits_match_reference(shape):
    """Point measurements with the flagship's variances (about 1e-6): one-hot
    measurement columns and a Woodbury correction that nearly projects out
    the measured directions."""
    op = _operator(shape, variance_scale=1e-6, seed=31)
    B = np.asarray(op.lowrank.B).reshape(op.m_lowrank, -1)
    assert np.all(np.count_nonzero(B, axis=1) == 1)
    f, x = _fields(op, 4, seed=13)
    x1, fc = _descend(op, jnp.asarray(f), jnp.asarray(x))
    ex1, efc = _ref_descend(ref.level_of(op), _flat(np.broadcast_to(f, x.shape), 4),
                            _flat(x, 4))
    _close(x1, ex1, 1e-8)
    _close(fc, efc, 1e-8)


# --------------------------------------------------------------- full cycles
@pytest.mark.parametrize("batch", [(), (4,), (2, 2)], ids=["single", "batched", "2d-batch"])
def test_preconditioner_matches_reference(batch):
    op = _operator((32, 32))
    pc = MultigridPreconditioner(op, nlevel=3, smoother="SOR", cycle=2,
                                 coarse_scaling=0.75, distill=False)
    b = np.random.default_rng(6).normal(size=batch + op.vshape)
    k = int(np.prod(batch))
    levels = ref.hierarchy(op, 3, [o.offsets for o in pc.hierarchy.operators])
    exp = ref.multigrid_cycle(levels, _flat(b, k), cycle=2, coarse_scaling=0.75)
    _close(pc.apply(jnp.asarray(b)), exp)


def test_preconditioner_3d_matches_reference():
    op = _operator((16, 16, 16), seed=31)
    pc = MultigridPreconditioner(op, nlevel=3, smoother="SOR", cycle=2,
                                 coarse_scaling=0.75, distill=False)
    b = np.random.default_rng(8).normal(size=(3,) + op.vshape)
    levels = ref.hierarchy(op, 3, [o.offsets for o in pc.hierarchy.operators])
    exp = ref.multigrid_cycle(levels, _flat(b, 3), cycle=2, coarse_scaling=0.75)
    _close(pc.apply(jnp.asarray(b)), exp)


def test_mgmc_noise_free_cycle_matches_reference():
    """The MGMC sampler's recursion with its noise switched off (Gibbs rhs
    c = f, coarse sample replaced by the exact solve) is the deterministic
    W-cycle: from x = 0 it equals the reference cycle."""
    from multigridmc_tpu.samplers.mgmc import MultigridMCSampler

    op = _operator((32, 32))
    s = MultigridMCSampler(op, nlevel=3, smoother="SSOR", cycle=2,
                           coarse_scaling=0.75, distill=False)

    class ExactCoarse:
        def __init__(self, inner):
            self.inner = inner

        def apply(self, key, fc, xc):
            n = int(np.prod(fc.shape[-2:]))
            g = self.inner._solve_L(fc.reshape(fc.shape[:-2] + (n,)))
            return self.inner._solve_LT(g).reshape(fc.shape)

    s.coarse_sampler = ExactCoarse(s.coarse_sampler)
    for sampler in s.presamplers + s.postsamplers:
        for directed in (sampler.forward, sampler.backward):
            directed.random_rhs = lambda key, f_, x_: jnp.broadcast_to(f_, x_.shape)
    f = np.random.default_rng(14).normal(size=(3,) + op.vshape)
    got = s.apply(jax.random.key(0), jnp.asarray(f), jnp.zeros((3,) + op.vshape))
    levels = ref.hierarchy(op, 3, [o.offsets for o in s.hierarchy.operators])
    exp = ref.multigrid_cycle(levels, _flat(f, 3), cycle=2, coarse_scaling=0.75,
                              smoother="SSOR")
    _close(got, exp)
