"""Posterior precision operators from point measurements.

Counterpart of ``src/linear_operator/measured_operator.{hh,cc}``.
Given a prior precision Q (a stencil operator) and m measurements
``y = B^T x + e`` with ``e ~ N(0, Sigma)``, the posterior precision is

    Q_post = Q + B Sigma^{-1} B^T        (measured_operator.hh:16-28)

Each column of B is a measurement vector on the lattice
(``measured_operator.cc:69-171``):

* radius 0: delta at the vertex nearest to the measurement location;
* radius R: the indicator of the R-ball around x0, normalised by the sphere
  volume, integrated against the multilinear FEM basis with order-1 quadrature.
  (Unlike the reference, no cell-overlap pre-screen is applied - the unscreened
  sum is identical except in the corner case of a ball poking through a cell
  face without containing a corner, where the reference drops a valid
  contribution.)
* optionally a global-average measurement appends a dense column of cell_volume
  (``measured_operator.cc:31-46``).

B is stored dense as ``(m, *grid)`` - m is small, and dense columns make
``B^T x`` one small contraction on the device.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Optional

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from ..ops.quadrature import gauss_legendre
from ..ops.stencil import LowRank, StencilOperator
from .prior import _phi


@dataclasses.dataclass
class MeasurementParameters:
    """Mirrors ``MeasurementParameters`` (``parameters.hh`` / ``parameters.cc:267-316``)."""

    measurement_locations: np.ndarray  # (m, dim)
    mean: np.ndarray  # (m,)
    variance: np.ndarray  # (m,)
    radius: float = 0.0
    variance_scaling: float = 1.0
    sample_location: Optional[np.ndarray] = None
    measure_global: bool = False
    mean_global: float = 0.0
    variance_global: float = 0.0

    @property
    def n(self) -> int:
        return len(self.mean)

    def y(self) -> np.ndarray:
        """Measured values incl. the optional global mean (cf. driver_mgmc.cc:51-55)."""
        if self.measure_global:
            return np.concatenate([np.asarray(self.mean), [self.mean_global]])
        return np.asarray(self.mean)


def v_sphere(radius: float, dim: int) -> float:
    """Volume of the R-sphere: V_0=1, V_1=2R, V_d = 2 pi/d R^2 V_{d-2}
    (``measured_operator.cc:52-66``)."""
    if dim == 0:
        return 1.0
    if dim == 1:
        return 2.0 * radius
    return 2.0 * np.pi / dim * radius * radius * v_sphere(radius, dim - 2)


def measurement_vector(lattice: Lattice, x0, radius: float) -> np.ndarray:
    """Measurement vector as a grid field (``measured_operator.cc:69-171``)."""
    x0 = np.asarray(x0, dtype=np.float64)
    dim = lattice.dim
    w = np.zeros(lattice.vshape)
    if radius < 1e-12:
        coords = lattice.vertex_coordinates()  # (*vshape, dim)
        dist = np.linalg.norm(coords - x0, axis=-1)
        idx = np.unravel_index(np.argmin(dist), lattice.vshape)
        w[idx] = 1.0
        return w
    h = np.asarray(lattice.h)
    V = lattice.cell_volume
    norm = 1.0 / v_sphere(radius, dim)
    points, weights = gauss_legendre(dim, order=1)
    corners = list(itertools.product((0, 1), repeat=dim))
    for q in range(len(weights)):
        # physical coordinates of quadrature point q in every cell
        axes = [
            (np.arange(n, dtype=np.float64) + points[q][d]) / n
            for d, n in enumerate(lattice.shape)
        ]
        grids = np.meshgrid(*reversed(axes), indexing="ij")
        x = np.stack(list(reversed(grids)), axis=-1)  # (*cshape, dim), x first
        inside = (np.linalg.norm(x - x0, axis=-1) / radius) < 1.0
        for alpha in corners:
            contrib = inside * (_phi(alpha, points[q]) * weights[q] * V * norm)
            # scatter to vertex cell + alpha (interior only): vertex array index
            # i = cell + (alpha - 1) per axis -> slice cells from 1 - alpha
            a_arr = tuple(reversed(alpha))
            sl = tuple(
                slice(1 - aa, 1 - aa + (n - 1)) for aa, n in zip(a_arr, lattice.cshape)
            )
            w += contrib[sl]
    return w


def _default_stencil_solve(op: StencilOperator):
    """Host float64 solver for the *stencil* (prior) part: dense Cholesky for
    small lattices, a sparse LU factorisation (minimum-degree ordering of the
    symmetric pattern) otherwise.  Used by the exact-posterior diagnostics
    below."""
    import scipy.linalg

    n = op.lattice.nvertex
    vshape = op.lattice.vshape
    if n <= 4096:
        factor = scipy.linalg.cho_factor(op.to_dense_stencil())
        return lambda v: scipy.linalg.cho_solve(factor, np.asarray(v).reshape(-1)).reshape(vshape)
    import scipy.sparse.linalg

    from ..reference import stencil_matrix

    lu = scipy.sparse.linalg.splu(
        stencil_matrix(dataclasses.replace(op, lowrank=None)).tocsc(),
        permc_spec="MMD_AT_PLUS_A")
    return lambda v: lu.solve(np.asarray(v, dtype=np.float64).reshape(-1)).reshape(vshape)


def posterior_mean(op: StencilOperator, xbar, y, solve=None) -> np.ndarray:
    """Exact posterior mean
    ``x|y = xbar + Q^{-1} B (Sigma + B^T Q^{-1} B)^{-1} (y - B^T xbar)``
    (``linear_operator.hh:119-136``; Q is the *prior* stencil part)."""
    if op.lowrank is None:
        return np.asarray(xbar)
    solve = solve or _default_stencil_solve(op)
    m = op.m_lowrank
    vshape = op.lattice.vshape
    B = np.asarray(op.lowrank.B).reshape(m, -1)  # (m, n)
    Sigma = np.diag(np.asarray(op.lowrank.Sigma_diag))
    Bbar = np.stack(
        [np.asarray(solve(B[k].reshape(vshape))).reshape(-1) for k in range(m)]
    )  # (m, n)
    S = Sigma + B @ Bbar.T
    xbar = np.asarray(xbar).reshape(-1)
    rhs = np.asarray(y) - B @ xbar
    coef = np.linalg.solve(S, rhs)
    return (xbar + Bbar.T @ coef).reshape(vshape)


def observed_mean_and_variance(op: StencilOperator, xbar, y, b_obs, solve=None):
    """Exact mean and variance of the observation ``z = b^T x`` under the
    posterior (``linear_operator.hh:153-174``)."""
    solve = solve or _default_stencil_solve(op)
    b_obs = np.asarray(b_obs)
    b_bar = np.asarray(solve(b_obs))  # Q^{-1} b
    xbar = np.asarray(xbar)
    mean = float(np.vdot(b_obs, xbar))
    variance = float(np.vdot(b_obs, b_bar))
    if op.lowrank is not None:
        m = op.m_lowrank
        vshape = op.lattice.vshape
        B = np.asarray(op.lowrank.B).reshape(m, -1)
        Sigma = np.diag(np.asarray(op.lowrank.Sigma_diag))
        Bbar = np.stack(
            [np.asarray(solve(B[k].reshape(vshape))).reshape(-1) for k in range(m)]
        )
        S_inv = np.linalg.inv(Sigma + B @ Bbar.T)
        Bt_bbar = B @ b_bar.reshape(-1)
        rhs = np.asarray(y) - B @ xbar.reshape(-1)
        mean += float(Bt_bbar @ S_inv @ rhs)
        variance -= float(Bt_bbar @ S_inv @ Bt_bbar)
    return mean, variance


def measured_operator(
    prior: StencilOperator, params: MeasurementParameters, dtype=None
) -> StencilOperator:
    """Posterior precision ``Q_post = Q_prior + B Sigma^{-1} B^T``
    (``measured_operator.cc:9-49``)."""
    lattice = prior.lattice
    dtype = dtype or prior.coeffs.dtype
    cols = [
        measurement_vector(lattice, x0, params.radius)
        for x0 in np.asarray(params.measurement_locations).reshape(-1, lattice.dim)
    ]
    sigma = list(params.variance_scaling * np.asarray(params.variance, dtype=np.float64))
    if params.measure_global:
        cols.append(np.full(lattice.vshape, lattice.cell_volume))
        sigma.append(params.variance_global)
    B = jnp.asarray(np.stack(cols), dtype=dtype)
    Sigma_diag = jnp.asarray(np.asarray(sigma), dtype=dtype)
    return dataclasses.replace(prior, lowrank=LowRank(B=B, Sigma_diag=Sigma_diag))
