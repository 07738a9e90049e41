"""Assembly of the prior precision operators as lattice stencils.

Counterparts of the reference operator family:

* :func:`shiftedlaplace_fd`  - ``src/linear_operator/shiftedlaplace_fd_operator.cc:33-56``
* :func:`shiftedlaplace_fem` - ``src/linear_operator/shiftedlaplace_fem_operator.cc:43-140``
* :func:`squared_shiftedlaplace_fd` - ``src/linear_operator/squared_shiftedlaplace_fd_operator.cc:40-94``

Where the reference loops over vertices/cells emitting sparse triplets, we build
the ``(n_offsets, *grid)`` stencil coefficient arrays in a handful of vectorised
array operations; spatially varying kappa^2(x) fields are evaluated on whole
coordinate grids at once.
"""

from __future__ import annotations

import itertools
from typing import Tuple

import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice
from ..ops.quadrature import gauss_legendre
from ..ops.stencil import StencilOperator
from .correlation import CorrelationLengthModel


def _dtype(dtype):
    if dtype is not None:
        return dtype
    return jnp.zeros(0).dtype  # canonical default float dtype (f64 if x64 enabled)


def _axis_offset(lattice: Lattice, ref_dim: int, o: int) -> Tuple[int, ...]:
    """Unit offset ``o`` along reference dimension ``ref_dim`` in array-axis order."""
    off = [0] * lattice.dim
    off[lattice.dim - 1 - ref_dim] = o
    return tuple(off)


def _ref_offset_to_array(off_ref: Tuple[int, ...]) -> Tuple[int, ...]:
    """Reference (x, y, z) offset -> array-axis (z, y, x) offset."""
    return tuple(reversed(off_ref))


def shiftedlaplace_fd(
    lattice: Lattice, model: CorrelationLengthModel, dtype=None
) -> StencilOperator:
    """Finite-difference discretisation of ``-Laplace(u) + kappa^2(x) u``.

    5-point (2d) / 7-point (3d) stencil with homogeneous Dirichlet BCs:
    off-diagonal ``-V / h_d^2``, diagonal ``V (kappa^2(x) + sum_d 2/h_d^2)``,
    cf. ``shiftedlaplace_fd_operator.cc:33-56``.
    """
    dtype = _dtype(dtype)
    V = lattice.cell_volume
    hinv2 = [1.0 / h**2 for h in lattice.h]
    coords = lattice.vertex_coordinates()
    kappa2 = jnp.asarray(model.kappa_sq(jnp.asarray(coords, dtype=dtype)), dtype=dtype)

    offsets = [(0,) * lattice.dim]
    coeff_list = [V * kappa2 + sum(2.0 * V * hi for hi in hinv2) * jnp.ones(lattice.vshape, dtype=dtype)]
    for d in range(lattice.dim):
        for o in (-1, 1):
            offsets.append(_axis_offset(lattice, d, o))
            coeff_list.append(jnp.full(lattice.vshape, -V * hinv2[d], dtype=dtype))
    return StencilOperator(
        coeffs=jnp.stack(coeff_list), offsets=tuple(offsets), lattice=lattice
    ).normalized()


def squared_shiftedlaplace_fd(
    lattice: Lattice, model: CorrelationLengthModel, dtype=None
) -> StencilOperator:
    """Finite-difference discretisation of ``(-Laplace + kappa^2(x))^2`` (2d only).

    13-point diamond stencil with Neumann-style folding of the out-of-range
    distance-2 entries onto the diagonal whenever the corresponding distance-1
    neighbour leaves the grid, cf. ``squared_shiftedlaplace_fd_operator.cc:40-94``.
    """
    if lattice.dim != 2:
        raise ValueError("squared_shiftedlaplace_fd is only implemented for d=2")
    dtype = _dtype(dtype)
    V = lattice.cell_volume
    hx2, hy2 = (1.0 / h**2 for h in lattice.h)  # hinv2 for ref dims x (0) and y (1)
    # stencil of the Laplacian and its square, indexed [|j|][|k|] with j along x, k along y
    lap = {(0, 0): -2.0 * (hx2 + hy2), (1, 0): hx2, (0, 1): hy2}
    sq = {
        (0, 0): 6.0 * (hx2 * hx2 + hy2 * hy2) + 8.0 * hx2 * hy2,
        (1, 0): -4.0 * hx2 * (hx2 + hy2),
        (0, 1): -4.0 * hy2 * (hx2 + hy2),
        (2, 0): hx2 * hx2,
        (0, 2): hy2 * hy2,
        (1, 1): 2.0 * hx2 * hy2,
    }
    coords = lattice.vertex_coordinates()
    alpha_b = jnp.asarray(model.kappa_sq(jnp.asarray(coords, dtype=dtype)), dtype=dtype)

    vshape = lattice.vshape  # (ny-1, nx-1): axis 0 = y, axis 1 = x
    diag = (alpha_b * alpha_b - 2.0 * alpha_b * lap[(0, 0)] + sq[(0, 0)]) * V

    offsets = [(0, 0)]
    coeff_list = [None]  # placeholder for diagonal, filled below
    for j in range(-2, 3):  # reference x offset
        for k in range(-2, 3):  # reference y offset
            if abs(j) + abs(k) > 2 or (j == 0 and k == 0):
                continue
            coeff = jnp.full(vshape, sq[(abs(j), abs(k))], dtype=dtype)
            if abs(j) + abs(k) == 1:
                coeff = coeff - 2.0 * alpha_b * lap[(abs(j), abs(k))]
            offsets.append((k, j))  # array order (y, x)
            coeff_list.append(coeff * V)
    # Neumann-style boundary folding: when a distance-1 neighbour in +-x/+-y is
    # outside the grid, add the corresponding distance-2 coefficient to the diagonal.
    ny1, nx1 = vshape
    for j, k in ((1, 0), (-1, 0), (0, 1), (0, -1)):
        outside = np.zeros(vshape)
        if k == 0:  # x direction: boundary column
            outside[:, 0 if j < 0 else nx1 - 1] = 1.0
            fold = sq[(2, 0)]
        else:  # y direction: boundary row
            outside[0 if k < 0 else ny1 - 1, :] = 1.0
            fold = sq[(0, 2)]
        diag = diag + jnp.asarray(outside, dtype=dtype) * (fold * V)
    coeff_list[0] = diag
    return StencilOperator(
        coeffs=jnp.stack(coeff_list), offsets=tuple(offsets), lattice=lattice
    ).normalized()


def _phi(alpha: Tuple[int, ...], xhat: np.ndarray) -> float:
    """Multilinear basis function on the reference cell, cf.
    ``shiftedlaplace_fem_operator.cc:155-166``."""
    v = 1.0
    for a, xh in zip(alpha, xhat):
        v *= xh if a == 1 else (1.0 - xh)
    return v


def _grad_phi(alpha: Tuple[int, ...], xhat: np.ndarray) -> np.ndarray:
    """Gradient of the multilinear basis function w.r.t. reference coordinates,
    cf. ``shiftedlaplace_fem_operator.cc:169-188``."""
    dim = len(alpha)
    g = np.empty(dim)
    for k in range(dim):
        v = 1.0
        for j, (a, xh) in enumerate(zip(alpha, xhat)):
            if j == k:
                v *= 1.0 if a == 1 else -1.0
            else:
                v *= xh if a == 1 else (1.0 - xh)
        g[k] = v
    return g


def shiftedlaplace_fem(
    lattice: Lattice, model: CorrelationLengthModel, dtype=None
) -> StencilOperator:
    """Multilinear FEM discretisation of ``-div(grad u) + kappa^2(x) u``.

    3^d stencil assembled cell-by-cell with order-1 Gauss-Legendre quadrature,
    cf. ``shiftedlaplace_fem_operator.cc:43-140``.  The reference's cell loop
    becomes: (1) evaluate kappa^2 on all quadrature points of all cells at once,
    (2) contract with precomputed basis-pair tables to get per-cell local
    matrices, (3) slice-accumulate the local matrices into the vertex stencil.
    """
    dtype = _dtype(dtype)
    dim = lattice.dim
    V = lattice.cell_volume
    hinv2 = np.array([1.0 / h**2 for h in lattice.h])
    points, weights = gauss_legendre(dim, order=1)
    nq = len(weights)
    corners = list(itertools.product((0, 1), repeat=dim))  # reference dim order

    # Basis-pair tables (cf. the phi_phi / gradphi_gradphi precomputation at
    # shiftedlaplace_fem_operator.cc:84-99)
    phi_tab = np.array([[_phi(a, points[q]) for q in range(nq)] for a in corners])
    gphi_tab = np.array(
        [
            [
                [
                    _grad_phi(a, points[q]) @ (hinv2 * _grad_phi(b, points[q]))
                    for q in range(nq)
                ]
                for b in corners
            ]
            for a in corners
        ]
    )  # (2^d, 2^d, nq)

    # kappa^2 at quadrature point q of every cell: x = h * (cell_coord + xhat_q)
    cshape = lattice.cshape
    kappa2_q = []
    for q in range(nq):
        axes = [
            (np.arange(n, dtype=np.float64) + points[q][d]) / n
            for d, n in enumerate(lattice.shape)
        ]
        grids = np.meshgrid(*reversed(axes), indexing="ij")
        x = np.stack(list(reversed(grids)), axis=-1)  # (*cshape, dim), x first
        kappa2_q.append(np.asarray(model.kappa_sq(jnp.asarray(x, dtype=dtype))))
    kappa2_q = np.stack(kappa2_q)  # (nq, *cshape)

    # Per-cell local matrices K[a, b] = sum_q (kappa^2 phi phi + grad grad) w_q V
    # K has shape (2^d, 2^d, *cshape)
    K = np.einsum(
        "aq,bq,q,q...->ab...", phi_tab, phi_tab, weights, kappa2_q
    ) + np.einsum("abq,q->ab", gphi_tab, weights)[(...,) + (None,) * dim]
    K = K * V

    # Scatter local matrices into the vertex stencil: the (a, b) pair contributes
    # K[a, b](cell) to the coefficient coupling vertex v = cell + a with its
    # neighbour at offset b - a; equivalently, for interior vertex with array
    # index i the contributing cell is i + (1 - a) per axis.
    offsets_all = sorted(itertools.product((-1, 0, 1), repeat=dim))
    acc = {off: np.zeros(lattice.vshape) for off in offsets_all}
    for ia, a in enumerate(corners):
        a_arr = tuple(reversed(a))
        for ib, b in enumerate(corners):
            off_arr = _ref_offset_to_array(tuple(bb - aa for aa, bb in zip(a, b)))
            sl = tuple(
                slice(1 - aa, 1 - aa + (n - 1))
                for aa, n in zip(a_arr, lattice.cshape)
            )
            acc[off_arr] += K[ia, ib][sl]
    coeffs = jnp.asarray(np.stack([acc[off] for off in offsets_all]), dtype=dtype)
    return StencilOperator(
        coeffs=coeffs, offsets=tuple(offsets_all), lattice=lattice
    ).normalized()


_PDE_MODELS = {
    "shiftedlaplace_fd": shiftedlaplace_fd,
    "shiftedlaplace_fem": shiftedlaplace_fem,
    "squared_shiftedlaplace_fd": squared_shiftedlaplace_fd,
}


def prior_operator(
    pdemodel: str, lattice: Lattice, model: CorrelationLengthModel, dtype=None
) -> StencilOperator:
    """Dispatch by name, mirroring the driver's operator selection
    (``src/driver_mgmc.cc:413-430``)."""
    try:
        return _PDE_MODELS[pdemodel](lattice, model, dtype=dtype)
    except KeyError:
        raise ValueError(f"unknown PDE model '{pdemodel}'") from None
