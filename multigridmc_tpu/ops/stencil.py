"""Stencil linear operators on dense lattice fields - the replacement
for the reference's CSR ``LinearOperator`` (``src/linear_operator/linear_operator.hh``).

Every operator in the reference (shifted-Laplace FD/FEM, squared shifted-Laplace,
Galerkin-coarsened operators) couples each interior vertex only to vertices at a
fixed, small set of offsets.  Instead of a sparse matrix we therefore store a
coefficient array of shape ``(n_offsets, *grid)`` and apply the operator as a
shift-multiply-accumulate over dense fields - a memory-bound streaming computation
that XLA fuses into a handful of VPU passes and that shards over a device mesh
with automatically inserted halo exchanges.

Homogeneous Dirichlet boundary conditions are implicit: fields live on interior
vertices only and shifted reads outside the grid return zero, which is exactly the
effect of the reference dropping those matrix entries
(``src/linear_operator/shiftedlaplace_fd_operator.cc:43-56``).

The optional low-rank term ``A = A_stencil + B Sigma^{-1} B^T``
(``linear_operator.hh:28-76``) keeps ``B`` as a dense ``(m, *grid)`` array - m is
tiny (the number of measurements), so columns stored as full grids cost little and
``B^T x`` becomes one small contraction (an all-reduce of m scalars under sharding).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..lattice import Lattice

Offset = Tuple[int, ...]


def shift(x: jax.Array, offset: Offset) -> jax.Array:
    """Return array ``z`` with ``z[i] = x[i + offset]``, zero outside the grid.

    ``offset`` is in array-axis order (slowest axis first).  Implemented as a
    static pad+slice so XLA fuses it into the surrounding multiply-add; under
    sharding the SPMD partitioner turns it into a halo exchange.
    """
    if all(o == 0 for o in offset):
        return x
    # offsets address the trailing grid axes; leading axes are batch dims
    extra = x.ndim - len(offset)
    pads, slices = [(0, 0)] * extra, [slice(None)] * extra
    for o, n in zip(offset, x.shape[extra:]):
        if o >= 0:
            pads.append((0, o))
            slices.append(slice(o, o + n))
        else:
            pads.append((-o, 0))
            slices.append(slice(0, n))
    return jnp.pad(x, pads)[tuple(slices)]


def interior_mask(vshape: Tuple[int, ...], offset: Offset, dtype=jnp.float32) -> np.ndarray:
    """Mask that is 1 where ``i + offset`` is still inside the grid."""
    m = np.ones(vshape, dtype=np.float64)
    for ax, (o, n) in enumerate(zip(offset, vshape)):
        idx = [slice(None)] * len(vshape)
        if o > 0:
            idx[ax] = slice(n - o, n)
            m[tuple(idx)] = 0.0
        elif o < 0:
            idx[ax] = slice(0, -o)
            m[tuple(idx)] = 0.0
    return m


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class LowRank:
    """Low-rank update ``B Sigma^{-1} B^T`` with B stored as dense grids.

    ``B`` has shape ``(m, *grid)`` (the k-th slice is the k-th measurement vector
    reshaped onto the lattice) and ``Sigma_diag`` is the diagonal covariance of the
    m observations, cf. ``src/linear_operator/measured_operator.cc:9-49``.
    """

    B: jax.Array  # (m, *vshape)
    Sigma_diag: jax.Array  # (m,)

    @property
    def m(self) -> int:
        return self.B.shape[0]

    # The low-rank (Woodbury) algebra is precision-critical: with near-exact
    # measurements (Sigma ~ 1e-6) the correction nearly projects out the
    # measured directions, and reduced-precision contractions (TF32 on a GPU
    # at the default precision) perturb the splitting enough to destabilise
    # the Gibbs iteration.  All B contractions therefore force full float32
    # precision.
    def matvec(self, x: jax.Array) -> jax.Array:
        """Compute ``B Sigma^{-1} B^T x`` for a grid field x (extra leading batch dims ok)."""
        w = self.bt(x) / self.Sigma_diag
        return jnp.tensordot(
            w, self.B, axes=([w.ndim - 1], [0]), precision=jax.lax.Precision.HIGHEST
        )

    def bt(self, x: jax.Array) -> jax.Array:
        """``B^T x`` -> shape (*batch, m)."""
        d = self.B.ndim - 1
        return jnp.tensordot(
            x,
            self.B,
            axes=(tuple(range(x.ndim - d, x.ndim)), tuple(range(1, d + 1))),
            precision=jax.lax.Precision.HIGHEST,
        )

    def diag(self) -> jax.Array:
        """Diagonal of ``B Sigma^{-1} B^T`` as a grid field."""
        return jnp.einsum(
            "m...,m...->...", self.B,
            self.B / self.Sigma_diag.reshape((-1,) + (1,) * (self.B.ndim - 1)),
            precision=jax.lax.Precision.HIGHEST)


@jax.tree_util.register_dataclass
@dataclasses.dataclass(frozen=True)
class StencilOperator:
    """Symmetric positive-definite lattice operator ``A = A_stencil + B Sigma^{-1} B^T``.

    Counterpart of the reference ``LinearOperator``
    (``src/linear_operator/linear_operator.hh:28-198``).
    """

    coeffs: jax.Array  # (n_offsets, *vshape)
    offsets: Tuple[Offset, ...] = dataclasses.field(metadata=dict(static=True))
    lattice: Lattice = dataclasses.field(metadata=dict(static=True))
    lowrank: Optional[LowRank] = None

    def __post_init__(self):
        if (0,) * len(self.offsets[0]) not in self.offsets:
            raise ValueError("stencil must contain the zero offset (diagonal)")

    # ------------------------------------------------------------------ basics
    @property
    def vshape(self) -> Tuple[int, ...]:
        return self.lattice.vshape

    @property
    def dim(self) -> int:
        return len(self.offsets[0])

    @property
    def diag_index(self) -> int:
        return self.offsets.index((0,) * self.dim)

    @property
    def m_lowrank(self) -> int:
        return 0 if self.lowrank is None else self.lowrank.m

    def diag_stencil(self) -> jax.Array:
        """Diagonal of the stencil (sparse) part, as a grid field."""
        return self.coeffs[self.diag_index]

    def diag_full(self) -> jax.Array:
        """Diagonal of the full operator including the low-rank term."""
        d = self.diag_stencil()
        if self.lowrank is not None:
            d = d + self.lowrank.diag()
        return d

    # ------------------------------------------------------------------- apply
    def apply_stencil(self, x: jax.Array) -> jax.Array:
        """``y = A_stencil x`` - shift-multiply-accumulate over offsets."""
        y = None
        for k, off in enumerate(self.offsets):
            t = self.coeffs[k] * shift(x, off)
            y = t if y is None else y + t
        return y

    def apply_offdiag(self, x: jax.Array) -> jax.Array:
        """``(A_stencil - diag) x`` - used by colored Gauss-Seidel sweeps."""
        y = None
        for k, off in enumerate(self.offsets):
            if k == self.diag_index:
                continue
            t = self.coeffs[k] * shift(x, off)
            y = t if y is None else y + t
        return y

    def apply(self, x: jax.Array) -> jax.Array:
        """``y = A x`` including the low-rank term, cf. ``linear_operator.hh:66-76``."""
        y = self.apply_stencil(x)
        if self.lowrank is not None:
            y = y + self.lowrank.matvec(x)
        return y

    def __call__(self, x: jax.Array) -> jax.Array:
        return self.apply(x)

    # -------------------------------------------------------------- validation
    def normalized(self) -> "StencilOperator":
        """Zero out coefficients whose target vertex lies outside the grid.

        Such coefficients never act (shifted reads are zero) but zeroing them makes
        dense conversions and symmetry checks exact.
        """
        masks = np.stack([interior_mask(self.vshape, off) for off in self.offsets])
        return dataclasses.replace(self, coeffs=self.coeffs * jnp.asarray(masks, dtype=self.coeffs.dtype))

    def to_dense_stencil(self) -> np.ndarray:
        """Dense (n, n) matrix of the stencil part, rows/cols in reference
        lexicographic vertex order.  For validation on small lattices only."""
        vshape = self.vshape
        n = int(np.prod(vshape))
        coeffs = np.asarray(self.coeffs, dtype=np.float64)
        A = np.zeros((n, n))
        idx = np.arange(n).reshape(vshape)
        for k, off in enumerate(self.offsets):
            mask = interior_mask(vshape, off)
            src = idx
            # target linear index of i + off
            tgt = np.full(vshape, -1, dtype=np.int64)
            slices_dst, slices_src = [], []
            for o, m in zip(off, vshape):
                if o >= 0:
                    slices_dst.append(slice(0, m - o))
                    slices_src.append(slice(o, m))
                else:
                    slices_dst.append(slice(-o, m))
                    slices_src.append(slice(0, m + o))
            tgt[tuple(slices_dst)] = idx[tuple(slices_src)]
            valid = mask > 0
            A[src[valid], tgt[valid]] += coeffs[k][valid]
        return A

    def to_dense(self) -> np.ndarray:
        """Dense matrix of the full operator (incl. low-rank), for validation."""
        A = self.to_dense_stencil()
        if self.lowrank is not None:
            B = np.asarray(self.lowrank.B, dtype=np.float64).reshape(self.m_lowrank, -1).T
            S = np.asarray(self.lowrank.Sigma_diag, dtype=np.float64)
            A = A + B @ np.diag(1.0 / S) @ B.T
        return A

    def precision(self) -> np.ndarray:
        """Dense precision matrix, cf. ``LinearOperator::precision``
        (``linear_operator.cc:26-34``)."""
        return self.to_dense()

    def covariance(self) -> np.ndarray:
        """Dense covariance = precision^{-1}, cf. ``linear_operator.hh:180-183``.
        Small problems only (used by driver_spectrum and validation)."""
        return np.linalg.inv(self.to_dense())


def field_from_flat(v, lattice: Lattice) -> jax.Array:
    """Reshape a reference-ordered flat vector onto the grid layout."""
    return jnp.asarray(v).reshape(lattice.vshape)


def flat_from_field(x) -> np.ndarray:
    """Flatten a grid field to reference lexicographic vertex order."""
    return np.asarray(x).reshape(-1)
