"""Direct Cholesky solvers.

Counterpart of ``src/solver/cholesky_solver.{hh,cc}`` plus the
factorisation backends of ``src/auxilliary/cholesky_wrapper.{hh,cc}``.  There
is no supernodal sparse LLT on the device; the design (SURVEY.md section 7) is:

* coarse-level / small systems: **dense** on-device Cholesky (the only place the
  reference ever factorises inside multigrid is the tiny coarsest level,
  ``multigridmc_sampler.cc:99``);
* large standalone baselines: **banded** Cholesky - lattice operators in
  lexicographic order have bandwidth ~ prod of the minor grid extents, so a
  band factorisation is O(n b^2) at setup with O(n b) storage (see
  :mod:`multigridmc_tpu.samplers.cholesky`).

The low-rank term is handled by the precomputed Woodbury correction exactly as
``cholesky_solver.cc:8-44``: ``B_bar = A^{-1} B (Sigma + B^T A^{-1} B)^{-1}``,
``x = y - B_bar B^T y`` with ``y = A^{-1} b``.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np

from ..ops.stencil import StencilOperator


class DenseCholeskySolver:
    """Dense LLT solve of the stencil part + Woodbury low-rank correction."""

    def __init__(self, op: StencilOperator):
        import scipy.linalg

        self.op = op
        dtype = op.coeffs.dtype
        # factor and Woodbury pieces on the host in float64 (setup only)
        A = op.to_dense_stencil()
        L = np.linalg.cholesky(A)
        self.L = jnp.asarray(L, dtype=dtype)
        self.B_bar = None
        if op.lowrank is not None:
            B = np.asarray(op.lowrank.B, dtype=np.float64).reshape(op.m_lowrank, -1).T
            Ainv_B = scipy.linalg.cho_solve((L, True), B)  # (n, m)
            S = np.diag(np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)) + B.T @ Ainv_B
            self.B_bar = jnp.asarray(Ainv_B @ np.linalg.inv(S), dtype=dtype)
            self.B_flat = jnp.asarray(B, dtype=dtype)

    def apply(self, b: jax.Array) -> jax.Array:
        """Solve ``A x = b`` for a grid field b, supporting leading batch dims
        (cf. ``cholesky_solver.cc:28-44``)."""
        shape = b.shape
        vdim = len(self.op.vshape)
        n = self.L.shape[0]
        bf = b.reshape((-1, n)).T  # (n, nbatch)
        y = jax.scipy.linalg.cho_solve((self.L, True), bf)
        if self.B_bar is not None:
            hi = jax.lax.Precision.HIGHEST
            y = y - jnp.matmul(self.B_bar, jnp.matmul(self.B_flat.T, y, precision=hi),
                               precision=hi)
        return y.T.reshape(shape)


class BandCholeskySolver:
    """Band ("sparse") direct solver for large lattice systems, device-resident.

    Counterpart of the reference's CholMod-backed ``CholeskySolver``
    (``cholesky_solver.cc:8-44``) for problems too large to densify: the
    lexicographic band factorisation of the stencil part is its exact sparse
    factor (all fill-in stays inside the band).  The factorisation runs once on
    host at setup; the solves are jittable blocked substitutions on device
    (:class:`multigridmc_tpu.samplers.cholesky.BandFactor`).  The low-rank term
    uses the precomputed Woodbury correction of ``cholesky_solver.cc:13-26``:
    ``x = y - B_bar (B^T y)`` with ``y = A^{-1} b``.
    """

    def __init__(self, op: StencilOperator):
        import scipy.linalg

        from ..samplers.cholesky import BandFactor, _band_matrix_stencil, _np_band_solve

        self.op = op
        dtype = op.coeffs.dtype
        ab, self.bandwidth = _band_matrix_stencil(op)
        cb = scipy.linalg.cholesky_banded(ab, lower=True)
        self.factor = BandFactor(cb, dtype)
        self.B_bar = None
        if op.lowrank is not None:
            m = op.m_lowrank
            B = np.asarray(op.lowrank.B, dtype=np.float64).reshape(m, -1).T  # (n, m)
            Ainv_B = _np_band_solve(cb, B)
            S = np.diag(np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)) + B.T @ Ainv_B
            self.B_bar = jnp.asarray(Ainv_B @ np.linalg.inv(S), dtype=dtype)
            self.B_flat = jnp.asarray(B, dtype=dtype)

    def apply(self, b):
        """Solve ``Q x = b``; jittable, supports leading batch dims."""
        shape = b.shape
        n = self.factor.n
        bf = jnp.asarray(b).reshape((-1, n)) if b.ndim > len(self.op.vshape) else jnp.asarray(b).reshape((n,))
        y = self.factor.solve(bf)
        if self.B_bar is not None:
            hi = jax.lax.Precision.HIGHEST
            bty = jnp.tensordot(y, self.B_flat, axes=([y.ndim - 1], [0]), precision=hi)
            y = y - jnp.tensordot(bty, self.B_bar, axes=([bty.ndim - 1], [1]), precision=hi)
        return y.reshape(shape)
