"""Direct (exact) samplers via Cholesky factorisation of the precision matrix.

Counterpart of ``src/sampler/cholesky_sampler.{hh,cc}``.  Given the
full precision ``Q = A_stencil + B Sigma^{-1} B^T = U^T U``, a sample is

    1. xi ~ N(0, I)
    2. solve U^T g = f            (cacheable via fix_rhs, cholesky_sampler.hh:77-92)
    3. solve U x = xi + g         (cholesky_sampler.hh:50-66)

Backends (replacing the CholMod/Eigen switch of ``cholesky_wrapper.hh:103-109``):

* :class:`DenseCholeskySampler` - dense on-device LLT; the right tool for the
  (tiny) coarse multigrid level and for small/medium standalone problems.
* :class:`BandCholeskySampler` ("sparse" factorisation) - lattice precision
  matrices in lexicographic order are banded with bandwidth b = prod of the
  minor extents; a host-side band Cholesky gives an O(n b) factor (the band
  contains all fill-in, so this *is* the exact sparse factor) with O(n b^2)
  setup.  The solves run on device; this sampler is the exactness baseline
  the MGMC sampler is compared against, not the production path.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
import scipy.linalg

from ..ops.stencil import StencilOperator
from ..utils.runtime import on_accelerator
from .base import Sampler


def _split_batch(op: StencilOperator, f: jax.Array):
    vdim = len(op.vshape)
    batch = f.shape[: f.ndim - vdim]
    n = int(np.prod(op.vshape))
    return batch, n


class DenseCholeskySampler(Sampler):
    """cf. ``DenseCholeskySampler`` (``cholesky_sampler.cc:26-38``): densify the
    full precision (incl. low-rank) and factorise once at setup, on the host in
    float64 (the factor is then rounded to the operator's dtype)."""

    def __init__(self, op: StencilOperator):
        super().__init__(op)
        dtype = op.coeffs.dtype
        # Q = L L^T, i.e. U = L^T
        self.L = jnp.asarray(np.linalg.cholesky(op.to_dense()), dtype=dtype)
        self._g = None

    def _solve_L(self, v: jax.Array) -> jax.Array:
        """Solve U^T g = v, i.e. L g = v; v shape (*batch, n) with any number
        of leading batch axes (flattened to one for the triangular solve)."""
        vt = jnp.atleast_2d(v).reshape(-1, v.shape[-1]).T  # (n, batch)
        g = jax.scipy.linalg.solve_triangular(self.L, vt, lower=True)
        return g.T.reshape(v.shape)

    def _solve_LT(self, v: jax.Array) -> jax.Array:
        """Solve U x = v, i.e. L^T x = v."""
        vt = jnp.atleast_2d(v).reshape(-1, v.shape[-1]).T
        y = jax.scipy.linalg.solve_triangular(self.L.T, vt, lower=False)
        return y.T.reshape(v.shape)

    def fix_rhs(self, f: jax.Array) -> None:
        batch, n = _split_batch(self.op, f)
        self._g = self._solve_L(f.reshape(batch + (n,)))

    def unfix_rhs(self) -> None:
        self._g = None

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        batch, n = _split_batch(self.op, x)
        fbatch, _ = _split_batch(self.op, f)
        xi = jax.random.normal(key, batch + (n,), dtype=x.dtype)
        g = self._g if self._g is not None else self._solve_L(f.reshape(fbatch + (n,)))
        y = self._solve_LT(xi + g)  # broadcasts g over the chain batch
        return y.reshape(x.shape)


def _band_matrix_stencil(op: StencilOperator):
    """Lower band storage ``ab[i, j] = A[j + i, j]`` of the *stencil part only*
    (no dense measurement columns), assembled from the stencil planes without
    densifying: the bandwidth is the product of the minor grid extents."""
    vshape = op.vshape
    n = int(np.prod(vshape))
    strides = np.cumprod([1] + list(reversed(vshape)))[:-1][::-1]  # array-order strides
    shifts = [int(np.dot(off, strides)) for off in op.offsets]
    b = max(abs(s) for s in shifts)
    # normalized(): coefficients whose neighbour lies outside the grid are
    # zero, so wrapped-around linear neighbours get no entry
    coeffs = np.asarray(op.normalized().coeffs, dtype=np.float64).reshape(len(shifts), n)
    ab = np.zeros((b + 1, n))
    for k, s in enumerate(shifts):
        if s <= 0:  # row r couples to column r + s: ab[-s, r + s] = A[r, r + s]
            ab[-s, : n + s] += coeffs[k, -s:]
    return ab, b


def _device_bytes_limit() -> Optional[int]:
    """Memory the default device's allocator may use, None if not reported."""
    stats = jax.devices()[0].memory_stats()
    return None if not stats else stats.get("bytes_limit")


class BandFactor:
    """Device-resident blocked triangular solves for a banded Cholesky factor.

    The factor is computed once on host (``scipy.linalg.cholesky_banded`` -
    the band contains all fill-in, so this IS the exact sparse factor, the
    counterpart of the reference's CholMod backend,
    ``cholesky_wrapper.cc:10-77``); the solves run on device over dense
    (b x b) blocks, batched over right-hand sides as matmuls.  Fully jittable.

    Two substitution strategies:

    * sequential (``parallel=False``): a ``lax.scan`` over the ~n/b row
      blocks - one triangular solve plus one subdiagonal matmul per step.
      Exact but latency-bound (~2 small ops per block, serialised).
    * recursive doubling (``parallel=True``): the block recurrence
      ``g_i = M_i g_{i-1} + c_i`` (``M_i = -Ld_i^{-1} Ls_i``,
      ``c_i = Ld_i^{-1} v_i``) is a parallel affine prefix; the level-l
      products ``M^{(l)}_i = M^{(l-1)}_i M^{(l-1)}_{i-2^{l-1}}`` are
      *data-independent*, so they are precomputed at setup and each solve is
      just ``ceil(log2(nb))`` batched matmuls
      ``c_i += M^{(l)}_i c_{i-2^l}`` - O(log n) sequential depth instead of
      O(n/b).  Costs ``2 L nb b^2`` floats of device memory for the level
      tensors.

    ``parallel=None`` picks doubling on an accelerator when the level
    tensors fit in an eighth of the device's memory limit, the sequential scan
    otherwise (CPU, huge bands).
    """

    def __init__(self, cb: np.ndarray, dtype, parallel: Optional[bool] = None):
        b, n = cb.shape[0] - 1, cb.shape[1]
        blk = max(b, 1)
        nb = -(-n // blk)
        npad = nb * blk
        cbp = np.zeros((b + 1, npad))
        cbp[:, :n] = cb
        cbp[0, n:] = 1.0  # unit diagonal on padding
        self.n, self.blk, self.nb = n, blk, nb

        r, c = np.meshgrid(np.arange(blk), np.arange(blk), indexing="ij")
        i = np.arange(nb).reshape(-1, 1, 1)
        # diagonal blocks: L[i*blk+r, i*blk+c] = cbp[r-c, i*blk+c]
        k1 = np.clip(r - c, 0, b)
        Ld = np.where(r >= c, cbp[k1, i * blk + c], 0.0)
        # subdiagonal blocks: L[i*blk+r, (i-1)*blk+c] = cbp[blk+r-c, (i-1)*blk+c]
        k2 = np.clip(blk + r - c, 0, b)
        cols = np.maximum(i - 1, 0) * blk + c
        Ls = np.where((blk + r - c <= b) & (i > 0), cbp[k2, cols], 0.0)
        self.Ld = jnp.asarray(Ld, dtype=dtype)
        self.Ls = jnp.asarray(Ls, dtype=dtype)
        if parallel is None:
            parallel = self._auto_parallel(dtype)
        self.parallel = bool(parallel)
        if self.parallel:
            self._build_doubling()

    # ------------------------------------------------ recursive doubling
    def _auto_parallel(self, dtype) -> bool:
        if self.nb < 8 or not on_accelerator():
            return False  # scan latency negligible; skip the level tensors
        limit = _device_bytes_limit()
        if limit is None:
            raise RuntimeError(
                "the accelerator reports no memory limit: pass parallel= "
                "explicitly")
        nlev = max(1, (self.nb - 1).bit_length())
        bytes_needed = 2 * nlev * self.nb * self.blk * self.blk * jnp.dtype(dtype).itemsize
        return bytes_needed <= limit // 8

    @staticmethod
    def _doubling_levels(M: jax.Array, nb: int):
        """Precompute ``M^{(l)}`` for l = 0..L-1 (data-independent).

        Every level tensor is kept FULL-SIZE (nb) with the first ``2^l``
        blocks exactly zero (M_0 = 0 by construction and zeros propagate
        through the products), so both the build and the apply can run
        aligned batched matmuls over a rolled operand instead of slicing a
        misaligned batch (``M[step:]`` at odd offsets), which forces a
        relayout of the whole level tensor."""
        hi = jax.lax.Precision.HIGHEST
        levels = []
        step = 1
        while step < nb:
            levels.append(M)
            # M^{(l+1)}_i = M^{(l)}_i M^{(l)}_{i-2^l}; the rolled operand's
            # wrapped-in tail blocks meet the zero head blocks of M, so the
            # first 2^{l+1} outputs are exactly zero as required
            M = jnp.einsum("nrk,nkc->nrc", M, jnp.roll(M, step, axis=0),
                           precision=hi)
            step *= 2
        return levels

    def _build_doubling(self):
        # one jitted program for the whole level-tensor build instead of one
        # eager dispatch (and compile) per level shape
        nb = self.nb

        @jax.jit
        def build(Ld, Ls):
            hi = jax.lax.Precision.HIGHEST
            eye = jnp.eye(Ld.shape[-1], dtype=Ld.dtype)
            Linv = jax.vmap(
                lambda L: jax.scipy.linalg.solve_triangular(L, eye, lower=True)
            )(Ld)  # (nb, blk, blk)
            # forward: g_i = M_i g_{i-1} + Linv_i v_i,  M_i = -Linv_i Ls_i
            Mf = -jnp.einsum("nrk,nkc->nrc", Linv, Ls, precision=hi)
            lev_L = self._doubling_levels(Mf, nb)
            # backward: x_i = Mb_i x_{i+1} + Ld_i^{-T} v_i,
            # Mb_i = -Ld_i^{-T} Ls_{i+1}^T = -(Ls_{i+1} Linv_i)^T; reversing
            # the index turns it into the same forward recurrence
            Ls_next = jnp.concatenate([Ls[1:], jnp.zeros_like(Ls[:1])], 0)
            Mb = -jnp.einsum("nrk,nkc->ncr", Ls_next, Linv, precision=hi)
            lev_LT = self._doubling_levels(Mb[::-1], nb)
            return Linv, tuple(lev_L), tuple(lev_LT)

        self.Linv, self._lev_L, self._lev_LT = build(self.Ld, self.Ls)
        self._lev_L = list(self._lev_L)
        self._lev_LT = list(self._lev_LT)

    @staticmethod
    def _doubling_apply(levels, c: jax.Array) -> jax.Array:
        """Run the precomputed affine prefix: c_i += M^{(l)}_i c_{i-2^l}.

        Aligned full-batch form (see ``_doubling_levels``): the level
        tensors' zero head blocks annihilate the rolled operand's wrapped-in
        tail, so this computes exactly the sliced recurrence without slicing
        a misaligned batch."""
        hi = jax.lax.Precision.HIGHEST
        step = 1
        for M in levels:
            add = jnp.einsum("nrc,nkc->nkr", M, jnp.roll(c, step, axis=0),
                             precision=hi)
            c = c + add
            step *= 2
        return c

    def _blocks(self, v: jax.Array):
        """(..., n) -> (nb, K, blk) with K the flattened batch."""
        batch = v.shape[:-1]
        vp = jnp.pad(
            v.reshape(-1, self.n), ((0, 0), (0, self.nb * self.blk - self.n))
        )
        return vp.reshape(-1, self.nb, self.blk).transpose(1, 0, 2), batch

    def _unblocks(self, g: jax.Array, batch):
        out = g.transpose(1, 0, 2).reshape(-1, self.nb * self.blk)[:, : self.n]
        return out.reshape(batch + (self.n,))

    def solve_L(self, v: jax.Array) -> jax.Array:
        """Solve ``L g = v``; v shape (..., n), any leading batch dims."""
        vb, batch = self._blocks(v)
        if self.parallel:
            hi = jax.lax.Precision.HIGHEST
            c = jnp.einsum("nrc,nkc->nkr", self.Linv, vb, precision=hi)
            return self._unblocks(self._doubling_apply(self._lev_L, c), batch)

        def step(g_prev, xs):
            Ld_i, Ls_i, v_i = xs
            rhs = v_i - jnp.einsum(
                "rc,kc->kr", Ls_i, g_prev, precision=jax.lax.Precision.HIGHEST
            )
            g = jax.scipy.linalg.solve_triangular(Ld_i, rhs.T, lower=True).T
            return g, g

        g0 = jnp.zeros_like(vb[0])
        _, gs = jax.lax.scan(step, g0, (self.Ld, self.Ls, vb))
        return self._unblocks(gs, batch)

    def solve_LT(self, v: jax.Array) -> jax.Array:
        """Solve ``L^T x = v`` (reverse block substitution)."""
        vb, batch = self._blocks(v)
        if self.parallel:
            hi = jax.lax.Precision.HIGHEST
            # cb_i = Ld_i^{-T} v_i = Linv_i^T v_i, then run the reversed-index
            # forward recurrence and flip back
            cb = jnp.einsum("ncr,nkc->nkr", self.Linv, vb, precision=hi)
            x = self._doubling_apply(self._lev_LT, cb[::-1])[::-1]
            return self._unblocks(x, batch)
        # x_i = Ld_i^{-T} (v_i - Ls_{i+1}^T x_{i+1})
        Ls_next = jnp.concatenate(
            [self.Ls[1:], jnp.zeros_like(self.Ls[:1])], axis=0
        )

        def step(x_next, xs):
            Ld_i, Lsn_i, v_i = xs
            rhs = v_i - jnp.einsum(
                "rc,kr->kc", Lsn_i, x_next, precision=jax.lax.Precision.HIGHEST
            )
            x = jax.scipy.linalg.solve_triangular(
                Ld_i.T, rhs.T, lower=False
            ).T
            return x, x

        x0 = jnp.zeros_like(vb[0])
        _, xs = jax.lax.scan(
            step, x0, (self.Ld, Ls_next, vb), reverse=True
        )
        return self._unblocks(xs, batch)

    def solve(self, v: jax.Array) -> jax.Array:
        """Solve ``L L^T x = v``."""
        return self.solve_LT(self.solve_L(v))


class BandCholeskySampler(Sampler):
    """Band ("sparse") Cholesky sampler, cf. ``SparseCholeskySampler``
    (``cholesky_sampler.cc:9-23``), fully device-resident.

    The reference folds the low-rank term into A and lets supernodal CholMod
    absorb the dense measurement columns; a band factor cannot (one dense
    column makes the band full).  This design factors only the
    banded stencil part ``A`` (bandwidth = product of minor extents) and
    applies an exact rank-m correction at sampling time:

        y   ~ N(0, A^{-1})            y = L^{-T} xi            (band solve)
        eta ~ N(0, Sigma)
        x   = mu + y - W (B^T y + eta),   W = A^{-1} B S^{-1},
        S   = Sigma + B^T A^{-1} B

    Then ``cov(x - mu) = A^{-1} - W S W^T = Q^{-1}`` exactly (Woodbury), with
    ``Q = A + B Sigma^{-1} B^T`` the full posterior precision, and
    ``mu = Q^{-1} f`` computed through the same identity.  All per-sample
    work is jittable; the factorisation happens once on host at setup."""

    def __init__(self, op: StencilOperator, parallel: Optional[bool] = None):
        super().__init__(op)
        ab, self.bandwidth = _band_matrix_stencil(op)
        cb = scipy.linalg.cholesky_banded(ab, lower=True)  # L band: cb[k,j]=L[j+k,j]
        self._dtype = op.coeffs.dtype
        self.factor = BandFactor(cb, self._dtype, parallel=parallel)
        self._mu = None
        n = ab.shape[1]
        if op.lowrank is not None:
            # Woodbury pieces in float64 on host (precision-critical)
            Bt = np.asarray(op.lowrank.B, dtype=np.float64).reshape(op.m_lowrank, -1)
            Ainv_B = _np_band_solve(cb, Bt.T)  # (n, m)
            Sig = np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)
            S = np.diag(Sig) + Bt @ Ainv_B
            self.W = jnp.asarray(Ainv_B @ np.linalg.inv(S), dtype=self._dtype)
            self.B_flat = jnp.asarray(Bt.T, dtype=self._dtype)  # (n, m)
            self.sqrt_Sigma = jnp.asarray(np.sqrt(Sig), dtype=self._dtype)
        else:
            self.W = None

    def _mean(self, f: jax.Array) -> jax.Array:
        """mu = Q^{-1} f via the Woodbury identity (f shape (..., n))."""
        t = self.factor.solve(f)
        if self.W is not None:
            hi = jax.lax.Precision.HIGHEST
            bt = jnp.tensordot(t, self.B_flat, axes=([t.ndim - 1], [0]), precision=hi)
            t = t - jnp.tensordot(bt, self.W, axes=([bt.ndim - 1], [1]), precision=hi)
        return t

    def fix_rhs(self, f) -> None:
        batch, n = _split_batch(self.op, f)
        self._mu = self._mean(jnp.asarray(f, self._dtype).reshape(batch + (n,)))

    def unfix_rhs(self) -> None:
        self._mu = None

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        batch, n = _split_batch(self.op, x)
        kxi, keta = jax.random.split(key)
        xi = jax.random.normal(kxi, batch + (n,), dtype=self._dtype)
        y = self.factor.solve_LT(xi)  # N(0, A^{-1})
        if self.W is not None:
            m = self.op.m_lowrank
            hi = jax.lax.Precision.HIGHEST
            eta = self.sqrt_Sigma * jax.random.normal(
                keta, batch + (m,), dtype=self._dtype
            )
            bty = jnp.tensordot(y, self.B_flat, axes=([y.ndim - 1], [0]), precision=hi)
            y = y - jnp.tensordot(
                bty + eta, self.W, axes=([bty.ndim - 1], [1]), precision=hi
            )
        if self._mu is not None:
            mu = self._mu
        else:
            fbatch, _ = _split_batch(self.op, f)
            mu = self._mean(jnp.asarray(f, self._dtype).reshape(fbatch + (n,)))
        return (mu + y).reshape(x.shape)


def _np_band_solve(cb: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Host float64 solve of ``L L^T x = v`` from the lower band factor."""
    return scipy.linalg.cho_solve_banded((cb, True), v)


# Naming parity with the reference's factorisation switch (parameters.hh:87-91)
SparseCholeskySampler = BandCholeskySampler
