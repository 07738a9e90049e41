"""Multi-colour SOR and SSOR Gibbs samplers.

Counterpart of ``src/sampler/sor_sampler.{hh,cc}`` and
``ssor_sampler.{hh,cc}``.  One stochastic sweep (cf. ``sor_sampler.cc:37-59``):

    c   = f + sqrt(D (2 - omega) / omega) . xi,      xi ~ N(0, I_n)
    c  += B Sigma^{-1/2} xi',                        xi' ~ N(0, I_m)   [low-rank]
    x  <- SOR_sweep(c, x)   (multi-colour, incl. Woodbury low-rank correction)

with D the diagonal of the stencil part.  This is Gibbs sampling via the matrix
splitting M = D/omega + L_c + B Sigma^{-1} B^T (Fox & Parker 2017): the injected
noise covariance M + M^T - A = D (2-omega)/omega + B Sigma^{-1} B^T is exactly
reproduced by the two noise terms, so the stationary distribution is the exact
target N(A^{-1} f, A^{-1}) for *any* colour order - only the mixing rate depends
on the ordering.

All sweeps support arbitrary leading batch dimensions (many independent chains)
through vmap.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.coloring import Coloring
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD, SORSmoother
from .base import Sampler


class SORSampler(Sampler):
    """Forward or backward stochastic SOR (Gibbs) sweep."""

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        direction: str = FORWARD,
        coloring: Optional[Coloring] = None,
    ):
        super().__init__(op)
        self.omega = float(omega)
        self.nsmooth = int(nsmooth)
        self.smoother = SORSmoother(op, omega, 1, direction, coloring)
        # sqrt(D (2 - omega) / omega), cf. sor_sampler.cc:22-27
        self.sqrt_precision_diag = jnp.sqrt(
            op.diag_stencil() * (2.0 - self.omega) / self.omega
        )
        if op.lowrank is not None:
            self.Sigma_inv_sqrt = 1.0 / jnp.sqrt(op.lowrank.Sigma_diag)

    def random_rhs(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        """The noisy right-hand side c (cf. ``sor_sampler.cc:39-56``).

        The batch (chain) shape is taken from the chain state x, so an unbatched
        f broadcasts over many chains with *independent* noise per chain.
        """
        op = self.op
        kx, kb = jax.random.split(key)
        xi = jax.random.normal(kx, x.shape, dtype=x.dtype)
        c = f + self.sqrt_precision_diag * xi
        if op.lowrank is not None:
            m = op.m_lowrank
            batch = x.shape[: x.ndim - len(op.vshape)]
            xi_lr = jax.random.normal(kb, batch + (m,), dtype=x.dtype)
            c = c + jnp.tensordot(
                xi_lr * self.Sigma_inv_sqrt, op.lowrank.B, axes=([xi_lr.ndim - 1], [0]),
                precision=jax.lax.Precision.HIGHEST,
            )
        return c

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        for k in range(self.nsmooth):
            c = self.random_rhs(jax.random.fold_in(key, k), f, x)
            x = self.smoother.apply(c, x)
        return x


class SSORSampler(Sampler):
    """Forward Gibbs sweep then backward Gibbs sweep
    (cf. ``src/sampler/ssor_sampler.cc:9-16``)."""

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        coloring: Optional[Coloring] = None,
    ):
        super().__init__(op)
        self.nsmooth = int(nsmooth)
        from ..ops.coloring import coloring_for

        coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.forward = SORSampler(op, omega, 1, FORWARD, coloring)
        self.backward = SORSampler(op, omega, 1, BACKWARD, coloring)

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        for k in range(self.nsmooth):
            kf, kb = jax.random.split(jax.random.fold_in(key, k))
            x = self.forward.apply(kf, f, x)
            x = self.backward.apply(kb, f, x)
        return x


def sampler_factory(name: str, omega: float, nsmooth: int, direction: str = FORWARD):
    """cf. ``SamplerFactory`` (``src/sampler/sampler.hh:77-85``)."""
    name = name.upper()
    if name == "SOR":
        return lambda op, coloring=None: SORSampler(op, omega, nsmooth, direction, coloring)
    if name == "SSOR":
        return lambda op, coloring=None: SSORSampler(op, omega, nsmooth, coloring)
    raise ValueError(f"unknown sampler '{name}'")
