"""Multi-colour SOR / SSOR smoothers.

Counterpart of ``src/smoother/sor_smoother.{hh,cc}`` and
``ssor_smoother.{hh,cc}``.  The reference's lexicographic CSR sweep
(``sor_smoother.cc:56-78``) is inherently sequential; here the sweep order is a
multi-colour order (see :mod:`multigridmc_tpu.ops.coloring`), so one sweep is
``n_colors`` fully parallel masked stencil applications:

    for colour c in order:
        x <- x + mask_c * omega * (b - A_stencil x) / diag

This is SOR with splitting ``M = D/omega + L_c`` where ``L_c`` is the strictly
block-lower part of ``A_stencil`` under the colour order.

Low-rank operators (posterior precision ``A = A_s + B Sigma^{-1} B^T``) follow the
reference's Woodbury-corrected splitting (math in ``sor_smoother.hh:20-43``): the
sweep runs on the stencil part only, then applies

    x <- x - B_bar (B^T x),
    B_bar = M^{-1} B (Sigma + B^T M^{-1} B)^{-1}

with ``M = L_c + D/omega`` (forward) or its transpose (backward).  ``M^{-1} B`` is
computed at setup by colour-ordered forward substitution - exact because M is
block-triangular in the colour order.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp

from .ops.coloring import Coloring, coloring_for
from .ops.stencil import StencilOperator

FORWARD = "forward"
BACKWARD = "backward"


def color_order(n_colors: int, direction: str) -> Tuple[int, ...]:
    order = tuple(range(n_colors))
    return order if direction == FORWARD else tuple(reversed(order))


def splitting_solve(
    op: StencilOperator,
    masks: jax.Array,
    omega: float,
    order: Tuple[int, ...],
    v: jax.Array,
) -> jax.Array:
    """Solve ``(L_c + D/omega) y = v`` by colour-ordered forward substitution.

    Exact because the colour-order splitting matrix is block lower-triangular:
    colour c couples only to previously updated colours.
    """
    diag = op.diag_stencil()
    y = jnp.zeros_like(v)
    for c in order:
        s = op.apply_offdiag(y)
        y = y + masks[c] * ((v - s) * omega / diag)
    return y


def sor_sweep(
    op: StencilOperator,
    masks: jax.Array,
    omega: float,
    order: Tuple[int, ...],
    b: jax.Array,
    x: jax.Array,
) -> jax.Array:
    """One multi-colour SOR sweep on the stencil part
    (cf. ``sor_smoother.cc:56-78``: ``x[l] += omega*(b[l] - (Ax)[l]) / a_ll``)."""
    diag = op.diag_stencil()
    for c in order:
        ax = op.apply_stencil(x)
        x = x + masks[c] * (omega * (b - ax) / diag)
    return x


def compute_B_bar(
    op: StencilOperator, masks: jax.Array, omega: float, order: Tuple[int, ...]
) -> jax.Array:
    """Precompute the Woodbury correction factor ``B_bar`` for one direction
    (cf. ``sor_smoother.cc:17-37``).  Returns shape ``(m, *vshape)``."""
    lr = op.lowrank
    Y = jax.jit(jax.vmap(lambda col: splitting_solve(op, masks, omega, order, col)))(lr.B)
    # S = Sigma + B^T M^{-1} B   (m x m); full precision - see LowRank notes
    hi = jax.lax.Precision.HIGHEST
    S = jnp.diag(lr.Sigma_diag) + jnp.einsum("m...,k...->mk", lr.B, Y, precision=hi)
    W = jnp.linalg.inv(S)
    return jnp.einsum("l...,lk->k...", Y, W, precision=hi)


class SORSmoother:
    """Deterministic multi-colour SOR smoother, forward or backward.

    Mirrors ``SORSmoother`` (``src/smoother/sor_smoother.hh:44-125``).  Note: the
    reference's ``apply`` runs ``nsmooth^2`` sparse sweeps due to a nested loop
    quirk (``sor_smoother.cc:41-53`` vs ``:64``); here ``nsmooth`` means what it
    says - callers in the reference always use nsmooth=1 sub-sweeps anyway.
    """

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        direction: str = FORWARD,
        coloring: Optional[Coloring] = None,
    ):
        self.op = op
        self.omega = float(omega)
        self.nsmooth = int(nsmooth)
        self.direction = direction
        self.coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.masks = jnp.asarray(self.coloring.masks(), dtype=op.coeffs.dtype)
        self.order = color_order(self.coloring.n_colors, direction)
        self.B_bar = (
            compute_B_bar(op, self.masks, self.omega, self.order)
            if op.lowrank is not None
            else None
        )

    def sweep_stencil(self, b: jax.Array, x: jax.Array) -> jax.Array:
        return sor_sweep(self.op, self.masks, self.omega, self.order, b, x)

    def _lowrank_correct(self, x: jax.Array) -> jax.Array:
        bt_x = self.op.lowrank.bt(x)  # (*batch, m)
        return x - jnp.tensordot(
            bt_x, self.B_bar, axes=([bt_x.ndim - 1], [0]),
            precision=jax.lax.Precision.HIGHEST,
        )

    def apply(self, b: jax.Array, x: jax.Array) -> jax.Array:
        """``nsmooth`` SOR sweeps, each followed by the low-rank correction
        (cf. ``sor_smoother.cc:41-53``)."""
        for _ in range(self.nsmooth):
            x = self.sweep_stencil(b, x)
            if self.B_bar is not None:
                x = self._lowrank_correct(x)
        return x


class SSORSmoother:
    """Symmetric SOR: one forward then one backward sweep per smoothing step
    (cf. ``src/smoother/ssor_smoother.cc:9-16``)."""

    def __init__(
        self,
        op: StencilOperator,
        omega: float = 1.0,
        nsmooth: int = 1,
        coloring: Optional[Coloring] = None,
    ):
        self.nsmooth = int(nsmooth)
        coloring = coloring or coloring_for(op.offsets, op.vshape)
        self.forward = SORSmoother(op, omega, 1, FORWARD, coloring)
        self.backward = SORSmoother(op, omega, 1, BACKWARD, coloring)
        self.op = op

    def apply(self, b: jax.Array, x: jax.Array) -> jax.Array:
        for _ in range(self.nsmooth):
            x = self.forward.apply(b, x)
            x = self.backward.apply(b, x)
        return x


def smoother_factory(name: str, omega: float, nsmooth: int, direction: str = FORWARD):
    """Factory mirroring ``SmootherFactory`` (``src/smoother/smoother.hh:39-44``):
    returns a callable ``op -> smoother`` for per-level instantiation."""
    name = name.upper()
    if name == "SOR":
        return lambda op: SORSmoother(op, omega, nsmooth, direction)
    if name == "SSOR":
        return lambda op: SSORSmoother(op, omega, nsmooth)
    raise ValueError(f"unknown smoother '{name}'")
