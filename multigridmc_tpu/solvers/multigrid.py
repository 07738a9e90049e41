"""Multigrid hierarchy and the deterministic multigrid preconditioner.

Counterpart of ``src/preconditioner/multigrid_preconditioner.{hh,cc}``
and the hierarchy-construction idiom shared with the MGMC sampler
(``src/sampler/multigridmc_sampler.cc:8-100``): per level a Galerkin-coarsened
operator, a forward pre-smoother and a backward post-smoother; the coarsest level
gets a dense Cholesky solve (coarse lattices are tiny, so a dense on-device
factorisation replaces the reference's sparse CholMod path).

The recursive V/W-cycle (``multigrid_preconditioner.cc:74-101``) is unrolled at
trace time over the static number of levels, producing one fused XLA computation
per cycle.
"""

from __future__ import annotations

from typing import List, Optional

import jax
import jax.numpy as jnp

from ..ops.coarsen import galerkin_coarsen
from ..ops.intergrid import prolongate_add, restrict
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD, SORSmoother, SSORSmoother
from ..utils.runtime import on_accelerator
from .cholesky import DenseCholeskySolver


class MultigridHierarchy:
    """Level stack of Galerkin-coarsened operators (cf.
    ``multigridmc_sampler.cc:76-99``)."""

    def __init__(self, op: StencilOperator, nlevel: int):
        if nlevel < 1:
            raise ValueError("nlevel must be >= 1")
        ops: List[StencilOperator] = [op]
        for level in range(1, nlevel):
            ops.append(galerkin_coarsen(ops[-1]))
        self.operators = ops
        self.nlevel = nlevel

    def __len__(self) -> int:
        return self.nlevel


class MultigridPreconditioner:
    """Deterministic multigrid V/W-cycle preconditioner
    (``multigrid_preconditioner.cc:8-109``).

    Parameters mirror ``MultigridParameters`` (``parameters.hh:145-174``):
    smoother ("SOR" forward-pre / backward-post, or "SSOR" both), npresmooth,
    npostsmooth, cycle (1=V, 2=W), coarse_scaling.  ``distill`` as in
    :class:`multigridmc_tpu.samplers.mgmc.MultigridMCSampler`.
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        smoother: str = "SOR",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        hierarchy: Optional[MultigridHierarchy] = None,
        distill: object = "auto",
    ):
        self.hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        smoother = smoother.upper()
        self.presmoothers = []
        self.postsmoothers = []
        for level_op in self.hierarchy.operators:
            if smoother == "SOR":
                self.presmoothers.append(SORSmoother(level_op, omega, npresmooth, FORWARD))
                self.postsmoothers.append(SORSmoother(level_op, omega, npostsmooth, BACKWARD))
            elif smoother == "SSOR":
                self.presmoothers.append(SSORSmoother(level_op, omega, npresmooth))
                self.postsmoothers.append(SSORSmoother(level_op, omega, npostsmooth))
            else:
                raise ValueError(f"unknown smoother '{smoother}'")
        # The reference hard-forces a Cholesky coarse solve with a warning
        # (multigrid_preconditioner.cc:41-45); coarse lattices are tiny so a
        # dense on-device factorisation is the equivalent.
        self.coarse_solver = DenseCholeskySolver(self.hierarchy.operators[-1])
        self._build_distilled(distill)

    def _build_distilled(self, distill):
        """Distil the deterministic coarse subtree into one matrix (the
        noise-free variant of samplers/distill.py): below the distill level
        the recursion's latency-bound op tail becomes a single batched
        matmul.  Same gating as the sampler."""
        self.distilled = None
        self.distill_level = None
        if distill is False or (distill == "auto" and not on_accelerator()):
            return
        from ..samplers.distill import distill_subtree, pick_distill_level

        li = pick_distill_level(self.hierarchy.operators)
        if li is None:
            return
        self.distilled = distill_subtree(
            self.hierarchy.operators[li:],
            self.presmoothers[li:], self.postsmoothers[li:],
            self.coarse_solver, self.cycle, self.coarse_scaling,
            noise=False,
        )
        self.distill_level = li

    def _solve(self, level: int, b: jax.Array) -> jax.Array:
        """Recursive cycle, unrolled at trace time; x is zero-initialised at every
        level entry (``multigrid_preconditioner.cc:74-101``)."""
        nlevel = self.hierarchy.nlevel
        op = self.hierarchy.operators[level]
        x = jnp.zeros_like(b)
        if level == nlevel - 1:
            return self.coarse_solver.apply(b)
        vdim = len(op.vshape)
        ncycle = self.cycle if level > 0 else 1
        for _ in range(ncycle):
            x = self.presmoothers[level].apply(b, x)
            r = b - op.apply(x)
            b_coarse = restrict(r, dim=op.lattice.dim)
            if (self.distilled is not None
                    and level + 1 == self.distill_level and b.ndim > vdim):
                x_coarse = self.distilled.solve(b_coarse)
            else:
                x_coarse = self._solve(level + 1, b_coarse)
            x = prolongate_add(self.coarse_scaling, x_coarse, x, dim=op.lattice.dim)
            x = self.postsmoothers[level].apply(b, x)
        return x

    def apply(self, b: jax.Array) -> jax.Array:
        """One multigrid cycle applied to b (x implicitly zero-initialised)."""
        return self._solve(0, b)
