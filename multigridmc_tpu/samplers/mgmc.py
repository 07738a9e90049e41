"""Multigrid Monte Carlo sampler - the flagship algorithm.

Counterpart of ``src/sampler/multigridmc_sampler.{hh,cc}`` (Goodman &
Sokal 1989): a stochastic multigrid V/W-cycle whose smoothers are multi-colour
SOR/SSOR Gibbs sweeps and whose coarse-level "solve" is an exact Cholesky (or
SSOR Gibbs) sample.

Construction mirrors ``multigridmc_sampler.cc:8-100``: per level a
Galerkin-coarsened operator, a forward pre-sampler and a backward post-sampler;
the coarsest level gets a Cholesky or SSOR sampler.  The recursive cycle
(``multigridmc_sampler.cc:103-130``) unrolls at trace time:

    sample(level):
        if coarsest:  x_L ~ coarse_sampler(f_L, x_L)
        else, repeated ``cycle`` times on levels > 0:
            x_l  ~ presampler(f_l, x_l)                     (forward Gibbs)
            f_{l+1} = R (f_l - A_l x_l)
            x_{l+1} = 0;  sample(level+1)
            x_l += coarse_scaling * P x_{l+1}
            x_l  ~ postsampler(f_l, x_l)                    (backward Gibbs)

Chain-state semantics match ``multigridmc_sampler.cc:133-139``: the fine-level x
is carried across calls (NOT zeroed - unlike the deterministic preconditioner),
coarse-level states are zero-initialised at each visit.

The whole cycle is one jittable pure function of ``(key, f, x)`` and batches over
leading chain dimensions, so thousands of independent chains run in lockstep on
one device - this is where the accelerator throughput comes from.
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp

from ..ops.intergrid import prolongate_add, restrict
from ..ops.stencil import StencilOperator
from ..smoothers import BACKWARD, FORWARD
from ..solvers.multigrid import MultigridHierarchy
from ..utils.runtime import on_accelerator
from .base import Sampler
from .cholesky import DenseCholeskySampler
from .sor import SORSampler, SSORSampler


class MultigridMCSampler(Sampler):
    """cf. ``MultigridMCSampler`` (``multigridmc_sampler.hh:24-73``).

    Parameters mirror ``MultigridParameters`` (``parameters.hh:145-174``) plus the
    Cholesky factorisation choice (``parameters.hh:87-91``).  ``distill``
    replaces the coarse subtree by its exact affine-Gaussian map
    (:mod:`samplers.distill`): ``True`` forces it, ``False`` disables it,
    ``"auto"`` enables it when the default device is an accelerator.
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        smoother: str = "SOR",
        coarse_solver: str = "Cholesky",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        ncoarsesmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        cholesky_factorisation: str = "dense",
        hierarchy: Optional[MultigridHierarchy] = None,
        verbose: int = 0,
        distill: object = "auto",
        sweep_schedule: str = "fixed",
        distill_precision: Optional[str] = None,
    ):
        super().__init__(op)
        self.hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        self.nlevel = self.hierarchy.nlevel
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        sweep_schedule = sweep_schedule.lower()
        if sweep_schedule not in ("fixed", "alternating"):
            raise ValueError(f"invalid sweep_schedule '{sweep_schedule}'")
        self.sweep_schedule = sweep_schedule
        #: matmul precision tier of the distilled-subtree products
        #: ("highest" / "high" / "default"); None = "highest"
        #: (see samplers/distill.py PRECISION)
        self.distill_precision = distill_precision

        smoother = smoother.upper()
        self.presamplers = []
        self.postsamplers = []
        for level_op in self.hierarchy.operators:
            if smoother == "SOR":
                self.presamplers.append(SORSampler(level_op, omega, npresmooth, FORWARD))
                self.postsamplers.append(SORSampler(level_op, omega, npostsmooth, BACKWARD))
            elif smoother == "SSOR":
                self.presamplers.append(SSORSampler(level_op, omega, npresmooth))
                self.postsamplers.append(SSORSampler(level_op, omega, npostsmooth))
            else:
                raise ValueError(f"invalid sampler '{smoother}'")

        coarse_op = self.hierarchy.operators[-1]
        if coarse_solver.lower() == "cholesky":
            # The reference switches sparse/dense factorisation here
            # (multigridmc_sampler.cc:52-63); the coarse level is tiny and
            # must stay jittable inside the cycle, so both choices map to the
            # dense on-device factorisation (distributionally identical).
            self.coarse_sampler = DenseCholeskySampler(coarse_op)
        elif coarse_solver.upper() == "SSOR":
            self.coarse_sampler = SSORSampler(coarse_op, omega, ncoarsesmooth)
        else:
            raise ValueError(f"invalid coarse sampler '{coarse_solver}'")

        if verbose > 0:
            for level, level_op in enumerate(self.hierarchy.operators):
                print(f"  level {level} lattice : {level_op.lattice.get_info()}")

        self._build_distilled(distill)
        self._build_alternate()

    def _build_distilled(self, distill):
        """Affine distillation of the coarse subtree (samplers/distill.py):
        below the distill level the recursion's hundreds of small
        latency-bound ops are replaced by the subtree's *exact*
        affine-Gaussian map ``x = T f + S xi`` - two dense matmuls per
        invocation.  ``distill="auto"`` enables it when the default device is an
        accelerator."""
        self.distilled = None
        self.distill_level = None
        if distill is False or (distill == "auto" and not on_accelerator()):
            return
        from .distill import pick_distill_level

        li = pick_distill_level(self.hierarchy.operators)
        if li is None:
            return
        self.distilled = self._make_distilled(
            li, self.presamplers, self.postsamplers)
        self.distill_level = li

    def _make_distilled(self, li, pre, post):
        from .distill import distill_subtree

        return distill_subtree(
            self.hierarchy.operators[li:], pre[li:], post[li:],
            self.coarse_sampler, self.cycle, self.coarse_scaling,
            noise=True, precision=self.distill_precision,
        )

    def _build_alternate(self):
        """Parity-1 engine for ``sweep_schedule="alternating"``: the same
        hierarchy with the pre/post sampler roles swapped (odd steps presample
        backward and postsample forward).  Measured on the reference's own
        warmup diagnostic (docs/CONVERGENCE.md round-4 scan): the alternating
        schedule contracts q_mean at 0.505/step at omega=1.4 vs 0.617 for the
        fixed colored schedule and 0.685 for the reference's lexicographic
        order (``sor_smoother.cc:56-78``) - at identical per-step cost.  The
        stationary distribution is exact for either parity (step-dependent
        composition of valid Gibbs kernels)."""
        self._alt = None
        if self.sweep_schedule != "alternating":
            return
        alt_distilled = None
        if self.distilled is not None:
            alt_distilled = self._make_distilled(
                self.distill_level, self.postsamplers, self.presamplers)
        self._alt = dict(
            presamplers=self.postsamplers, postsamplers=self.presamplers,
            distilled=alt_distilled,
        )

    def _engine(self, parity: int):
        """(presamplers, postsamplers, distilled) for a step parity; parity 1
        exists only under ``sweep_schedule="alternating"``."""
        if parity and self._alt is not None:
            a = self._alt
            return a["presamplers"], a["postsamplers"], a["distilled"]
        return self.presamplers, self.postsamplers, self.distilled

    def _sample(self, level: int, key: jax.Array, f: jax.Array, x: jax.Array,
                parity: int = 0) -> jax.Array:
        """Recursive stochastic cycle (``multigridmc_sampler.cc:103-130``),
        unrolled at trace time.  Each level's descend (pre-sweep, residual,
        restriction) and ascend (prolongation, post-sweep) visit, the coarse
        sample and the distilled subtree run under a named scope
        (``L<level>_descend``, ``L<level>_ascend``, ``coarse``,
        ``distilled``), so profiler traces attribute device time to them."""
        if level == self.nlevel - 1:
            with jax.named_scope("coarse"):
                return self.coarse_sampler.apply(key, f, x)
        presamplers, postsamplers, distilled = self._engine(parity)
        op = self.hierarchy.operators[level]
        vdim = len(op.vshape)
        ncycle = self.cycle if level > 0 else 1
        for j in range(ncycle):
            kpre, kcoarse, kpost = jax.random.split(jax.random.fold_in(key, j), 3)
            with jax.named_scope(f"L{level}_descend"):
                x = presamplers[level].apply(kpre, f, x)
                r = f - op.apply(x)
                f_coarse = restrict(r, dim=op.lattice.dim)
            if (distilled is not None
                    and level + 1 == self.distill_level
                    and f_coarse.ndim > vdim):
                with jax.named_scope("distilled"):
                    x_coarse = distilled.apply(kcoarse, f_coarse)
            else:
                x_coarse = jnp.zeros_like(f_coarse)
                x_coarse = self._sample(level + 1, kcoarse, f_coarse, x_coarse,
                                        parity)
            with jax.named_scope(f"L{level}_ascend"):
                x = prolongate_add(self.coarse_scaling, x_coarse, x, dim=op.lattice.dim)
                x = postsamplers[level].apply(kpost, f, x)
        return x

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array,
              parity: int = 0) -> jax.Array:
        """One MGMC step: chain state x is carried, not zeroed
        (``multigridmc_sampler.cc:133-139``).

        ``parity`` (static 0/1) selects the sweep-direction engine under
        ``sweep_schedule="alternating"`` (odd steps swap the pre/post roles);
        it is ignored under the default fixed schedule.  Step loops alternate
        via a static 2-step unroll - see :meth:`apply_pair`."""
        return self._sample(0, key, f, x, int(parity) & 1)

    def apply_pair(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        """Two MGMC steps (parities 0 then 1): the scan body for the
        alternating schedule (under the fixed schedule this is just two
        ordinary steps).  Independent keys per sub-step."""
        k0, k1 = jax.random.split(key)
        return self.apply(k1, f, self.apply(k0, f, x), parity=1)

    def apply_indexed(self, key: jax.Array, f: jax.Array, x: jax.Array,
                      k: jax.Array) -> jax.Array:
        """One step that derives the schedule parity from the (possibly
        traced) step index ``k``: under the alternating schedule both parity
        engines are traced into a ``lax.cond`` and the branch is picked at
        run time, so driver scan loops stay one-step-per-iteration."""
        if self._alt is None:
            return self.apply(key, f, x)
        return jax.lax.cond(
            (jnp.asarray(k) % 2) == 0,
            lambda: self.apply(key, f, x, parity=0),
            lambda: self.apply(key, f, x, parity=1),
        )
