"""multigridmc_tpu - a Multigrid Monte Carlo framework in JAX.

A from-scratch JAX/XLA re-design of the capabilities of
nilsfriess/MultigridMC: sampling from high-dimensional lattice Gaussian
distributions pi(x) ~ exp(-1/2 x^T Q x + f^T x) with Multigrid Monte Carlo,
SOR/SSOR Gibbs sampling and Cholesky samplers, plus the matching deterministic
multigrid solver stack.

Design: fields are dense arrays over interior lattice vertices; operators are
stencils applied by fused shift-multiply-accumulate; sequential SOR sweeps become
multi-colour parallel sweeps; Galerkin coarsening is computed by operator probing;
everything jits, vmaps (batched chains) and shards over a device mesh.
"""

from .lattice import Lattice
from .ops.stencil import LowRank, StencilOperator
from .ops.intergrid import prolongate, prolongate_add, restrict
from .ops.coarsen import galerkin_coarsen
from .smoothers import SORSmoother, SSORSmoother

__version__ = "0.1.0"

__all__ = [
    "Lattice",
    "LowRank",
    "StencilOperator",
    "prolongate",
    "prolongate_add",
    "restrict",
    "galerkin_coarsen",
    "SORSmoother",
    "SSORSmoother",
]
