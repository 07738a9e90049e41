"""Deterministic multigrid solve driver.

Counterpart of ``src/driver_mg.cc``: build the operator from config,
solve ``A x = b`` with multigrid-preconditioned Richardson for a random rhs, and
write ``solution.vtk``.

Usage: ``python -m multigridmc_tpu.drivers.mg CONFIGFILE``
"""

from __future__ import annotations

import sys
import time

import jax
import numpy as np

from ..solvers.loop import IterativeSolverParameters, LoopSolver
from ..solvers.multigrid import MultigridPreconditioner
from ..utils.config import echo_config, load_config
from ..utils.vtk import VTKWriter
from ..utils.runtime import configure_runtime
from .common import build_operators


def main(argv=None):
    configure_runtime()
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Usage: python -m multigridmc_tpu.drivers.mg CONFIGURATIONFILE")
        sys.exit(-1)
    print()
    print("+------------------------------+")
    print("!       Multigrid solver       !")
    print("+------------------------------+")
    print()
    config = load_config(argv[0])
    echo_config(config)
    prior, op, mparams = build_operators(config)
    mg = config.multigrid
    t0 = time.perf_counter()
    preconditioner = MultigridPreconditioner(
        op,
        nlevel=mg.nlevel,
        smoother=mg.smoother,
        npresmooth=mg.npresmooth,
        npostsmooth=mg.npostsmooth,
        omega=mg.omega,
        cycle=mg.cycle,
        coarse_scaling=mg.coarse_scaling,
    )
    print(f"multigrid setup time = {time.perf_counter() - t0:.3f} s")

    it = config.iterative_solver
    solver = LoopSolver(
        op,
        preconditioner,
        IterativeSolverParameters(
            rtol=it.rtol, atol=it.atol, maxiter=it.maxiter, verbose=it.verbose
        ),
    )
    # random rhs b ~ N(0, 1) per vertex (driver_mg.cc:165-172, seed 1482817)
    key = jax.random.PRNGKey(1482817)
    b = jax.random.normal(key, op.lattice.vshape)

    t0 = time.perf_counter()
    # device-resident while_loop unless per-iteration reporting was requested
    # (verbose >= 2 prints the reference's residual/contraction table)
    result = solver.solve(b) if it.verbose >= 2 else solver.solve_jit(b)
    jax.block_until_ready(result.x)
    print(f"solve time = {time.perf_counter() - t0:.3f} s")

    writer = VTKWriter("solution.vtk", op.lattice, 1)
    writer.add_state(np.asarray(result.x), "solution")
    writer.write()


if __name__ == "__main__":
    main()
