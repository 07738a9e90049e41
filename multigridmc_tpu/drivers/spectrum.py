"""Posterior covariance spectrum diagnostic driver.

Counterpart of ``src/driver_spectrum.cc:17-85``: assemble the 2d FEM
prior + measured posterior, compute the dense covariance eigenvalues, and write
them sorted to ``spectrum.csv``.

Usage: ``python -m multigridmc_tpu.drivers.spectrum CONFIGFILE``
"""

from __future__ import annotations

import sys

import numpy as np

from ..models.posterior import measured_operator
from ..models.prior import shiftedlaplace_fem
from ..utils.config import load_config
from ..utils.runtime import configure_runtime
from .common import build_correlation_model, build_lattice, measurement_params


def main(argv=None):
    configure_runtime()
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 1:
        print("Usage: python -m multigridmc_tpu.drivers.spectrum CONFIGURATIONFILE")
        sys.exit(-1)
    config = load_config(argv[0])
    lattice = build_lattice(config)
    model = build_correlation_model(config)
    prior = shiftedlaplace_fem(lattice, model)
    op = measured_operator(prior, measurement_params(config))
    # dense covariance = precision^{-1} (driver_spectrum.cc:59; linear_operator.hh:180-183)
    Q = op.to_dense()
    cov = np.linalg.inv(Q)
    evals = np.sort(np.real(np.linalg.eigvals(cov)))[::-1]
    with open("spectrum.csv", "w") as out:
        for j, ev in enumerate(evals):
            out.write(f"{j}, {ev:e}\n")
    print(f"wrote {len(evals)} eigenvalues to spectrum.csv")


if __name__ == "__main__":
    main()
