"""End-to-end driver smoke tests: run the CLI drivers in subprocesses on a tiny
config (the same surface a reference user touches) and check their outputs."""

import json
import os
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]

CONFIG = textwrap.dedent(
    """
    general = {
        dim = 2;
        do_cholesky = true;
        do_ssor = true;
        do_multigridmc = true;
        save_posterior_statistics = true;
        measure_convergence = true;
        operator = "posterior";
    }
    lattice = { nx = 8; ny = 8; nz = 8; }
    cholesky = { factorisation = "dense"; }
    smoother = { nsmooth = 1; omega = 1.0; }
    iterative_solver = { rtol = 1.E-11; atol = 1.E-7; maxiter = 100; verbose = 1; }
    multigrid = {
        smoother = "SOR"; coarse_solver = "Cholesky";
        npresmooth = 1; npostsmooth = 1; ncoarsesmooth = 1;
        omega = 1.0; nlevel = 2; cycle = 2; coarse_scaling = 1.0; verbose = 0;
    }
    sampling = {
        timeseries = { nsamples = 50; nwarmup = 10; }
        convergence = { nsteps = 4; nsamples = 64; }
    }
    prior = { pdemodel = "shiftedlaplace_fd"; correlationlengthmodel = "constant"; }
    constantcorrelationlengthmodel = { Lambda = 0.2; }
    periodiccorrelationlengthmodel = { Lambda_min = 0.2; Lambda_max = 0.4; }
    measurements = {
        radius = 0.0;
        sample_location = [0.5, 0.5];
        variance_scaling = 1.0;
        measure_global = false;
        mean_global = 1.0;
        variance_global = 0.01;
        filename = "measurements.cfg";
    }
    """
)

MEASUREMENTS = textwrap.dedent(
    """
    dim = 2;
    n = 3;
    measurement_locations = [0.25, 0.25, 0.75, 0.3, 0.4, 0.8];
    mean = [1.0, 2.0, 0.5];
    variance = [0.01, 0.02, 0.01];
    """
)


@pytest.fixture(scope="module")
def config_dir(tmp_path_factory):
    d = tmp_path_factory.mktemp("driver_cfg")
    (d / "params.cfg").write_text(CONFIG)
    (d / "measurements.cfg").write_text(MEASUREMENTS)
    return d


def run_driver(module, cfg, cwd, timeout=420):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=str(REPO))
    return subprocess.run(
        [sys.executable, "-m", module, str(cfg)],
        capture_output=True, text=True, cwd=str(cwd), env=env, timeout=timeout,
    )


def test_driver_mg(config_dir, tmp_path):
    r = run_driver("multigridmc_tpu.drivers.mg", config_dir / "params.cfg", tmp_path)
    assert r.returncode == 0, r.stderr
    assert "Solver converged" in r.stdout
    assert (tmp_path / "solution.vtk").exists()


def test_driver_mgmc(config_dir, tmp_path):
    r = run_driver("multigridmc_tpu.drivers.mgmc", config_dir / "params.cfg", tmp_path)
    assert r.returncode == 0, r.stderr
    for label in ("cholesky", "ssor", "multigridmc"):
        assert f"{label} time per sample" in r.stdout
        assert (tmp_path / f"timeseries_{label}.txt").exists()
    assert (tmp_path / "convergence_ssor.txt").exists()
    assert (tmp_path / "convergence_multigridmc.txt").exists()
    assert (tmp_path / "posterior.vtk").exists()
    assert (tmp_path / "sample_location.vtk").exists()
    # sampled mean should be in the same ballpark as the exact one
    lines = [l for l in r.stdout.splitlines() if "mean" in l]
    assert any("exact" in l for l in lines)


def test_driver_spectrum(config_dir, tmp_path):
    r = run_driver("multigridmc_tpu.drivers.spectrum", config_dir / "params.cfg", tmp_path)
    assert r.returncode == 0, r.stderr
    spectrum = (tmp_path / "spectrum.csv").read_text().strip().splitlines()
    assert len(spectrum) == 49  # (8-1)^2 eigenvalues
    vals = [float(l.split(",")[1]) for l in spectrum]
    assert all(v > 0 for v in vals)
    assert vals == sorted(vals, reverse=True)


def test_driver_generate_measurements(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(REPO))
    r = subprocess.run(
        [sys.executable, "-m", "multigridmc_tpu.drivers.generate_measurements",
         "--dim", "2", "--nmeas", "4", "--dmin", "0.15"],
        capture_output=True, text=True, env=env, timeout=60,
    )
    assert r.returncode == 0, r.stderr
    from multigridmc_tpu.utils.config import parse_config

    raw = parse_config(r.stdout)
    assert raw["n"] == 4
    assert len(raw["measurement_locations"]) == 8
