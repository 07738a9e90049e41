"""Config-system tests: parse reference-format template config files
(``parameters_template.cfg`` / ``measurements_template.cfg``, kept in
tests/fixtures) unchanged."""

import textwrap
from pathlib import Path

import numpy as np
import pytest

from multigridmc_tpu.utils.config import load_config, parse_config

TEMPLATE = textwrap.dedent(
    """
    // comment
    general = {
        dim = 2;
        do_cholesky = true;
        do_multigridmc = true;
        operator = "posterior";
    }
    lattice = {
        nx = 32;
        ny = 32;
        nz = 32;
    }
    multigrid = {
        smoother = "SOR";
        nlevel = 4;
        cycle = 2;
        omega = 1.0;
    }
    sampling = {
        timeseries = {
            nsamples = 10000;
            nwarmup = 1000;
        }
        convergence = {
            nsteps = 16;
            nsamples = 1000;
        }
    }
    measurements = {
        radius = 0.0;
        sample_location = [0.5, 0.5];
        variance_scaling = 1.0;
        measure_global = false;
        filename = "";
    }
    """
)


def test_parse_basic():
    raw = parse_config(TEMPLATE)
    assert raw["general"]["dim"] == 2
    assert raw["general"]["do_cholesky"] is True
    assert raw["general"]["operator"] == "posterior"
    assert raw["lattice"]["nx"] == 32
    assert raw["multigrid"]["cycle"] == 2
    assert raw["multigrid"]["omega"] == 1.0
    assert raw["sampling"]["timeseries"]["nsamples"] == 10000
    assert raw["measurements"]["sample_location"] == [0.5, 0.5]


FIXTURES = Path(__file__).resolve().parent / "fixtures"


def test_load_reference_template(tmp_path):
    """A reference-format template (tests/fixtures) parses unchanged."""
    import shutil

    shutil.copy(FIXTURES / "parameters_template.cfg", tmp_path / "params.cfg")
    shutil.copy(FIXTURES / "measurements_template.cfg",
                tmp_path / "measurements_template.cfg")
    config = load_config(tmp_path / "params.cfg")
    assert config.general.dim == 2
    assert config.general.do_cholesky is True
    assert config.lattice.nx == 32
    assert config.multigrid.nlevel == 4
    assert config.multigrid.cycle == 2
    assert config.sampling.nsamples == 10000
    assert config.sampling.nwarmup == 1000
    assert config.prior.pdemodel == "shiftedlaplace_fd"
    assert config.constant_correlationlength.Lambda == 0.2
    m = config.measurements
    assert m.n == 8
    assert m.measurement_locations.shape == (8, 2)
    np.testing.assert_allclose(m.sample_location, [0.5, 0.5])
    assert len(m.mean) == 8 and len(m.variance) == 8
    assert m.radius == 0.0
    assert m.measure_global is False


def test_unknown_key_warns(tmp_path, capsys):
    """A typo'd key must not silently become a default (the reference echoes every parsed value, parameters.cc:67-68)."""
    from multigridmc_tpu.utils.config import load_config

    cfg = tmp_path / "t.cfg"
    cfg.write_text(
        'general = { dim = 2; do_cholseky = true; };\n'
        'lattice = { nx = 16; ny = 16; };\n'
        'bogus_section = { a = 1; };\n'
    )
    config = load_config(cfg)
    err = capsys.readouterr().err
    assert "do_cholseky" in err
    assert "bogus_section" in err
    assert config.lattice.nx == 16
    assert config.general.do_cholesky is False  # typo did NOT enable it


def test_echo_config(tmp_path, capsys):
    from multigridmc_tpu.utils.config import echo_config, load_config

    cfg = tmp_path / "t.cfg"
    cfg.write_text('lattice = { nx = 48; ny = 24; };\n')
    config = load_config(cfg)
    echo_config(config)
    out = capsys.readouterr().out
    assert "nx = 48" in out and "ny = 24" in out
    assert "multigrid" in out and "nlevel" in out  # defaults echoed too
