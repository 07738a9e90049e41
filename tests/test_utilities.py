"""Tests for QoIs, measurement generation, VTK output, and the runtime config."""

import numpy as np
import jax.numpy as jnp
import pytest

from multigridmc_tpu.lattice import Lattice
from multigridmc_tpu.drivers.generate_measurements import (
    format_config,
    sample_points,
)
from multigridmc_tpu.qoi import DomainAverageQoI, LinearQoI, qoi_factory
from multigridmc_tpu.utils.config import parse_config
from multigridmc_tpu.utils.vtk import VTKWriter, write_vtk_circle


def test_sample_points_separation():
    pts = sample_points(9, 2, dmin=0.2)
    assert pts.shape == (9, 2)
    for i in range(9):
        assert pts[i].min() >= 0.1 - 1e-12 and pts[i].max() <= 0.9 + 1e-12
        for j in range(i):
            assert np.linalg.norm(pts[i] - pts[j]) >= 0.2


def test_generated_config_parses():
    pts = sample_points(5, 2, dmin=0.15)
    text = format_config(2, 4, pts[:-1], pts[-1], np.ones(4), np.full(4, 1e-6))
    raw = parse_config(text)
    assert raw["n"] == 4
    assert len(raw["measurement_locations"]) == 8
    assert len(raw["variance"]) == 4


def test_qoi():
    lat = Lattice((8, 8))
    rng = np.random.default_rng(0)
    x = jnp.asarray(rng.normal(size=lat.vshape))
    w = jnp.asarray(rng.normal(size=lat.vshape))
    q = LinearQoI(w)
    np.testing.assert_allclose(float(q(x)), float(jnp.vdot(w, x)), rtol=1e-12)
    avg = qoi_factory("domain_average", lat)
    np.testing.assert_allclose(
        float(avg(x)), float(x.sum()) * lat.cell_volume, rtol=1e-12
    )


def test_vtk_writer_2d(tmp_path):
    lat = Lattice((4, 4))
    rng = np.random.default_rng(1)
    field = rng.normal(size=lat.vshape)
    path = tmp_path / "out.vtk"
    w = VTKWriter(str(path), lat)
    w.add_state(field, "mean")
    w.write()
    text = path.read_text()
    assert "DATASET STRUCTURED_POINTS" in text
    assert "DIMENSIONS 5 5 1" in text
    assert "SCALARS mean double 1" in text
    values = [float(v) for v in text.split("LOOKUP_TABLE default\n")[1].split()]
    assert len(values) == 25
    # boundary zeros, interior matches (x fastest)
    grid = np.asarray(values).reshape(5, 5)
    assert np.all(grid[0] == 0) and np.all(grid[:, 0] == 0)
    np.testing.assert_allclose(grid[1:-1, 1:-1], field, rtol=1e-6)


def test_vtk_circle(tmp_path):
    path = tmp_path / "circle.vtk"
    write_vtk_circle([0.5, 0.5], 0.1, str(path))
    text = path.read_text()
    assert "POLYDATA" in text and "POINTS 100 double" in text


def test_vtk_writer_3d(tmp_path):
    lat = Lattice((4, 4, 4))
    rng = np.random.default_rng(5)
    field = rng.normal(size=lat.vshape)
    path = tmp_path / "out3d.vtk"
    w = VTKWriter(str(path), lat)
    w.add_state(field, "solution")
    w.write()
    text = path.read_text()
    assert "DIMENSIONS 5 5 5" in text
    values = [float(v) for v in text.split("LOOKUP_TABLE default\n")[1].split()]
    assert len(values) == 125
    grid = np.asarray(values).reshape(5, 5, 5)
    assert np.all(grid[0] == 0) and np.all(grid[-1] == 0)
    np.testing.assert_allclose(grid[1:-1, 1:-1, 1:-1], field, rtol=1e-6)


def test_timer():
    from multigridmc_tpu.utils.profiling import Timer

    t = Timer()
    with t.phase("a"):
        sum(range(1000))
    with t.phase("b"):
        sum(range(1000))
    assert set(t.phases) == {"a", "b"}
    assert "total" in t.report()


def test_chain_checkpoint_roundtrip(tmp_path):
    import jax
    import jax.numpy as jnp

    from multigridmc_tpu.utils.checkpoint import ChainState

    rng = np.random.default_rng(9)
    x = rng.normal(size=(4, 7, 7))
    key = jax.random.PRNGKey(1234)
    state = ChainState(
        x=x, key=key, step=42, stats={"sum_x": rng.normal(size=49)}
    )
    p = tmp_path / "chain.npz"
    state.save(p)
    restored = ChainState.load(p)
    np.testing.assert_array_equal(restored.x, x)
    assert restored.step == 42
    np.testing.assert_array_equal(restored.stats["sum_x"], state.stats["sum_x"])
    # restored key continues the identical chain
    a = jax.random.normal(key, (3,))
    b = jax.random.normal(restored.key, (3,))
    np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_measurement_vector_radius_partition_of_unity():
    """A radius-R measurement vector integrates the indicator of the R-ball
    against the FEM basis: for a ball fully interior to the domain the entries
    sum to ~1 (f_meas = 1, normalisation 1/V_sphere), cf.
    measured_operator.cc:93-168."""
    from multigridmc_tpu.models.posterior import measurement_vector

    lat = Lattice((64, 64))
    w = measurement_vector(lat, [0.5, 0.5], radius=0.1)
    assert abs(w.sum() - 1.0) < 2e-2
    # support is local to the ball
    coords = lat.vertex_coordinates()
    dist = np.linalg.norm(coords - np.array([0.5, 0.5]), axis=-1)
    assert np.abs(w[dist > 0.1 + 2.0 / 64]).max() == 0.0


def test_measurement_vector_radius0_nearest_vertex():
    from multigridmc_tpu.models.posterior import measurement_vector

    lat = Lattice((8, 8))
    w = measurement_vector(lat, [0.49, 0.26], radius=0.0)
    assert w.sum() == 1.0
    idx = np.unravel_index(np.argmax(w), lat.vshape)
    # nearest interior vertex to (0.49, 0.26) on h=1/8 grid: x=0.5 (col 3), y=0.25 (row 1)
    assert idx == (1, 3)


def test_chain_checkpoint_key_impl_roundtrip(tmp_path):
    """Non-default PRNG impls and raw uint32 keys survive save/load exactly
    (the impl was once silently dropped)."""
    import jax
    from multigridmc_tpu.utils.checkpoint import ChainState

    x = np.zeros((3, 3))
    # typed non-default impl
    k_rbg = jax.random.key(7, impl="rbg")
    p = tmp_path / "rbg.npz"
    ChainState(x=x, key=k_rbg, step=5).save(p)
    loaded = ChainState.load(p)
    assert str(jax.random.key_impl(loaded.key)) == "rbg"
    np.testing.assert_array_equal(
        np.asarray(jax.random.key_data(loaded.key)),
        np.asarray(jax.random.key_data(k_rbg)),
    )
    # raw (untyped) key stays raw
    k_raw = np.asarray(jax.random.PRNGKey(3))
    assert k_raw.dtype == np.uint32
    p2 = tmp_path / "raw.npz"
    ChainState(x=x, key=k_raw, step=1).save(p2)
    loaded2 = ChainState.load(p2)
    assert isinstance(loaded2.key, np.ndarray) and loaded2.key.dtype == np.uint32
    np.testing.assert_array_equal(loaded2.key, k_raw)
