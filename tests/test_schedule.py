"""Sweep-schedule tests: the alternating pre/post direction schedule and the
distill precision tier.

The alternating schedule (docs/CONVERGENCE.md round-4 scan) is a
step-dependent composition of two valid MGMC kernels - even steps use the
reference's forward-pre / backward-post roles (``multigridmc_sampler.cc:24-50``),
odd steps the reverse.  Each parity engine leaves the target distribution
invariant, so the composition does too; the tests verify (a) the parity-1
engine is exactly the pre/post-swapped cycle, (b) the composed chain passes
the reference's statistical oracle (``test_sampler.hh:113-153``), and (c) the
config key reaches the sampler.
"""

from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from multigridmc_tpu.samplers.mgmc import MultigridMCSampler

from test_sampler import make_posterior_2d, mean_covariance_error


def test_alternating_parity1_equals_swapped():
    """Parity-1 apply == a fixed-schedule sampler with pre/post roles swapped
    by hand (the round-4 scan's recipe), bitwise on the composed CPU path."""
    op = make_posterior_2d(8)
    alt = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=2,
                             sweep_schedule="alternating")
    swapped = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=2)
    swapped.presamplers, swapped.postsamplers = (
        swapped.postsamplers, swapped.presamplers)

    key = jax.random.PRNGKey(7)
    rng = np.random.default_rng(3)
    f = jnp.asarray(rng.normal(size=op.vshape))
    x = jnp.asarray(rng.normal(size=(4,) + op.vshape))
    out_alt = alt.apply(key, f, x, parity=1)
    out_sw = swapped.apply(key, f, x)
    np.testing.assert_array_equal(np.asarray(out_alt), np.asarray(out_sw))
    # parity 0 is the unswapped engine
    np.testing.assert_array_equal(
        np.asarray(alt.apply(key, f, x, parity=0)),
        np.asarray(MultigridMCSampler(op, nlevel=3, smoother="SOR",
                                      cycle=2).apply(key, f, x)))


def test_apply_indexed_dispatch():
    """Fixed schedule ignores the step index; alternating dispatches on its
    parity (traced index through lax.cond)."""
    op = make_posterior_2d(8)
    key = jax.random.PRNGKey(11)
    rng = np.random.default_rng(5)
    f = jnp.asarray(rng.normal(size=op.vshape))
    x = jnp.asarray(rng.normal(size=(2,) + op.vshape))

    fixed = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=1)
    np.testing.assert_array_equal(
        np.asarray(fixed.apply_indexed(key, f, x, jnp.int32(3))),
        np.asarray(fixed.apply(key, f, x)))

    alt = MultigridMCSampler(op, nlevel=3, smoother="SOR", cycle=1,
                             sweep_schedule="alternating")
    apply_j = jax.jit(alt.apply_indexed)
    apply_p = jax.jit(alt.apply, static_argnames=("parity",))
    for k, parity in ((jnp.int32(2), 0), (jnp.int32(5), 1)):
        np.testing.assert_array_equal(
            np.asarray(apply_j(key, f, x, k)),
            np.asarray(apply_p(key, f, x, parity=parity)))

    # apply_pair = parity-0 step then parity-1 step with split keys
    k0, k1 = jax.random.split(key)
    np.testing.assert_array_equal(
        np.asarray(alt.apply_pair(key, f, x)),
        np.asarray(alt.apply(k1, f, alt.apply(k0, f, x), parity=1)))


def test_alternating_sampler_statistics():
    """The alternating chain passes the reference's mean/covariance oracle
    (``test_sampler.hh:113-153``) - both parities engaged via apply_indexed."""
    op = make_posterior_2d(8)
    sampler = MultigridMCSampler(op, nlevel=3, smoother="SOR", omega=1.4,
                                 cycle=2, sweep_schedule="alternating")

    # inline oracle (mean_covariance_error drives .apply without the step
    # index; the alternating schedule needs it threaded through apply_indexed)
    n = op.lattice.nvertex
    rng = np.random.default_rng(1342517)
    mean_exact = rng.uniform(size=n)
    Q = op.to_dense()
    f = jnp.asarray((Q @ mean_exact).reshape(op.vshape))
    cov_exact = np.linalg.inv(Q)
    nchains, nwarmup, nsteps = 1024, 20, 400
    key = jax.random.PRNGKey(1342517)
    x = jnp.zeros((nchains,) + op.vshape)

    @jax.jit
    def run(x, key):
        def body(i, x):
            return sampler.apply_indexed(jax.random.fold_in(key, i), f, x, i)

        x = jax.lax.fori_loop(0, nwarmup, body, x)

        def step(carry, i):
            x, sx, sxx = carry
            x = sampler.apply_indexed(
                jax.random.fold_in(key, nwarmup + i), f, x, nwarmup + i)
            xf = x.reshape(nchains, n)
            return (x, sx + xf.sum(axis=0), sxx + xf.T @ xf), 0.0

        (x, sx, sxx), _ = jax.lax.scan(
            step, (x, jnp.zeros((n,)), jnp.zeros((n, n))), jnp.arange(nsteps))
        return sx, sxx

    sx, sxx = run(x, key)
    total = nchains * nsteps
    Ex = np.asarray(sx) / total
    cov = np.asarray(sxx) / total - np.outer(Ex, Ex)
    em = np.max(np.abs(Ex - mean_exact))
    ec = np.max(np.abs(cov - cov_exact))
    assert em < 4e-3 and ec < 4e-3, (em, ec)


def test_sweep_schedule_config_key(tmp_path):
    """The sweep_schedule / distill_precision keys parse from the config file
    and reach the constructed sampler."""
    from multigridmc_tpu.utils.config import load_config

    import shutil

    fixtures = Path(__file__).resolve().parent / "fixtures"
    shutil.copy(fixtures / "parameters_template.cfg", tmp_path / "params.cfg")
    shutil.copy(fixtures / "measurements_template.cfg",
                tmp_path / "measurements_template.cfg")
    text = (tmp_path / "params.cfg").read_text()
    assert "sweep_schedule" not in text
    text = text.replace(
        "cycle = 2;",
        'cycle = 2;\n    sweep_schedule = "alternating";\n'
        '    distill_precision = "highest";')
    (tmp_path / "params.cfg").write_text(text)
    config = load_config(tmp_path / "params.cfg")
    assert config.multigrid.sweep_schedule == "alternating"
    assert config.multigrid.distill_precision == "highest"

    from multigridmc_tpu.drivers.common import build_operators
    from multigridmc_tpu.drivers.mgmc import make_samplers

    _, op, _ = build_operators(config)
    samplers = make_samplers(config, op)
    mgmc = samplers["multigridmc"]
    assert mgmc.sweep_schedule == "alternating"
    assert mgmc.distill_precision == "highest"
    assert mgmc._alt is not None


def test_distill_precision_reaches_map():
    """distill_precision="highest" produces a HIGHEST-precision distilled
    subtree map (distill=True forces distillation on CPU)."""
    op = make_posterior_2d(16)
    sampler = MultigridMCSampler(op, nlevel=4, smoother="SOR", cycle=1,
                                 distill=True, distill_precision="highest")
    assert sampler.distilled is not None
    assert sampler.distilled.precision == jax.lax.Precision.HIGHEST
