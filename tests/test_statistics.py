"""Statistics estimator tests, mirroring ``src/auxilliary/test_statistics.hh:35-166``:
the analytically solvable AR(1) vector process ``Q_n = A Q_{n-1} + xi + v`` with
closed-form mean ``(I-A)^{-1} v``, covariance ``(I-A^2 ... )`` (via the discrete
Lyapunov solution), autocovariance ``A^t Var`` and tau_int."""

import numpy as np
import pytest

from multigridmc_tpu.utils.statistics import Statistics


def make_process():
    theta = 1.3
    rot = np.array([[np.cos(theta), np.sin(theta)], [-np.sin(theta), np.cos(theta)]])
    A = rot @ np.diag([0.6, 0.4]) @ rot.T
    v = np.array([1.4, 0.6])
    return A, v


def exact_moments(A, v):
    mean = np.linalg.solve(np.eye(2) - A, v)
    # Var = A Var A^T + I  (discrete Lyapunov); for symmetric A: Var = (I - A^2)^{-1}
    var = np.linalg.inv(np.eye(2) - A @ A)
    return mean, var


def generate(A, v, nsamples, nwarmup, stat, seed=1241517):
    rng = np.random.default_rng(seed)
    # vectorised generation, then replayed through the incremental recorder
    xi = rng.standard_normal((nwarmup + nsamples, 2))
    Q = np.zeros(2)
    for j in range(nwarmup):
        Q = A @ Q + xi[j] + v
    for j in range(nsamples):
        Q = A @ Q + xi[nwarmup + j] + v
        stat.record_sample(Q)


A_ITER, V_SHIFT = make_process()


def test_average_and_covariance():
    stat = Statistics("ar1", 10)
    generate(A_ITER, V_SHIFT, nsamples=400000, nwarmup=1000, stat=stat)
    mean_exact, var_exact = exact_moments(A_ITER, V_SHIFT)
    assert np.linalg.norm(stat.average() - mean_exact) < 5e-3
    assert np.linalg.norm(stat.covariance() - var_exact) < 2e-2


def test_autocovariance_and_tau_int():
    window = 10
    stat = Statistics("ar1", window)
    generate(A_ITER, V_SHIFT, nsamples=400000, nwarmup=1000, stat=stat)
    _, var_exact = exact_moments(A_ITER, V_SHIFT)
    C = stat.auto_covariance()
    # C(k) = A^k Var (test_statistics.hh:28-33)
    Ak = np.eye(2)
    for k in range(min(4, len(C))):
        np.testing.assert_allclose(C[k], Ak @ var_exact, atol=5e-2)
        Ak = A_ITER @ Ak
    # tau_int in direction e0: 1 + 2 sum_k (1 - k/K) C_k[0,0]/C_0[0,0]
    v = np.array([1.0, 0.0])
    tau = stat.tau_int(v)
    tau_exact = 1.0
    for k in range(1, window):
        Ck = np.linalg.matrix_power(A_ITER, k) @ var_exact
        tau_exact += 2 * (1 - k / window) * Ck[0, 0] / var_exact[0, 0]
    assert abs(tau - tau_exact) < 0.1


def test_incremental_matches_batch():
    rng = np.random.default_rng(0)
    samples = rng.normal(size=(500, 3))
    stat = Statistics("batch", 5)
    for s in samples:
        stat.record_sample(s)
    np.testing.assert_allclose(stat.average(), samples.mean(axis=0), rtol=1e-10)
    np.testing.assert_allclose(stat.covariance(), np.cov(samples.T, ddof=1), rtol=1e-8)


def test_tau_int_chains_matches_reference_estimator():
    """One centred chain: the multi-chain estimator is the reference's
    ``Statistics.tau_int`` (``statistics.cc:65-79``) with the same window."""
    from multigridmc_tpu.utils.statistics import tau_int_chains

    rng = np.random.default_rng(3)
    z = np.zeros(4000)
    for t in range(1, len(z)):
        z[t] = 0.7 * z[t - 1] + rng.normal()
    z -= z.mean()
    stats = Statistics("z", 40)
    for v in z:
        stats.record_sample([v])
    assert tau_int_chains(z[:, None], 40) == pytest.approx(stats.tau_int([1.0]), rel=1e-9)


def test_tau_int_chains_pools_chains_and_ignores_the_mean():
    """Many short AR(1) chains with a large common mean: the pooled estimate
    recovers tau = (1 + rho) / (1 - rho) (the window's (1 - k/K) weights
    bias it slightly low)."""
    from multigridmc_tpu.utils.statistics import tau_int_chains

    rng = np.random.default_rng(4)
    rho, nsteps, nchains = 0.5, 400, 256
    z = np.zeros((nsteps, nchains))
    z[0] = rng.normal(size=nchains) / np.sqrt(1 - rho**2)
    for t in range(1, nsteps):
        z[t] = rho * z[t - 1] + rng.normal(size=nchains)
    tau = tau_int_chains(z + 100.0, 50)
    assert tau == pytest.approx(tau_int_chains(z, 50), rel=1e-9)
    assert 2.7 < tau < 3.1
