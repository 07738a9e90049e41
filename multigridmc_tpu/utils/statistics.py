"""Online vector-valued chain statistics.

Counterpart of ``src/auxilliary/statistics.{hh,cc}``: running mean and
second moment (Welford-style incremental updates, ``statistics.cc:4-39``),
covariance estimator (``:42-45``), windowed autocovariance C(k) over the last
k_max samples (``:53-62``), and the integrated autocorrelation time tau_int in a
direction v (``:65-79``).

Two implementations:

* :class:`Statistics` - host-side incremental recorder with the reference's
  exact update formulas, for drivers and diagnostics;
* :func:`chain_statistics_scan` - a jit-able ``lax.scan`` accumulator for whole
  batched chains on device (used by the statistical test oracle and bench);
* :func:`tau_int_chains` - the reference's tau_int estimator for a scalar
  observable recorded from many parallel chains.
"""

from __future__ import annotations

from collections import deque
from typing import List

import numpy as np


class Statistics:
    """cf. ``Statistics`` (``statistics.hh:55-133``)."""

    def __init__(self, label: str, autocorr_window: int):
        self.label = label
        self.k_max = int(autocorr_window)
        self.reset()

    def reset(self) -> None:
        self.n_samples = 0
        self.avg = None
        self.avg2 = None
        self.Q_k: deque = deque()
        self.S_k: List[np.ndarray] = []

    def record_sample(self, Q) -> None:
        """Incremental update (``statistics.cc:4-39``)."""
        Q = np.atleast_1d(np.asarray(Q, dtype=np.float64))
        self.n_samples += 1
        if self.n_samples == 1:
            self.avg = Q.copy()
            self.avg2 = np.outer(Q, Q)
        else:
            self.avg += (Q - self.avg) / self.n_samples
            self.avg2 += (np.outer(Q, Q) - self.avg2) / self.n_samples
        self.Q_k.appendleft(Q)
        if len(self.Q_k) > self.k_max:
            self.Q_k.pop()
        for k in range(len(self.Q_k)):
            N_k = self.n_samples - k
            S = np.outer(self.Q_k[0], self.Q_k[k])
            if N_k == 1:
                self.S_k.append(S)
            else:
                self.S_k[k] += (S - self.S_k[k]) / N_k

    def average(self) -> np.ndarray:
        return self.avg

    def covariance(self) -> np.ndarray:
        """Unbiased estimator (``statistics.cc:42-45``)."""
        n = self.n_samples
        return n / (n - 1.0) * (self.avg2 - np.outer(self.avg, self.avg))

    def auto_covariance(self) -> List[np.ndarray]:
        """C(k) = S_k - avg avg^T (``statistics.cc:53-62``)."""
        return [S - np.outer(self.avg, self.avg) for S in self.S_k]

    def tau_int(self, v) -> float:
        """Integrated autocorrelation time in direction v (``statistics.cc:65-79``)."""
        v = np.atleast_1d(np.asarray(v, dtype=np.float64))
        C_k = self.auto_covariance()
        variance = v @ C_k[0] @ v
        tau = 1.0
        kmax = len(C_k)
        for k in range(1, kmax):
            cov = v @ C_k[k] @ v
            tau += 2.0 * (1.0 - k / kmax) * cov / variance
        return tau

    def samples(self) -> int:
        return self.n_samples

    def autocorr_window(self) -> int:
        return self.k_max

    def __str__(self) -> str:
        lines = [
            f" {self.label}: Avg = {self.average()}",
            f" {self.label}: Var = {self.covariance()}",
        ]
        dim = len(self.avg)
        for j in range(dim):
            v = np.zeros(dim)
            v[j] = 1.0
            lines.append(f" {self.label}: tau_int,{j} = {self.tau_int(v):.3f}")
        lines.append(f" {self.label}: window      = {self.autocorr_window()}")
        lines.append(f" {self.label}: # samples   = {self.samples()}")
        return "\n".join(lines)


def tau_int_chains(z, k_max: int) -> float:
    """Integrated autocorrelation time of a scalar observable ``z`` of shape
    ``(nsteps, nchains)``: the estimator of :meth:`Statistics.tau_int` with
    window ``k_max`` (``statistics.cc:53-79``), its averages taken over every
    chain as well as over time.  The series is centred first: on short
    series the reference's ``S_k - avg^2`` form is not shift-invariant, and a
    large mean then swamps the lagged covariances."""
    z = np.asarray(z, dtype=np.float64)
    z = z - z.mean()
    nsteps = z.shape[0]
    k_max = min(int(k_max), nsteps)
    C = [np.mean(z[k:] * z[: nsteps - k]) for k in range(k_max)]
    tau = 1.0
    for k in range(1, k_max):
        tau += 2.0 * (1.0 - k / k_max) * C[k] / C[0]
    return float(tau)


def chain_statistics_scan(step_fn, x0, keys, observe_fn=None):
    """Run a chain with ``lax.scan`` accumulating first/second moments on device.

    ``step_fn(key, x) -> x`` advances the chain; ``observe_fn(x) -> z`` maps the
    state to the observed vector (identity-flatten by default).  Returns
    ``(x_final, mean, second_moment)`` averaged over steps (and any leading batch
    dimensions of the observation).
    """
    import jax
    import jax.numpy as jnp

    if observe_fn is None:
        observe_fn = lambda x: x.reshape(-1)

    z0 = observe_fn(x0)
    nobs = z0.shape[-1]

    def step(carry, key):
        x, sx, sxx = carry
        x = step_fn(key, x)
        z = observe_fn(x)
        z2 = z.reshape(-1, nobs)
        sx = sx + z2.sum(axis=0)
        sxx = sxx + z2.T @ z2
        return (x, sx, sxx), 0.0

    nbatch = int(np.prod(z0.shape[:-1])) if z0.ndim > 1 else 1
    init = (x0, jnp.zeros((nobs,), x0.dtype), jnp.zeros((nobs, nobs), x0.dtype))
    (x, sx, sxx), _ = jax.lax.scan(step, init, keys)
    total = len(keys) * nbatch
    return x, sx / total, sxx / total
