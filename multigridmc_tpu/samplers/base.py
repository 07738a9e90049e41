"""Sampler base interface.

Counterpart of ``src/sampler/sampler.hh:23-85``.  Where the reference
threads a single shared ``std::mt19937_64&`` through every sampler, here every
``apply`` takes an explicit ``jax.random`` key and the caller splits keys per
step - deterministic, parallel-safe, and shardable (per-device key folding
happens inside shard_map when running distributed).

Samplers draw the next chain state ``x' ~ K(x, .)`` of a Markov chain whose
stationary distribution is ``pi(x) ~ exp(-1/2 x^T A x + f^T x)``, i.e.
``N(A^{-1} f, A^{-1})``.

The ``fix_rhs`` / ``unfix_rhs`` protocol (``sampler.hh:49-63``) lets direct
samplers cache the f-dependent part of their update.
"""

from __future__ import annotations

import jax

from ..ops.stencil import StencilOperator


class Sampler:
    def __init__(self, op: StencilOperator):
        self.op = op

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        """Draw the next chain state given rhs f and current state x."""
        raise NotImplementedError

    def apply_indexed(self, key: jax.Array, f: jax.Array, x: jax.Array,
                      k: jax.Array) -> jax.Array:
        """One chain step that also sees the (possibly traced) step index
        ``k``.  Default: ignore it.  Step-schedule-aware samplers (MGMC with
        ``sweep_schedule="alternating"``) override this so driver scan loops
        stay one-step-per-iteration."""
        del k
        return self.apply(key, f, x)

    def fix_rhs(self, f: jax.Array) -> None:
        """Cache f-dependent precomputations (no-op by default)."""

    def unfix_rhs(self) -> None:
        """Drop cached f-dependent state (no-op by default)."""


class MeanShiftedSampler(Sampler):
    """Zero-mean float32 protocol as a first-class sampler wrapper.

    Direct-rhs sampling in float32 carries an O(cond(Q) * eps32) mean bias
    (~4% on the bench posterior): the Gibbs chain implicitly solves ``Q mu = f``
    in float32.  This wrapper samples the *fluctuation* ``e ~ N(0, Q^{-1})``
    with f = 0 on device and carries the exactly known (host float64) mean
    separately:

        x' = mean + K_0(x - mean, .)

    Exact in expectation; the covariance is untouched.  The rhs argument of
    ``apply`` is ignored - the wrapper represents the fixed target
    ``N(mean, Q^{-1})`` the caller built it with, matching reference semantics
    of ``driver_mgmc.cc:51-64`` where f = Q mean.
    """

    def __init__(self, sampler: Sampler, mean):
        super().__init__(sampler.op)
        import jax.numpy as jnp

        self.inner = sampler
        dtype = sampler.op.coeffs.dtype
        self.mean = jnp.asarray(mean, dtype=dtype)
        self._zero = jnp.zeros(sampler.op.vshape, dtype=dtype)

    def apply(self, key: jax.Array, f: jax.Array, x: jax.Array) -> jax.Array:
        del f  # target mean is carried exactly; see class docstring
        e = x - self.mean
        e = self.inner.apply(key, self._zero, e)
        return self.mean + e

    def apply_indexed(self, key: jax.Array, f: jax.Array, x: jax.Array,
                      k: jax.Array) -> jax.Array:
        del f
        e = x - self.mean
        e = self.inner.apply_indexed(key, self._zero, e, k)
        return self.mean + e

    def fix_rhs(self, f: jax.Array) -> None:
        self.inner.fix_rhs(self._zero)

    def unfix_rhs(self) -> None:
        self.inner.unfix_rhs()
