"""Correlation-length models kappa(x) for the shifted-Laplace precision operators.

Counterpart of ``src/linear_operator/correlationlength_model.hh``:
models are vectorised callables evaluating ``kappa^2(x)`` on whole coordinate
arrays at once (shape ``(..., dim)`` -> ``(...)``), instead of per-point virtual
dispatch.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import numpy as np


class CorrelationLengthModel:
    """Base class: implement ``kappa_sq(x)`` for coordinate arrays ``(..., dim)``."""

    def kappa_sq(self, x):
        raise NotImplementedError

    def kappa(self, x):
        return 1.0 / np.sqrt(self.kappa_sq(x))


@dataclasses.dataclass(frozen=True)
class ConstantCorrelationLengthModel(CorrelationLengthModel):
    """Constant correlation length: ``kappa^2 = 1 / Lambda^2``
    (cf. ``correlationlength_model.hh:45-66``)."""

    Lambda: float

    def kappa_sq(self, x):
        x = jnp.asarray(x)
        return jnp.full(x.shape[:-1], 1.0 / self.Lambda**2, dtype=x.dtype)


@dataclasses.dataclass(frozen=True)
class PeriodicCorrelationLengthModel(CorrelationLengthModel):
    """Separable-cosine periodic correlation length
    ``Lambda(x) = Lambda_1 + Lambda_2 * prod_d cos(pi x_d)`` with
    ``Lambda_1 = (Lambda_max + Lambda_min)/2``, ``Lambda_2 = (Lambda_max - Lambda_min)/2``
    (cf. ``correlationlength_model.hh:83-112``)."""

    Lambda_min: float
    Lambda_max: float

    def kappa_sq(self, x):
        x = jnp.asarray(x)
        lam1 = 0.5 * (self.Lambda_max + self.Lambda_min)
        lam2 = 0.5 * (self.Lambda_max - self.Lambda_min)
        lam = lam1 + lam2 * jnp.prod(jnp.cos(jnp.pi * x), axis=-1)
        return 1.0 / lam**2
