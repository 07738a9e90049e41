"""Quantities of interest evaluated on lattice fields.

Counterpart of ``src/qoi/quantityofinterest.hh:16-37``, which in the reference
is a vestigial abstract base with no concrete implementation or call sites.
Here the interface is kept for parity and given the two QoIs the drivers
actually compute inline (``driver_mgmc.cc:72-78``): a linear observation
``z = w^T x`` and the domain average.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .lattice import Lattice


class QoI:
    """cf. ``QoI::evaluate(x)`` (``quantityofinterest.hh:16-30``)."""

    def evaluate(self, x):
        raise NotImplementedError

    def __call__(self, x):
        return self.evaluate(x)


class LinearQoI(QoI):
    """``z = w^T x`` for a fixed weight field w (e.g. a measurement vector)."""

    def __init__(self, weights):
        self.weights = jnp.asarray(weights)

    def evaluate(self, x):
        d = self.weights.ndim
        return jnp.tensordot(x, self.weights, axes=d,
                             precision=jax.lax.Precision.HIGHEST)


class DomainAverageQoI(LinearQoI):
    """Average of the field over the domain (cell_volume per vertex)."""

    def __init__(self, lattice: Lattice):
        super().__init__(jnp.full(lattice.vshape, lattice.cell_volume))


def qoi_factory(name: str, lattice: Lattice, **kwargs) -> QoI:
    """cf. ``QoIFactory`` (``quantityofinterest.hh:32-37``)."""
    if name == "linear":
        return LinearQoI(kwargs["weights"])
    if name == "domain_average":
        return DomainAverageQoI(lattice)
    raise ValueError(f"unknown QoI '{name}'")
