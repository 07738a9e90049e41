"""Chains-data-parallel execution of the single-device MGMC engine.

For multi-device *sampling* the natural mesh is pure data parallelism over
chains - every chain is an independent MCMC chain, the lattice fits one
device, and no halo traffic exists at all.  This module runs the full
single-device sampler (composed cycle plus the distilled affine subtree) per
shard inside ``shard_map``:

    mesh: 1d over the chains axis
    x:    (C, *v) sharded P("chains", ...)
    key:  per-shard independent stream (step key folded with the shard index,
          the same shard-linear-index scheme as parallel/cycle.py)

Lattice-sharded execution (for problems larger than one device's memory)
remains the explicit-halo ``ShardedMGMCSampler``.

The reference has no parallel execution of any kind (SURVEY.md section 2.2).
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.stencil import StencilOperator
from ..samplers.mgmc import MultigridMCSampler


def chains_mesh(n_devices: Optional[int] = None, devices=None,
                axis: str = "chains") -> Mesh:
    """1d device mesh over the chains (data-parallel) axis."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    return Mesh(np.asarray(devices), (axis,))


class DataParallelMGMCSampler:
    """Run a full single-device :class:`MultigridMCSampler` per chains shard.

    ``apply(key, f, x)`` takes ``x`` of shape ``(C, *vshape)`` with ``C``
    divisible by the mesh size; ``f`` is a shared (replicated) rhs field.
    Each shard folds its mesh index into the step key, so shards draw
    independent noise streams (chains are iid by construction - the
    data-parallel analogue of the per-shard PRNG in parallel/cycle.py).
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        mesh: Mesh,
        *,
        distill: object = True,
        **sampler_kwargs,
    ):
        if len(mesh.axis_names) != 1:
            raise ValueError(
                "DataParallelMGMCSampler takes a 1d chains mesh; use "
                "ShardedMGMCSampler for lattice domain decomposition"
            )
        self.mesh = mesh
        self.axis = mesh.axis_names[0]
        self.op = op
        # distill=True by default: each shard runs the whole single-device
        # sampler on its own device, whatever the platform
        self.sampler = MultigridMCSampler(
            op, nlevel, distill=distill, **sampler_kwargs)
        self._apply = self._make_apply()

    def _make_apply(self):
        vdim = len(self.op.vshape)
        xspec = P(self.axis, *([None] * vdim))
        axis = self.axis

        def body(key, f, x):
            k = jax.random.fold_in(key, jax.lax.axis_index(axis))
            return self.sampler.apply(k, f, x)

        fn = shard_map(body, mesh=self.mesh, in_specs=(P(), P(), xspec),
                       out_specs=xspec, check_vma=False)
        return jax.jit(fn)

    def apply(self, key, f, x):
        nshards = self.mesh.shape[self.axis]
        if x.shape[0] % nshards:
            raise ValueError(
                f"{x.shape[0]} chains do not divide {nshards} shards"
            )
        return self._apply(key, f, x)
