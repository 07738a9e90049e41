"""Explicit halo-exchange primitives under ``shard_map``.

The default distributed path lets XLA's SPMD partitioner insert halo exchanges
automatically (see :mod:`multigridmc_tpu.parallel.mesh`).  This module provides
the *explicit* building blocks; the full multi-device MGMC cycle built
on them (per-shard noise, Woodbury psum, restrict/prolongate, coarse
agglomeration) lives in :mod:`multigridmc_tpu.parallel.cycle`:

* :func:`halo_exchange` - pad a local block with width-``pad`` halos fetched
  from mesh neighbours via ``jax.lax.ppermute``; missing neighbours (domain
  boundary) contribute zeros, which is exactly the homogeneous Dirichlet
  condition of the interior-vertex fields.
* :func:`shard_map_sor_sweep` - a multi-colour SOR sweep where every colour
  phase exchanges halos explicitly and then updates locally; algebraically
  identical to the global colour-ordered sweep.

``shard_map`` requires evenly divisible block shapes, so these entry points
expect lattice extents chosen such that ``vshape`` divides the mesh (e.g. 65
cells -> 64 interior vertices over 4 shards); the GSPMD path has no such
restriction and remains the default.
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
from jax.sharding import Mesh, PartitionSpec as P
from jax import shard_map


def _ppermute_shift(x_slice, axis_name: str, direction: int):
    """Shift slices between neighbouring shards along a mesh axis.

    ``direction=+1`` sends each shard's slice to the next shard (so every shard
    receives its *left* neighbour's boundary); missing links yield zeros.
    """
    n = jax.lax.axis_size(axis_name)
    if direction > 0:
        perm = [(i, i + 1) for i in range(n - 1)]
    else:
        perm = [(i + 1, i) for i in range(n - 1)]
    return jax.lax.ppermute(x_slice, axis_name, perm)


def halo_exchange(x: jax.Array, pad: int, axis_names: Tuple[str, ...]) -> jax.Array:
    """Return the local block padded with width-``pad`` halos from neighbours.

    ``x`` is the local shard of a field whose last ``len(axis_names)`` axes are
    sharded over the named mesh axes (slowest grid axis first).  Boundary shards
    receive zero halos (Dirichlet).
    """
    grid_ndim = len(axis_names)
    offset = x.ndim - grid_ndim
    for d, name in enumerate(axis_names):
        ax = offset + d
        lo = jax.lax.slice_in_dim(x, 0, pad, axis=ax)
        hi = jax.lax.slice_in_dim(x, x.shape[ax] - pad, x.shape[ax], axis=ax)
        halo_from_left = _ppermute_shift(hi, name, +1)  # my left neighbour's top
        halo_from_right = _ppermute_shift(lo, name, -1)
        x = jnp.concatenate([halo_from_left, x, halo_from_right], axis=ax)
    return x


def _local_stencil_apply(coeffs, xp, offsets, pad, grid_ndim):
    """Stencil apply on a halo-padded block (valid region only)."""
    out = None
    core = xp.shape[-grid_ndim:]
    for k, off in enumerate(offsets):
        idx = tuple(
            slice(pad + o, pad + o + (n - 2 * pad))
            for o, n in zip(off, core)
        )
        idx = (Ellipsis,) + idx
        t = coeffs[k] * xp[idx]
        out = t if out is None else out + t
    return out


def shard_map_sor_sweep(
    op,
    coloring,
    omega: float,
    order,
    mesh: Mesh,
    b: jax.Array,
    x: jax.Array,
):
    """Multi-colour SOR sweep with explicit halo exchange per colour phase.

    Equivalent to :func:`multigridmc_tpu.smoothers.sor_sweep` (same splitting:
    every colour phase sees the updated values of previous colours, including
    across shard boundaries - the halo refresh per phase guarantees it).
    """
    axis_names = mesh.axis_names
    grid_ndim = len(axis_names)
    pad = max(max(abs(o) for o in off) for off in op.offsets)
    spec = P(*axis_names)

    coeffs = op.coeffs
    diag = op.diag_stencil()
    masks = jnp.asarray(coloring.masks(), dtype=coeffs.dtype)
    coeff_spec = P(None, *axis_names)

    @functools.partial(
        shard_map,
        mesh=mesh,
        in_specs=(coeff_spec, spec, coeff_spec, spec, spec),
        out_specs=spec,
    )
    def sweep(coeffs_l, diag_l, masks_l, b_l, x_l):
        for c in order:
            xp = halo_exchange(x_l, pad, axis_names)
            ax = _local_stencil_apply(coeffs_l, xp, op.offsets, pad, grid_ndim)
            x_l = x_l + masks_l[c] * (omega * (b_l - ax) / diag_l)
        return x_l

    return sweep(coeffs, diag, masks, b, x)
