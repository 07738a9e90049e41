"""Device-mesh construction for lattice domain decomposition.

The reference has no parallelism of any kind (SURVEY.md section 2.2); this module
is the scaling layer it lacks: the lattice grid axes are sharded over a
1d/2d/3d ``jax.sharding.Mesh`` so every stencil shift becomes a width-1 (or 2,
for the biharmonic operator) halo exchange that XLA's SPMD partitioner inserts
automatically.  Coarse multigrid levels fall below the per-device tile
threshold and are replicated (the structured-grid analogue of coarse-grid
agglomeration).

The mesh only reshapes ``jax.devices()``.  On GPUs of one host joined all to
all by NVLink every device pair is equally close, so the split between the
chains axis and the lattice axes follows the algorithm alone (halo volume,
agglomeration depth), not a physical topology.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

#: mesh axis names for lattice dims, slowest array axis first (z, y, x)
AXIS_NAMES = ("lz", "ly", "lx")


def factor_devices(n: int, dim: int) -> Tuple[int, ...]:
    """Factor n devices into a near-square mesh over up to ``dim`` lattice axes."""
    shape = [1] * dim
    remaining = n
    # greedily split by smallest prime factors, round-robin over axes
    primes = []
    d = 2
    while remaining > 1:
        while remaining % d == 0:
            primes.append(d)
            remaining //= d
        d += 1
    for i, p in enumerate(sorted(primes, reverse=True)):
        shape[i % dim] *= p
    return tuple(sorted(shape, reverse=True))


def lattice_mesh(
    dim: int, n_devices: Optional[int] = None, devices=None, mesh_shape=None
) -> Mesh:
    """A mesh over the last ``min(dim, 2)`` lattice axes (sharding the two
    innermost axes keeps per-device tiles large in the fastest-varying dims)."""
    devices = devices if devices is not None else jax.devices()
    if n_devices is not None:
        devices = devices[:n_devices]
    n = len(devices)
    naxes = min(dim, 2)
    if mesh_shape is None:
        mesh_shape = factor_devices(n, naxes)
    axis_names = AXIS_NAMES[-dim:][-naxes:]
    dev_array = np.asarray(devices).reshape(mesh_shape)
    return Mesh(dev_array, axis_names)


def field_spec(dim: int, mesh: Mesh, batch_axes: int = 0) -> P:
    """PartitionSpec for a lattice field: trailing grid axes sharded by the mesh
    axes (innermost axes), leading batch axes replicated."""
    names = [None] * dim
    mesh_axes = list(mesh.axis_names)
    # mesh axes map onto the *last* len(mesh_axes) grid axes
    for i, name in enumerate(mesh_axes):
        names[dim - len(mesh_axes) + i] = name
    return P(*([None] * batch_axes + names))


def shard_field(x, lattice_dim: int, mesh: Mesh):
    """Materialise a field with the canonical lattice sharding.

    Interior-vertex grids have odd extents (n - 1), which rarely divide the mesh
    evenly; ``jax.device_put`` rejects uneven shardings but GSPMD handles them
    (with internal padding) through sharding constraints, so we route through a
    jitted identity.
    """
    batch_axes = x.ndim - lattice_dim
    ns = NamedSharding(mesh, field_spec(lattice_dim, mesh, batch_axes))
    try:
        return jax.device_put(x, ns)
    except ValueError:
        return jax.jit(lambda v: jax.lax.with_sharding_constraint(v, ns))(x)


def replicated(mesh: Mesh) -> NamedSharding:
    return NamedSharding(mesh, P())


# ----------------------------------------------------------------- multi-host
def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> int:
    """Initialise the multi-host runtime (``jax.distributed``).

    Pass the arguments explicitly (or set JAX_COORDINATOR_ADDRESS /
    JAX_NUM_PROCESSES / JAX_PROCESS_ID); without them a single-process run
    is assumed.  Safe to call more than once.  Returns the process count.
    """
    import os

    already = getattr(jax.distributed, "is_initialized", None)
    if callable(already) and already():
        return jax.process_count()
    kwargs = {}
    ca = coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    if ca:
        kwargs["coordinator_address"] = ca
        kwargs["num_processes"] = int(
            num_processes if num_processes is not None
            else os.environ["JAX_NUM_PROCESSES"]
        )
        # NOT `process_id or env`: the coordinator's id 0 is falsy and must
        # not fall through to the env lookup (caught by dryrun_multihost)
        kwargs["process_id"] = int(
            process_id if process_id is not None
            else os.environ["JAX_PROCESS_ID"]
        )
    try:
        jax.distributed.initialize(**kwargs)
    except (ValueError, RuntimeError):
        # single-process run (no coordinator reachable / already initialised)
        pass
    return jax.process_count()


def multihost_lattice_mesh(
    dim: int, chains: int = 1, mesh_shape: Optional[Tuple[int, ...]] = None
) -> Mesh:
    """Global ``chains x lattice`` mesh over every device of every host.

    Lays the lattice axes out over ``jax.devices()`` (which enumerates local
    devices contiguously), so width-1 halo ``ppermute`` partners sit on the
    same host wherever possible and only the outermost lattice axis crosses
    the network between hosts.  Call :func:`init_distributed` first on every
    process.
    """
    devices = jax.devices()
    n = len(devices)
    if n % chains:
        raise ValueError(f"{chains} chains shards do not divide {n} devices")
    lat = n // chains
    if mesh_shape is None:
        mesh_shape = factor_devices(lat, min(dim, 2))
    axis_names = AXIS_NAMES[-dim:][-len(mesh_shape):]
    shape = (chains,) + tuple(mesh_shape)
    dev_array = np.asarray(devices).reshape(shape)
    return Mesh(dev_array, ("chains",) + axis_names)
