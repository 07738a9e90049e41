"""Multi-process (multi-"host") distributed dryrun.

Exercises the multi-host backend layer (``parallel/mesh.py:init_distributed``
and ``multihost_lattice_mesh``) that SURVEY.md section 5 calls for: two local
processes x 4 virtual CPU devices each form one 8-device global mesh
(chains=2 x ly=2 x lx=2), and the full explicit-halo MGMC W-cycle
(``parallel/cycle.py``) runs across the process boundary - per-colour
``ppermute`` halos, the ``B^T x`` psum and the coarse agglomeration
``all_gather`` all cross processes (gloo CPU collectives stand in for the
network between hosts).

Correctness gate: in "global" noise mode the cycle's trajectory is
mesh-shape-independent by construction, so every process asserts its local
output shards against a *single-device* reference run computed locally (a
1-device mesh over one of its own devices).  The production "sharded" noise
mode is additionally compiled + executed and checked finite.

Usage:
    python native/dryrun_multihost.py            # parent: spawns 2 workers
    python native/dryrun_multihost.py --proc I --port P   # worker (internal)

Exit code 0 and a final "dryrun_multihost: OK" line on success.
"""

from __future__ import annotations

import pathlib
import socket
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parents[1]
NPROC = 2
LOCAL_DEVICES = 4


def worker(proc_id: int, port: int) -> None:
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_num_cpu_devices", LOCAL_DEVICES)

    sys.path.insert(0, str(REPO))
    import numpy as np
    import jax.numpy as jnp
    from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

    from multigridmc_tpu.parallel.mesh import init_distributed, multihost_lattice_mesh
    from multigridmc_tpu.parallel.cycle import ShardedMGMCSampler, pad_field

    nproc = init_distributed(
        coordinator_address=f"localhost:{port}",
        num_processes=NPROC,
        process_id=proc_id,
    )
    assert nproc == NPROC, f"expected {NPROC} processes, got {nproc}"
    assert len(jax.devices()) == NPROC * LOCAL_DEVICES
    assert len(jax.local_devices()) == LOCAL_DEVICES

    mesh = multihost_lattice_mesh(dim=2, chains=2)
    assert dict(mesh.shape) == {"chains": 2, "ly": 2, "lx": 2}, mesh.shape

    # same problem family as __graft_entry__.dryrun_multichip
    from __graft_entry__ import _build

    op, _ = _build(nx=32, nlevel=3)
    dtype = op.coeffs.dtype
    nchains = 4
    rng = np.random.default_rng(1)
    f = np.asarray(rng.normal(size=op.vshape), dtype=dtype)
    x = np.zeros((nchains,) + op.vshape, dtype=dtype)
    key = jax.random.PRNGKey(0)

    cycle_kwargs = dict(
        nlevel=3, smoother="SOR", cycle=2, agglomerate_below=4,
    )
    sampler = ShardedMGMCSampler(op, mesh=mesh, noise_mode="global",
                                 **cycle_kwargs)
    fp = np.asarray(pad_field(jnp.asarray(f), op.vshape))
    xp = np.asarray(pad_field(jnp.asarray(x), op.vshape))

    # global arrays from per-process data (every process holds the full value)
    xspec = P("chains", "ly", "lx")
    fspec = P("ly", "lx")
    xg = jax.make_array_from_callback(
        xp.shape, NamedSharding(mesh, xspec), lambda idx: xp[idx])
    fg = jax.make_array_from_callback(
        fp.shape, NamedSharding(mesh, fspec), lambda idx: fp[idx])

    out = jax.block_until_ready(sampler.apply(key, fg, xg))

    # single-device local reference: identical trajectory by global-noise
    # construction, computed independently on every process
    mesh1 = Mesh(
        np.asarray(jax.local_devices()[:1]).reshape(1, 1, 1),
        ("chains", "ly", "lx"),
    )
    ref_sampler = ShardedMGMCSampler(op, mesh=mesh1, noise_mode="global",
                                     **cycle_kwargs)
    ref = np.asarray(
        jax.block_until_ready(ref_sampler.apply(key, jnp.asarray(fp),
                                                jnp.asarray(xp)))
    )
    scale = max(float(np.max(np.abs(ref))), 1.0)
    worst = 0.0
    for shard in out.addressable_shards:
        err = float(np.max(np.abs(np.asarray(shard.data) - ref[shard.index])))
        worst = max(worst, err)
    assert worst <= 1e-4 * scale, (
        f"proc {proc_id}: cross-process cycle diverges from single-device "
        f"reference: max err {worst:.3e}"
    )

    # production noise mode: per-shard PRNG streams across the process
    # boundary - compile, run, finite
    prod = ShardedMGMCSampler(op, mesh=mesh, noise_mode="sharded",
                              **cycle_kwargs)
    outp = jax.block_until_ready(prod.apply(key, fg, xg))
    for shard in outp.addressable_shards:
        assert np.isfinite(np.asarray(shard.data)).all()

    print(
        f"proc {proc_id}: OK - {NPROC} processes x {LOCAL_DEVICES} devices, "
        f"mesh {dict(mesh.shape)}, global-noise max err {worst:.2e} vs "
        f"single-device reference; sharded-noise mode finite",
        flush=True,
    )


def parent() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    procs = [
        subprocess.Popen(
            [sys.executable, __file__, "--proc", str(i), "--port", str(port)],
            cwd=str(REPO), stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True,
        )
        for i in range(NPROC)
    ]
    ok = True
    for i, p in enumerate(procs):
        out, _ = p.communicate(timeout=900)
        marker = f"proc {i}: OK"
        if p.returncode != 0 or marker not in out:
            ok = False
            print(f"--- worker {i} FAILED (rc={p.returncode}) ---")
            print("\n".join(out.splitlines()[-30:]))
        else:
            print([l for l in out.splitlines() if marker in l][0])
    print("dryrun_multihost: OK" if ok else "dryrun_multihost: FAILED")
    return 0 if ok else 1


if __name__ == "__main__":
    if "--proc" in sys.argv:
        i = sys.argv.index("--proc")
        j = sys.argv.index("--port")
        worker(int(sys.argv[i + 1]), int(sys.argv[j + 1]))
    else:
        raise SystemExit(parent())
