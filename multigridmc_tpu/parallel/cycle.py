"""Full Multigrid Monte Carlo cycle under explicit halo exchange (shard_map).

This is the multi-device execution path for a lattice split over devices: the
ENTIRE MGMC step - stochastic pre/post sweeps with per-shard noise, the
low-rank ``B^T x`` psum, residual + restriction, prolongation, and the
agglomerated coarse-level solve - runs inside one ``shard_map`` region over a
``chains x lattice`` device mesh, with all halo traffic expressed as explicit
``ppermute`` neighbour exchanges (NCCL collectives on GPUs) rather than left to
the GSPMD partitioner.

Mirrors the recursive cycle of ``src/sampler/multigridmc_sampler.cc:103-139``
and the coarse-level semantics of ``multigridmc_sampler.cc:105-109``: below an
agglomeration threshold the (tiny) coarse fields are gathered to every shard
and all shards execute the identical replicated coarse computation - the
structured-grid analogue of the reference handing its coarsest operator to one
CholMod factorisation.

Padded layout
-------------
Interior-vertex grids have odd extents (``n_cells - 1`` per dim), which cannot
divide a device mesh evenly.  Every level-``l`` field is therefore stored on a
``n_cells(l)``-per-dim *padded* grid: the last entry per dim is padding, kept
exactly zero (the homogeneous-Dirichlet ghost), enforced by per-level validity
masks folded into the colour masks and noise scales.  Padded fine extents are
exactly twice the padded coarse extents, so the fine-vertex correspondence
``fine = 2*coarse + 1`` (``lattice1d.hh:145-148``) makes restriction and
prolongation local up to width-1 halos.

Where a visit cannot be one fused pass
--------------------------------------
Under lattice sharding a level visit cannot run as one pass over the local
block:

1. the Woodbury correction needs ``B^T x`` reduced over the *global* lattice
   between the sweep and the residual - a ``psum`` that splits the visit at
   that point;
2. each colour phase consumes neighbour values updated by the *previous*
   phase, so every phase needs fresh width-1 halos (or redundant halo-deep
   recomputation, which with per-shard PRNG draws inconsistent noise for the
   overlap vertices unless the PRNG is re-keyed per global vertex position).

Chains-only (data-parallel) meshes have neither problem - each shard owns the
full lattice - and run the complete single-device engine per shard via
:class:`multigridmc_tpu.parallel.data_parallel.DataParallelMGMCSampler`.

Noise modes
-----------
* ``"sharded"`` (production): every (chains x lattice) shard folds its linear
  shard index into the step key - independent streams, no cross-shard traffic.
* ``"global"`` (validation): every shard draws the full global noise field and
  slices its block - bitwise-identical trajectories on ANY mesh shape, used by
  the multi-device dry run to assert numerical equivalence against a 1-device run.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

from jax import shard_map

from ..ops.coloring import coloring_for
from ..ops.stencil import StencilOperator, shift
from ..smoothers import BACKWARD, FORWARD, color_order, compute_B_bar, splitting_solve
from ..solvers.multigrid import MultigridHierarchy
from ..utils.runtime import on_accelerator
from .halo import halo_exchange


# --------------------------------------------------------------------- padding
def padded_extents(vshape: Tuple[int, ...]) -> Tuple[int, ...]:
    """Vertex grid (n-1 per dim) -> padded grid (n per dim)."""
    return tuple(m + 1 for m in vshape)


def pad_field(x, vshape: Tuple[int, ...]):
    """Zero-pad a vertex field (trailing ``len(vshape)`` axes) by one per dim."""
    dim = len(vshape)
    pads = [(0, 0)] * (x.ndim - dim) + [(0, 1)] * dim
    return jnp.pad(x, pads)


def unpad_field(x, vshape: Tuple[int, ...]):
    dim = len(vshape)
    idx = (Ellipsis,) + tuple(slice(0, m) for m in vshape)
    return x[idx]


def _valid_mask(pn: Tuple[int, ...]) -> np.ndarray:
    m = np.ones(pn)
    for d in range(len(pn)):
        idx = [slice(None)] * len(pn)
        idx[d] = pn[d] - 1
        m[tuple(idx)] = 0.0
    return m


def _pad_coeffs(op: StencilOperator, pn: Tuple[int, ...]) -> np.ndarray:
    """Padded stencil coefficients: valid coefficients masked so that no entry
    reads a padding vertex (making the padded dense matrix blockdiag(Q, I)),
    diagonal = 1 on padding."""
    nk = len(op.offsets)
    out = np.zeros((nk,) + pn)
    valid = _valid_mask(pn)
    coeffs = np.asarray(op.normalized().coeffs, dtype=np.float64)
    core = tuple(slice(0, m) for m in op.vshape)
    for k, off in enumerate(op.offsets):
        plane = np.zeros(pn)
        plane[core] = coeffs[k]
        # zero entries whose target i+off is a padding vertex
        tgt_valid = np.ones(pn)
        for d, o in enumerate(off):
            idx_d = np.arange(pn[d]) + o
            v = (idx_d >= 0) & (idx_d <= pn[d] - 2)  # pn[d]-1 is padding
            shp = [1] * len(pn)
            shp[d] = pn[d]
            tgt_valid = tgt_valid * v.reshape(shp)
        out[k] = plane * tgt_valid * valid
    out[op.diag_index] += 1.0 - valid  # unit diagonal on padding
    return out


def _dense_from_padded(coeffs: np.ndarray, offsets, pn) -> np.ndarray:
    """Dense matrix of a padded stencil (lexicographic padded order)."""
    n = int(np.prod(pn))
    A = np.zeros((n, n))
    idx = np.arange(n).reshape(pn)
    for k, off in enumerate(offsets):
        src_sl, tgt_sl = [], []
        for o, m in zip(off, pn):
            if o >= 0:
                src_sl.append(slice(0, m - o))
                tgt_sl.append(slice(o, m))
            else:
                src_sl.append(slice(-o, m))
                tgt_sl.append(slice(0, m + o))
        rows = idx[tuple(src_sl)].ravel()
        cols = idx[tuple(tgt_sl)].ravel()
        A[rows, cols] += coeffs[k][tuple(src_sl)].ravel()
    return A


# ---------------------------------------------------------------- level params
@dataclasses.dataclass
class _Level:
    """Per-level padded arrays + static metadata (host side)."""

    offsets: Tuple[Tuple[int, ...], ...]
    n_colors: int
    pad: int  # halo width = max |offset|
    sharded: bool
    pn: Tuple[int, ...]  # padded global extents
    arrays: dict  # name -> np/jnp array (possibly sharded at trace time)
    has_lowrank: bool


def _build_level(op: StencilOperator, omega: float, sharded: bool) -> _Level:
    pn = padded_extents(op.vshape)
    coloring = coloring_for(op.offsets, op.vshape)
    valid = _valid_mask(pn)
    # colour field over *global padded* indices with the same linear-mod
    # weights as the unsharded colouring (padding sits at the end, so valid
    # vertices keep their colours); folded with validity so padded entries are
    # never updated
    grids = np.meshgrid(*[np.arange(m) for m in pn], indexing="ij")
    cfield = np.zeros(pn, dtype=np.int64)
    for g, w in zip(grids, coloring.weights):
        cfield += w * g
    cfield %= coloring.n_colors
    masks = np.stack(
        [(cfield == c) * valid for c in range(coloring.n_colors)]
    )
    coeffs = _pad_coeffs(op, pn)
    diag = coeffs[op.diag_index]
    arrays = {
        "coeffs": coeffs,
        "diag": diag,
        "masks": masks,
        "valid": valid,
        # sqrt(D (2-omega)/omega) on valid vertices, 0 on padding
        # (sor_sampler.cc:22-27)
        "noise_scale": np.sqrt(np.maximum(diag * (2.0 - omega) / omega, 0.0))
        * valid,
    }
    has_lowrank = op.lowrank is not None
    if has_lowrank:
        m = op.m_lowrank
        core = tuple(slice(0, s) for s in op.vshape)
        B = np.zeros((m,) + pn)
        B[(slice(None),) + core] = np.asarray(op.lowrank.B, dtype=np.float64)
        arrays["B"] = B
        arrays["Sigma_inv_sqrt"] = 1.0 / np.sqrt(
            np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)
        )
        # Woodbury correction factors for both sweep directions
        # (sor_smoother.cc:17-37), computed on the unpadded operator and
        # zero-padded (corrections never touch padding)
        unp_masks = jnp.asarray(coloring.masks(), dtype=op.coeffs.dtype)
        for name, order in (
            ("B_bar_fwd", color_order(coloring.n_colors, FORWARD)),
            ("B_bar_bwd", color_order(coloring.n_colors, BACKWARD)),
        ):
            bb = np.asarray(compute_B_bar(op, unp_masks, omega, order))
            pb = np.zeros((m,) + pn)
            pb[(slice(None),) + core] = bb
            arrays[name] = pb
    pad = max(max(abs(o) for o in off) for off in op.offsets)
    return _Level(
        offsets=op.offsets,
        n_colors=coloring.n_colors,
        pad=pad,
        sharded=sharded,
        pn=pn,
        arrays=arrays,
        has_lowrank=has_lowrank,
    )


# --------------------------------------------------------------- local kernels
def _local_apply(coeffs, xp, offsets, pad: int, grid_ndim: int):
    """Stencil apply on a halo-padded local block (core region output)."""
    core = xp.shape[-grid_ndim:]
    out = None
    for k, off in enumerate(offsets):
        idx = tuple(
            slice(pad + o, pad + o + (n - 2 * pad)) for o, n in zip(off, core)
        )
        t = coeffs[k] * xp[(Ellipsis,) + idx]
        out = t if out is None else out + t
    return out


def _replicated_apply(coeffs, x, offsets):
    out = None
    for k, off in enumerate(offsets):
        t = coeffs[k] * shift(x, off)
        out = t if out is None else out + t
    return out


class ShardedMGMCSampler:
    """Multigrid Monte Carlo sampler running the full cycle under shard_map.

    Drop-in counterpart of :class:`multigridmc_tpu.samplers.mgmc.MultigridMCSampler`
    for a ``chains x lattice`` device mesh.  ``apply`` consumes and produces
    *padded* global fields (see :func:`pad_field` / :func:`unpad_field`).

    Parameters mirror ``MultigridParameters`` (``parameters.hh:145-174``);
    ``agglomerate_below`` is the per-dim local-block extent under which a level
    is replicated on every shard instead of sharded (coarse-level agglomeration,
    cf. SURVEY.md section 5).
    """

    def __init__(
        self,
        op: StencilOperator,
        nlevel: int,
        mesh: Mesh,
        *,
        smoother: str = "SOR",
        coarse_solver: str = "Cholesky",
        npresmooth: int = 1,
        npostsmooth: int = 1,
        ncoarsesmooth: int = 1,
        omega: float = 1.0,
        cycle: int = 1,
        coarse_scaling: float = 1.0,
        agglomerate_below: int = 8,
        noise_mode: str = "sharded",
        deterministic: bool = False,
        hierarchy: Optional[MultigridHierarchy] = None,
        distill: object = "auto",
    ):
        if smoother.upper() not in ("SOR", "SSOR"):
            raise ValueError(f"invalid smoother '{smoother}'")
        self.op = op
        self.mesh = mesh
        self.smoother = smoother.upper()
        self.coarse_solver = coarse_solver.lower()
        self.npresmooth = int(npresmooth)
        self.npostsmooth = int(npostsmooth)
        self.ncoarsesmooth = int(ncoarsesmooth)
        self.omega = float(omega)
        self.cycle = int(cycle)
        self.coarse_scaling = float(coarse_scaling)
        self.noise_mode = noise_mode
        self.deterministic = bool(deterministic)
        self.dtype = op.coeffs.dtype

        names = mesh.axis_names
        self.chains_axis = "chains" if "chains" in names else None
        self.lattice_axes = tuple(n for n in names if n != "chains")
        self.dim = op.lattice.dim
        if len(self.lattice_axes) != self.dim:
            raise ValueError(
                f"mesh lattice axes {self.lattice_axes} do not match lattice "
                f"dim {self.dim}"
            )
        self.mesh_shape = {n: mesh.shape[n] for n in names}

        hierarchy = hierarchy or MultigridHierarchy(op, nlevel)
        self.nlevel = hierarchy.nlevel
        S = [self.mesh_shape[a] for a in self.lattice_axes]
        flags = []
        for level_op in hierarchy.operators:
            pn = padded_extents(level_op.vshape)
            flags.append(
                all(p % s == 0 and p // s >= agglomerate_below for p, s in zip(pn, S))
            )
        # the dense-Cholesky coarse solve is replicated by construction
        # (multigridmc_sampler.cc:105-109 hands the coarsest level to one
        # factorisation); levels must also go sharded -> replicated
        # monotonically (prolongation assumes the finer level of a transition
        # is the sharded one)
        if self.coarse_solver == "cholesky":
            flags[-1] = False
        for i in range(1, len(flags)):
            flags[i] = flags[i] and flags[i - 1]
        if not flags[0]:
            import warnings

            warnings.warn(
                f"finest level {hierarchy.operators[0].vshape} is not "
                f"shardable over lattice mesh {S} with agglomerate_below="
                f"{agglomerate_below}: the cycle will run fully REPLICATED "
                f"over the lattice axes (correct, but each device repeats "
                f"the full lattice work); lower agglomerate_below, shrink "
                f"the lattice mesh, or use the chains-data-parallel sampler",
                stacklevel=3)
        self.levels: List[_Level] = [
            _build_level(level_op, self.omega, flag)
            for level_op, flag in zip(hierarchy.operators, flags)
        ]

        # coarse-level direct factor (dense padded Cholesky, replicated):
        # blockdiag(Q_valid, I) by construction of _pad_coeffs
        if self.coarse_solver == "cholesky":
            lv = self.levels[-1]
            Q = _dense_from_padded(lv.arrays["coeffs"], lv.offsets, lv.pn)
            cop = hierarchy.operators[-1]
            if cop.lowrank is not None:
                Bp = lv.arrays["B"].reshape(cop.m_lowrank, -1)
                S = np.asarray(cop.lowrank.Sigma_diag, dtype=np.float64)
                Q = Q + Bp.T @ np.diag(1.0 / S) @ Bp
            lv.arrays["chol_L"] = np.linalg.cholesky(Q)
        elif self.coarse_solver != "ssor":
            raise ValueError(f"invalid coarse sampler '{coarse_solver}'")

        self.distilled = None
        self.distill_level: Optional[int] = None
        self._build_distilled(hierarchy, flags, distill)
        self._apply = self._make_apply()

    # ----------------------------------------------------------- distillation
    def _build_distilled(self, hierarchy, flags, distill):
        """Distil the *replicated* coarse subtree: below the
        agglomeration threshold every shard executes the identical replicated
        recursion (``multigridmc_sampler.cc:105-109``), which is exactly the
        single-device affine-Gaussian subtree of :mod:`samplers.distill` - so
        swap it for the (replicated) ``x = T f + S xi`` map, deleting the
        latency-bound sub-level tail from the multi-device path.

        Engaged only in ``"sharded"`` (production) noise mode: the map draws
        its noise differently from the composed recursion, so the ``"global"``
        validation mode (bitwise mesh-shape equivalence, whose distill level
        would also differ between mesh shapes) keeps the composed levels.
        Auto mode requires an accelerator backend; ``distill=True`` forces it
        (CPU statistical tests), ``distill=False`` disables it."""
        if self.deterministic or self.coarse_solver != "cholesky":
            return
        if self.noise_mode != "sharded":
            return
        if self.smoother not in ("SOR", "SSOR"):
            return
        if distill is False or (distill == "auto" and not on_accelerator()):
            return
        from ..samplers.distill import distill_subtree, pick_distill_level

        li = pick_distill_level(hierarchy.operators)
        if li is None:
            return
        # the map executes replicated: advance to the first replicated level
        while li < self.nlevel - 1 and flags[li]:
            li += 1
        if li >= self.nlevel - 1:
            return  # only the coarsest qualifies: a matmul replaces a matmul
        from ..samplers.cholesky import DenseCholeskySampler
        from ..samplers.sor import SORSampler, SSORSampler

        ops = hierarchy.operators
        pres, posts = [], []
        for lop in ops[li:]:
            if self.smoother == "SOR":
                pres.append(SORSampler(lop, self.omega, self.npresmooth, FORWARD))
                posts.append(SORSampler(lop, self.omega, self.npostsmooth, BACKWARD))
            else:
                pres.append(SSORSampler(lop, self.omega, self.npresmooth))
                posts.append(SSORSampler(lop, self.omega, self.npostsmooth))
        self.distilled = distill_subtree(
            ops[li:], pres, posts, DenseCholeskySampler(ops[-1]),
            self.cycle, self.coarse_scaling, noise=True,
        )
        self.distill_level = li
        self._distill_vshape = ops[li].vshape
        # ship T/S through the shard_map params (replicated constants)
        self.levels[li].arrays["distill_Tm"] = np.asarray(self.distilled.Tm)
        self.levels[li].arrays["distill_ST"] = np.asarray(self.distilled.S_T)

    def _distilled_apply(self, key, fc, p, chains_total):
        """One replicated subtree invocation ``x = T f + S xi`` on the padded
        layout (production per-shard noise: fold only the chains shard - all
        lattice shards must produce the identical replicated value)."""
        dim = self.dim
        vshape = self._distill_vshape
        Tm, S_T = p["distill_Tm"], p["distill_ST"]
        fc_u = unpad_field(fc, vshape)
        batch = fc_u.shape[: fc_u.ndim - dim]
        n = Tm.shape[0]
        fl = fc_u.reshape(batch + (n,))
        prec = self.distilled.precision
        x = jnp.tensordot(fl, Tm, axes=([fl.ndim - 1], [0]), precision=prec)
        k = (jax.random.fold_in(key, jax.lax.axis_index(self.chains_axis))
             if self.chains_axis else key)
        xi = jax.random.normal(k, batch + (n,), dtype=fc.dtype)
        x = x + jnp.tensordot(xi, S_T, axes=([xi.ndim - 1], [0]), precision=prec)
        return pad_field(x.reshape(batch + vshape), vshape)

    # ------------------------------------------------------------------ specs
    def _lattice_spec(self, level: _Level, leading: int = 0) -> P:
        if level.sharded:
            return P(*([None] * leading), *self.lattice_axes)
        return P()

    def _params_and_specs(self):
        params, specs = [], []
        for lv in self.levels:
            p, s = {}, {}
            for name, arr in lv.arrays.items():
                a = jnp.asarray(arr, dtype=self.dtype)
                p[name] = a
                if name in ("coeffs", "masks", "B", "B_bar_fwd", "B_bar_bwd"):
                    s[name] = self._lattice_spec(lv, leading=1)
                elif name in ("diag", "valid", "noise_scale"):
                    s[name] = self._lattice_spec(lv)
                else:  # Sigma_inv_sqrt, chol_L: small, replicated
                    s[name] = P()
            params.append(p)
            specs.append(s)
        return params, specs

    # -------------------------------------------------------- in-shard helpers
    def _shard_linear_index(self, with_chains: bool):
        """Linear index of this shard over (chains x lattice) axes."""
        idx = jnp.int32(0)
        axes = (
            ((self.chains_axis,) if (with_chains and self.chains_axis) else ())
            + self.lattice_axes
        )
        for a in axes:
            idx = idx * self.mesh_shape[a] + jax.lax.axis_index(a)
        return idx

    def _local_block_starts(self, pn):
        starts = []
        for a, p in zip(self.lattice_axes, pn):
            b = p // self.mesh_shape[a]
            starts.append(jax.lax.axis_index(a) * b)
        return starts

    def _noise(self, key, level: _Level, local_shape, chains_total):
        """Per-sweep Gaussian field, matching the level's sharding."""
        gshape = (
            ((chains_total,) if self.chains_axis else ())
            + (level.pn if level.sharded else level.pn)
        )
        if self.noise_mode == "global":
            xi = jax.random.normal(key, gshape, dtype=self.dtype)
            if not level.sharded and not self.chains_axis:
                return xi
            starts = []
            sizes = []
            if self.chains_axis:
                cb = chains_total // self.mesh_shape[self.chains_axis]
                starts.append(jax.lax.axis_index(self.chains_axis) * cb)
                sizes.append(cb)
            if level.sharded:
                starts += self._local_block_starts(level.pn)
                sizes += list(local_shape[-self.dim:])
            else:
                starts += [0] * self.dim
                sizes += list(level.pn)
            starts = [jnp.asarray(s_, jnp.int32) for s_ in starts]
            return jax.lax.dynamic_slice(xi, starts, sizes)
        # production: independent per-shard streams; replicated levels fold
        # only the chains shard (all lattice shards must draw identically)
        k = jax.random.fold_in(key, self._shard_linear_index(True))
        if not level.sharded:
            if self.chains_axis:
                k = jax.random.fold_in(
                    key, jax.lax.axis_index(self.chains_axis)
                )
            else:
                k = key
        return jax.random.normal(k, local_shape, dtype=self.dtype)

    def _lowrank_noise(self, key, level: _Level, batch_shape, chains_total):
        """The m-dimensional measurement-noise draw B Sigma^{-1/2} xi'
        (sor_sampler.cc:48-56); identical on every lattice shard."""
        m = level.arrays["B"].shape[0] if level.has_lowrank else 0
        gshape = ((chains_total,) if self.chains_axis else ()) + (m,)
        if self.noise_mode == "global" or not self.chains_axis:
            xi = jax.random.normal(key, gshape, dtype=self.dtype)
            if self.chains_axis:
                cb = chains_total // self.mesh_shape[self.chains_axis]
                xi = jax.lax.dynamic_slice(
                    xi,
                    (jax.lax.axis_index(self.chains_axis) * cb, jnp.int32(0)),
                    (cb, m),
                )
            return xi
        k = jax.random.fold_in(key, jax.lax.axis_index(self.chains_axis))
        return jax.random.normal(k, batch_shape + (m,), dtype=self.dtype)

    def _apply_stencil(self, lv: _Level, p, x):
        if lv.sharded:
            xp = halo_exchange(x, lv.pad, self.lattice_axes)
            return _local_apply(p["coeffs"], xp, lv.offsets, lv.pad, self.dim)
        return _replicated_apply(p["coeffs"], x, lv.offsets)

    def _bt_psum(self, lv: _Level, p, x):
        """B^T x with the lattice-axis all-reduce (m scalars per chain)."""
        d = self.dim
        bt = jnp.tensordot(
            x,
            p["B"],
            axes=(tuple(range(x.ndim - d, x.ndim)), tuple(range(1, d + 1))),
            precision=jax.lax.Precision.HIGHEST,
        )
        if lv.sharded:
            bt = jax.lax.psum(bt, self.lattice_axes)
        return bt

    def _sweep(self, lv: _Level, p, order, b, x):
        """One multi-colour SOR sweep + Woodbury correction (the exact
        splitting of smoothers.sor_sweep under explicit halos)."""
        for c in order:
            ax = self._apply_stencil(lv, p, x)
            x = x + p["masks"][c] * (self.omega * (b - ax) / p["diag"])
        if lv.has_lowrank:
            bb = p["B_bar_fwd"] if order[0] == 0 else p["B_bar_bwd"]
            bt = self._bt_psum(lv, p, x)
            x = x - jnp.tensordot(
                bt, bb, axes=([bt.ndim - 1], [0]),
                precision=jax.lax.Precision.HIGHEST,
            )
        return x

    def _gibbs_sweeps(self, lv, p, key, f, x, direction, nsmooth, chains_total):
        orders = (
            [color_order(lv.n_colors, direction)]
            if self.smoother == "SOR"
            else [
                color_order(lv.n_colors, FORWARD),
                color_order(lv.n_colors, BACKWARD),
            ]
        )
        batch_shape = x.shape[: x.ndim - self.dim]
        for k in range(nsmooth):
            kk = jax.random.fold_in(key, k)
            for j, order in enumerate(orders):
                kj = jax.random.fold_in(kk, j) if len(orders) > 1 else kk
                if self.deterministic:
                    c = f
                else:
                    kx, kb = jax.random.split(kj)
                    xi = self._noise(kx, lv, x.shape, chains_total)
                    c = f + p["noise_scale"] * xi
                    if lv.has_lowrank:
                        xl = self._lowrank_noise(kb, lv, batch_shape, chains_total)
                        c = c + jnp.tensordot(
                            xl * p["Sigma_inv_sqrt"], p["B"],
                            axes=([xl.ndim - 1], [0]),
                            precision=jax.lax.Precision.HIGHEST,
                        )
                x = self._sweep(lv, p, order, c, x)
        return x

    # ------------------------------------------------------------ intergrid
    def _restrict(self, fine_lv: _Level, coarse_lv: _Level, p_c, r):
        """Full-weighting restriction on padded layout: coarse c <- fine 2c+1
        (intergrid_operator.hh:74-88 with the linear weights of
        intergrid_operator_linear.cc:13-30), local up to a width-1 halo."""
        dim = self.dim
        if fine_lv.sharded:
            rp = halo_exchange(r, 1, self.lattice_axes)
        else:
            rp = jnp.pad(
                r, [(0, 0)] * (r.ndim - dim) + [(1, 1)] * dim
            )
        # per-axis gather: out[..., c, ...] = 0.5 rp[2c+1] + rp[2c+2] + 0.5 rp[2c+3]
        # (rp index = fine local index + 1)
        out = rp
        for d in range(dim):
            ax = out.ndim - dim + d
            n = out.shape[ax]
            bc = (n - 2) // 2

            def sl(start):
                idx = [slice(None)] * out.ndim
                idx[ax] = slice(start, start + 2 * bc, 2)
                return out[tuple(idx)]

            out = 0.5 * sl(1) + sl(2) + 0.5 * sl(3)
        if fine_lv.sharded and not coarse_lv.sharded:
            # agglomerate: gather the (tiny) coarse field to every shard
            for a in self.lattice_axes:
                d = out.ndim - self.dim + self.lattice_axes.index(a)
                out = jax.lax.all_gather(out, a, axis=d, tiled=True)
        # zero the padding vertices (their gathered values are garbage)
        return out * p_c["valid"]

    def _prolongate_add(self, fine_lv: _Level, coarse_lv: _Level, xc, x):
        """x += coarse_scaling * P xc on padded layout
        (intergrid_operator.hh:106-120)."""
        dim = self.dim
        if fine_lv.sharded and not coarse_lv.sharded:
            # slice this shard's coarse block (+1 halo) out of the replicated
            # field; pad first so boundary shards read zero ghosts
            xcp = jnp.pad(xc, [(0, 0)] * (xc.ndim - dim) + [(1, 1)] * dim)
            starts = [0] * (xc.ndim - dim)
            sizes = list(xc.shape[: xc.ndim - dim])
            for a, pdim in zip(self.lattice_axes, coarse_lv.pn):
                b = pdim // self.mesh_shape[a]
                starts.append(jax.lax.axis_index(a) * b)  # +1 halo -1 offset
                sizes.append(b + 2)
            starts = [jnp.asarray(s_, jnp.int32) for s_ in starts]
            xcp = jax.lax.dynamic_slice(xcp, starts, sizes)
        elif fine_lv.sharded:
            xcp = halo_exchange(xc, 1, self.lattice_axes)
        else:
            xcp = jnp.pad(xc, [(0, 0)] * (xc.ndim - dim) + [(1, 1)] * dim)
        # per-axis expansion bc -> 2*bc:
        #   fine odd  f=2k+1 : coarse k        = xcp[k+1]
        #   fine even f=2k   : 0.5 (coarse k-1 + coarse k) = 0.5 (xcp[k] + xcp[k+1])
        out = xcp
        for d in range(dim):
            ax = out.ndim - dim + d
            n = out.shape[ax]
            bc = n - 2

            def sl(a, b):
                idx = [slice(None)] * out.ndim
                idx[ax] = slice(a, b)
                return out[tuple(idx)]

            odd = sl(1, bc + 1)
            even = 0.5 * (sl(0, bc) + sl(1, bc + 1))
            stacked = jnp.stack([even, odd], axis=ax + 1)
            shape = list(stacked.shape)
            shape[ax] = 2 * bc
            del shape[ax + 1]
            out = stacked.reshape(shape)
        return x + self.coarse_scaling * out

    # ------------------------------------------------------------ coarse solve
    def _coarse_apply(self, lv: _Level, p, key, f, x, chains_total):
        if self.coarse_solver == "ssor":
            return self._gibbs_sweeps(
                lv, p, key, f, x, FORWARD, self.ncoarsesmooth, chains_total
            )
        L = p["chol_L"]
        n = L.shape[0]
        batch = f.shape[: f.ndim - self.dim]
        fv = f.reshape(batch + (n,))
        fv2 = fv.reshape(-1, n).T  # (n, nbatch)
        g = jax.scipy.linalg.solve_triangular(L, fv2, lower=True)
        if self.deterministic:
            rhs = g
        else:
            xi = self._noise(key, lv, batch + lv.pn, chains_total)
            rhs = xi.reshape(-1, n).T + g
        y = jax.scipy.linalg.solve_triangular(L.T, rhs, lower=False)
        y = y.T.reshape(batch + lv.pn)
        return y * p["valid"]

    # ----------------------------------------------------------------- cycle
    def _sample(self, level, params, key, f, x, chains_total):
        lv = self.levels[level]
        p = params[level]
        if level == self.nlevel - 1:
            return self._coarse_apply(lv, p, key, f, x, chains_total)
        ncycle = self.cycle if level > 0 else 1
        for j in range(ncycle):
            kpre, kcoarse, kpost = jax.random.split(
                jax.random.fold_in(key, j), 3
            )
            x = self._gibbs_sweeps(
                lv, p, kpre, f, x, FORWARD, self.npresmooth, chains_total
            )
            r = f - self._apply_stencil(lv, p, x)
            if lv.has_lowrank:
                bt = self._bt_psum(lv, p, x) * (p["Sigma_inv_sqrt"] ** 2)
                r = r - jnp.tensordot(
                    bt, p["B"], axes=([bt.ndim - 1], [0]),
                    precision=jax.lax.Precision.HIGHEST,
                )
            f_c = self._restrict(lv, self.levels[level + 1], params[level + 1], r)
            if self.distilled is not None and level + 1 == self.distill_level:
                x_c = self._distilled_apply(
                    kcoarse, f_c, params[level + 1], chains_total)
            else:
                x_c = jnp.zeros_like(f_c)
                x_c = self._sample(
                    level + 1, params, kcoarse, f_c, x_c, chains_total)
            x = self._prolongate_add(lv, self.levels[level + 1], x_c, x)
            x = self._gibbs_sweeps(
                lv, p, kpost, f, x, BACKWARD, self.npostsmooth, chains_total
            )
        return x

    # ------------------------------------------------------------------ entry
    def _make_apply(self):
        params, specs = self._params_and_specs()
        lv0 = self.levels[0]
        lat_spec = self._lattice_spec(lv0)
        # x follows the FINEST level's shardability: when even level 0 is
        # replicated (a mesh whose lattice axes don't divide the padded
        # extents), the whole cycle runs replicated over the lattice - each
        # device does the full lattice work redundantly but correctly, with
        # chains still data-parallel.  Sharding x over lattice axes while the
        # level arrays are replicated would mismatch shapes inside shard_map.
        if not self.chains_axis:
            x_spec = lat_spec
        elif lv0.sharded:
            x_spec = P(self.chains_axis, *self.lattice_axes)
        else:
            x_spec = P(self.chains_axis)

        def run(chains_total, key, f, x, *params):
            return self._sample(0, list(params), key, f, x, chains_total)

        shard_kwargs = dict(
            mesh=self.mesh,
            in_specs=(P(), lat_spec, x_spec) + tuple(specs),
            out_specs=x_spec,
        )

        def make_fn(chains_total):
            body = functools.partial(run, chains_total)
            return shard_map(body, check_vma=False, **shard_kwargs)

        @functools.partial(jax.jit, static_argnames=("chains_total",))
        def apply_jit(key, f, x, chains_total=None):
            return make_fn(chains_total)(key, f, x, *params)

        return apply_jit

    def apply(self, key, f, x):
        """One MGMC step on padded global fields (chain state carried, not
        zeroed - ``multigridmc_sampler.cc:133-139``)."""
        chains_total = (
            x.shape[0] if self.chains_axis and x.ndim > self.dim else None
        )
        return self._apply(key, f, x, chains_total=chains_total)
