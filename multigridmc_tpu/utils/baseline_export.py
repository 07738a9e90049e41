"""Export a multigrid hierarchy to the native CPU baseline binary format.

``native/baseline_mgmc.cc`` re-creates the reference's sequential CSR hot path
(lexicographic SOR Gibbs sweeps, MGMC recursion, dense coarse Cholesky) to give
an honest single-core baseline; this module serialises a problem for it:
per-level CSR operators, restriction/prolongation CSR, the reference's
lexicographic Woodbury factors B_bar (``sor_smoother.cc:17-37``), and the dense
coarse Cholesky factor.
"""

from __future__ import annotations

import struct
from typing import BinaryIO

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..ops.stencil import StencilOperator, interior_mask
from ..solvers.multigrid import MultigridHierarchy

MAGIC = 0x4D474D43


def stencil_to_csr(op: StencilOperator) -> sp.csr_matrix:
    """CSR form of the stencil part, rows in lexicographic vertex order."""
    vshape = op.vshape
    n = int(np.prod(vshape))
    strides = np.cumprod([1] + list(reversed(vshape)))[:-1][::-1]
    coeffs = np.asarray(op.coeffs, dtype=np.float64)
    rows, cols, vals = [], [], []
    idx = np.arange(n).reshape(vshape)
    for k, off in enumerate(op.offsets):
        shift = int(np.dot(off, strides))
        mask = interior_mask(vshape, off) > 0
        r = idx[mask]
        rows.append(r)
        cols.append(r + shift)
        vals.append(coeffs[k][mask])
    A = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(n, n),
    )
    return A.tocsr()


def transfer_to_csr(fine_vshape, coarse_vshape) -> sp.csr_matrix:
    """Prolongation P (n_fine x n_coarse) as CSR, d-linear weights
    (``intergrid_operator_linear.cc:13-30``).

    Column c has entries at fine vertices ``2c + 1 + o`` for offsets
    ``o in {-1,0,1}^d`` with weight ``prod_d {0.5, 1, 0.5}[o_d]`` - always
    in range since n_fine = 2 n_coarse + 1 per dim.
    """
    import itertools

    dim = len(fine_vshape)
    nc = int(np.prod(coarse_vshape))
    nf = int(np.prod(fine_vshape))
    fstrides = np.cumprod([1] + list(reversed(fine_vshape)))[:-1][::-1]
    coarse_coords = np.meshgrid(*[np.arange(m) for m in coarse_vshape], indexing="ij")
    fine_base = sum(
        (2 * coarse_coords[d] + 1) * fstrides[d] for d in range(dim)
    ).reshape(-1)
    cols0 = np.arange(nc)
    rows, cols, vals = [], [], []
    w1d = {-1: 0.5, 0: 1.0, 1: 0.5}
    for off in itertools.product((-1, 0, 1), repeat=dim):
        w = 1.0
        shift = 0
        for d in range(dim):
            w *= w1d[off[d]]
            shift += off[d] * fstrides[d]
        rows.append(fine_base + shift)
        cols.append(cols0)
        vals.append(np.full(nc, w))
    P = sp.coo_matrix(
        (np.concatenate(vals), (np.concatenate(rows), np.concatenate(cols))),
        shape=(nf, nc),
    )
    return P.tocsr()


def _write_i64(fp: BinaryIO, v: int) -> None:
    fp.write(struct.pack("<q", v))


def _write_f64(fp: BinaryIO, v: float) -> None:
    fp.write(struct.pack("<d", v))


def _write_csr(fp: BinaryIO, A: sp.csr_matrix) -> None:
    A = A.tocsr()
    A.sort_indices()
    _write_i64(fp, A.shape[0])
    _write_i64(fp, A.shape[1])
    _write_i64(fp, A.nnz)
    fp.write(np.asarray(A.indptr, dtype=np.int64).tobytes())
    fp.write(np.asarray(A.indices, dtype=np.int64).tobytes())
    fp.write(np.asarray(A.data, dtype=np.float64).tobytes())


def _lexicographic_b_bar(A: sp.csr_matrix, B: np.ndarray, Sigma_diag, omega: float):
    """The reference's Woodbury factors with *lexicographic* splitting
    (``sor_smoother.cc:17-37``)."""
    n = A.shape[0]
    D = sp.diags(A.diagonal())
    A_scaled = (A + (1.0 - omega) / omega * D).tocsr()
    M_fw = sp.tril(A_scaled, format="csr")
    M_bw = sp.triu(A_scaled, format="csr")
    Y_fw = spla.spsolve_triangular(M_fw.tocsr(), B, lower=True)
    Y_bw = spla.spsolve_triangular(M_bw.tocsr(), B, lower=False)
    Sigma = np.diag(np.asarray(Sigma_diag))
    Bbar_fw = Y_fw @ np.linalg.inv(Sigma + B.T @ Y_fw)
    Bbar_bw = Y_bw @ np.linalg.inv(Sigma + B.T @ Y_bw)
    return Bbar_fw, Bbar_bw


def export_problem(
    hierarchy: MultigridHierarchy, path: str, omega: float = 1.0, cycle: int = 2
) -> None:
    ops = hierarchy.operators
    nlevel = hierarchy.nlevel
    with open(path, "wb") as fp:
        _write_i64(fp, MAGIC)
        _write_i64(fp, nlevel)
        _write_i64(fp, cycle)
        _write_f64(fp, omega)
        for level, op in enumerate(ops):
            A = stencil_to_csr(op)
            _write_csr(fp, A)
            fp.write(A.diagonal().astype(np.float64).tobytes())
            m = op.m_lowrank
            _write_i64(fp, m)
            if m:
                B = np.asarray(op.lowrank.B, dtype=np.float64).reshape(m, -1).T  # (n, m)
                Sigma_diag = np.asarray(op.lowrank.Sigma_diag, dtype=np.float64)
                Bbar_fw, Bbar_bw = _lexicographic_b_bar(A, B, Sigma_diag, omega)
                fp.write(np.ascontiguousarray(B).tobytes())
                fp.write(np.ascontiguousarray(Bbar_fw).tobytes())
                fp.write(np.ascontiguousarray(Bbar_bw).tobytes())
                fp.write((1.0 / np.sqrt(Sigma_diag)).tobytes())
            if level < nlevel - 1:
                P = transfer_to_csr(op.vshape, ops[level + 1].vshape)
                _write_csr(fp, P.T.tocsr())  # R = P^T
                _write_csr(fp, P)
        coarse = ops[-1]
        Q = coarse.to_dense()
        L = np.linalg.cholesky(Q)
        _write_i64(fp, Q.shape[0])
        fp.write(np.ascontiguousarray(L, dtype=np.float64).tobytes())


def measure_baseline_main(argv=None):
    """Standalone entry: build the bench problem on CPU/f64, export it, compile
    and run the native baseline, and print one JSON line with the result.

    Run as ``python -m multigridmc_tpu.utils.baseline_export NX NLEVEL CYCLE
    NWARMUP NSAMPLES`` - used by bench.py in a subprocess so the float64 CPU
    work never touches the accelerator.
    """
    import json
    import subprocess
    import sys
    import tempfile
    from pathlib import Path

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)

    argv = argv if argv is not None else sys.argv[1:]
    nx, nlevel, cycle, nwarmup, nsamples = (int(v) for v in argv[:5])

    import bench  # repo-root bench module defines the canonical problem

    bench.NX = nx  # build_problem reads the module constant at call time
    op = bench.build_problem()
    from ..solvers.multigrid import MultigridHierarchy

    hierarchy = MultigridHierarchy(op, nlevel)
    workdir = Path(tempfile.mkdtemp(prefix="mgmc_baseline_"))
    problem_path = str(workdir / "problem.bin")
    export_problem(hierarchy, problem_path, omega=1.0, cycle=cycle)

    binary = workdir / "baseline_mgmc"
    src = Path(__file__).resolve().parents[2] / "native" / "baseline_mgmc.cc"
    subprocess.run(
        ["g++", "-O3", "-march=native", "-std=c++17", "-o", str(binary), str(src)],
        check=True,
    )
    out = subprocess.run(
        [str(binary), problem_path, str(nwarmup), str(nsamples)],
        check=True, capture_output=True, text=True,
    )
    result = json.loads(out.stdout.strip())
    result.update({"nx": nx, "nlevel": nlevel, "source": "native/baseline_mgmc.cc"})
    print(json.dumps(result))


if __name__ == "__main__":
    measure_baseline_main()
