"""Low-rank approximation of covariance matrices: pivoted Cholesky and friends.

Counterpart of the reference prototype ``python/pivoted_cholesky.py``
(Harbrecht, Peters & Schneider 2012): Crout Cholesky, LDL^T, *pivoted* Cholesky
with greedy diagonal pivoting and error tracking, and a truncated-SVD error
curve for comparison.

The pivoted Cholesky here is vectorised for accelerators: each of the (at most
``max_rank``) pivot steps updates a whole row with one fused vector operation
inside ``lax.fori_loop`` - O(rank * n) memory traffic instead of the reference's
O(rank * n) Python-loop iterations - and runs entirely on device.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


def cholesky_crout(A: jax.Array) -> jax.Array:
    """Unpivoted Crout Cholesky ``A = L L^T`` (cf. ``pivoted_cholesky.py:70-84``).

    Row-oriented loop body vectorised over columns.
    """
    A = jnp.asarray(A)
    n = A.shape[0]

    def body(m, state):
        L, diag = state
        lmm = jnp.sqrt(diag[m])
        # row m of L^T beyond m: (A[m,:] - L[:,m]^T L) / lmm, masked to i > m
        row = (A[m, :] - L[:, m] @ L) / lmm
        idx = jnp.arange(n)
        row = jnp.where(idx > m, row, 0.0).at[m].set(lmm)
        L = L.at[m, :].set(row)  # store row of the upper factor U = L^T
        diag = diag - jnp.where(idx > m, row**2, 0.0)
        return L, diag

    L0 = jnp.zeros_like(A)
    U, _ = jax.lax.fori_loop(0, n, body, (L0, jnp.diagonal(A)))
    return U.T  # lower factor


def cholesky_crout_ldlt(A: jax.Array) -> Tuple[jax.Array, jax.Array]:
    """Unpivoted ``A = L D L^T`` (cf. ``pivoted_cholesky.py:87-104``)."""
    A = jnp.asarray(A)
    n = A.shape[0]

    def body(m, state):
        U, D, diag = state
        d = diag[m]
        row = (A[m, :] - (U[:, m] * D) @ U) / d
        idx = jnp.arange(n)
        row = jnp.where(idx > m, row, 0.0).at[m].set(1.0)
        U = U.at[m, :].set(row)
        D = D.at[m].set(d)
        diag = diag - d * jnp.where(idx > m, row**2, 0.0)
        return U, D, diag

    U0 = jnp.zeros_like(A)
    U, D, _ = jax.lax.fori_loop(0, n, body, (U0, jnp.zeros(n, A.dtype), jnp.diagonal(A)))
    return U.T, D


def pivoted_cholesky(
    A: jax.Array, tolerance: float = 0.0, max_rank: int | None = None
) -> Tuple[np.ndarray, np.ndarray]:
    """Pivoted Cholesky low-rank approximation (cf. ``pivoted_cholesky.py:106-132``).

    Greedy diagonal pivoting; stops when the trace of the residual drops below
    ``tolerance * trace(A)`` or after ``max_rank`` steps.  Returns ``(L, rel_error)``
    with ``L`` of shape ``(n, rank)`` such that ``L L^T ~= A``, and the per-step
    relative trace error curve (rel_error[0] = 1).
    """
    A = jnp.asarray(A)
    n = A.shape[0]
    kmax = n if max_rank is None else min(max_rank, n)

    def body(m, state):
        L, diag, err = state
        # greedy pivot: largest remaining diagonal (already-chosen rows are 0)
        p = jnp.argmax(diag)
        lpp = jnp.sqrt(diag[p])
        col = (A[p, :] - L @ L[p, :]) / lpp
        col = col.at[p].set(lpp)
        col = jnp.where(diag > 0, col, 0.0).at[p].set(lpp)
        L = L.at[:, m].set(col)
        diag = (diag - col**2).at[p].set(0.0)
        diag = jnp.maximum(diag, 0.0)
        err = err.at[m + 1].set(jnp.sum(diag))
        return L, diag, err

    L0 = jnp.zeros((n, kmax), dtype=A.dtype)
    err0 = jnp.zeros(kmax + 1, dtype=A.dtype).at[0].set(jnp.sum(jnp.diagonal(A)))
    L, diag, err = jax.lax.fori_loop(0, kmax, body, (L0, jnp.diagonal(A), err0))

    err = np.asarray(err)
    rel = err / err[0]
    # truncate at the first step meeting the tolerance
    hits = np.nonzero(rel[1:] < tolerance)[0]
    rank = int(hits[0]) + 1 if len(hits) else kmax
    return np.asarray(L[:, :rank]), rel[: rank + 1]


def truncated_svd_error(A) -> np.ndarray:
    """Relative approximation error of rank-j truncated SVD for all j
    (cf. ``pivoted_cholesky.py:135-143``)."""
    A = np.asarray(A)
    U, S, VT = np.linalg.svd(A, hermitian=True)
    errors = []
    for j in range(A.shape[0]):
        errors.append(np.linalg.norm(A - U[:, :j] @ np.diag(S[:j]) @ VT[:j, :]))
    errors = np.asarray(errors)
    return errors / errors[0]
