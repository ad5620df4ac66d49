"""The CSC primitives of the sparse design path (port of
``repro.sparse.ops``), in plain torch.

The flat CSC arrays are padded by one column window (``max_col_nnz``
entries of value 0.0, column id p - 1, row 0), so the per-column windows of
the working-set gather never run past the end, and padding entries add an
exact 0.0 to every scatter they join.

  csc_score            X.T @ raw as a segment sum over the nnz entries
  csc_weighted_col_sq  sum_i w_i x_ij^2 per column (weighted Lipschitz)
  csc_score_ell        X.T @ raw over the ELL layout [p, m]
  csc_column_windows   the (rows, vals) windows [K, m] of K columns
  csc_gather_columns   densify those windows into the [n, K] working set
  csc_incremental_xb   Xb + X_ws @ delta by a scatter add on the windows
  csc_matvec           X @ beta

The scatters are ``index_add_`` / ``index_put_(accumulate=True)``: on a
CUDA device they add with atomics, so ``csc_score``, ``csc_incremental_xb``
and ``csc_matvec`` are not bit-reproducible there (sums of several entries
land in any order); on the CPU they add in entry order. The gather only
ever adds 0.0 to an entry, so it stays exact. On a card ``CSCDesign``
takes the fixed-order routes instead: the score walk K5/K5b for
``lambda_max`` and the kernel route's heads, and K5r
(``kernels.ops.csc_row_sum``, each row's entries in the CPU's order) for
``matvec`` and ``update_xb``; these functions stay their CPU route and
plain versions.
"""
from __future__ import annotations

import torch

__all__ = ["csc_score", "csc_weighted_col_sq", "csc_score_ell",
           "csc_column_windows", "csc_gather_columns", "csc_incremental_xb",
           "csc_matvec"]


def csc_score(data, indices, col_ids, raw, p: int):
    """X.T @ raw over the flat CSC arrays -> [p] (or [p, T] for a
    multitask raw gradient [n, T])."""
    gathered = raw[indices]
    contrib = data * gathered if gathered.ndim == 1 \
        else data[:, None] * gathered
    out = torch.zeros((p,) + tuple(raw.shape[1:]), dtype=contrib.dtype,
                      device=contrib.device)
    return out.index_add_(0, col_ids, contrib)


def csc_weighted_col_sq(data, indices, col_ids, w, p: int):
    """Per-column weighted squared norms sum_i w_i x_ij^2 -> [p]."""
    contrib = data * data * w[indices]
    out = torch.zeros(p, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, col_ids, contrib)


def csc_score_ell(rows, vals, raw):
    """X.T @ raw over the ELL layout (rows/vals [p, m], padding 0.0)."""
    return torch.sum(vals * raw[rows], dim=1)


def csc_column_windows(data, indices, indptr, cols, max_col_nnz: int):
    """The nnz windows of the columns `cols`: (rows [K, m] int32,
    vals [K, m]) with vals 0.0 beyond each column's nnz, so window tails
    that run into the next column's entries add exact zeros downstream."""
    m = max_col_nnz
    starts = indptr[cols]
    nnz = indptr[cols + 1] - starts
    ar = torch.arange(m, device=indptr.device)
    pos = starts[:, None] + ar
    rows, vals = indices[pos], data[pos]
    return rows, torch.where(ar[None, :] < nnz[:, None], vals,
                             torch.zeros((), dtype=vals.dtype,
                                         device=vals.device))


def csc_gather_columns(rows, vals, n_rows: int):
    """Densify gathered windows into the working-set columns: returns the
    [n, K] transposed view of a contiguous feature-major [K, n] tensor."""
    K = rows.shape[0]
    Xt = torch.zeros((K, n_rows), dtype=vals.dtype, device=vals.device)
    kk = torch.arange(K, device=rows.device)[:, None].expand_as(rows)
    Xt.index_put_((kk, rows.long()), vals, accumulate=True)
    return Xt.T


def csc_incremental_xb(Xb, rows, vals, delta):
    """Xb + X_ws @ delta by a scatter add on the gathered windows; `delta`
    is [K] (Xb [n]) or [K, T] (Xb [n, T])."""
    if delta.ndim == 1:
        contrib = (vals * delta[:, None]).reshape(-1)
    else:
        contrib = (vals[:, :, None] * delta[:, None, :]).reshape(
            -1, delta.shape[1])
    inc = torch.zeros_like(Xb).index_add_(0, rows.reshape(-1), contrib)
    return Xb + inc


def csc_matvec(data, indices, col_ids, beta, n_rows: int):
    """X @ beta over the flat CSC arrays -> [n] (or [n, T] for beta
    [p, T])."""
    gathered = beta[col_ids]
    contrib = data * gathered if gathered.ndim == 1 \
        else data[:, None] * gathered
    out = torch.zeros((n_rows,) + tuple(beta.shape[1:]), dtype=data.dtype,
                      device=data.device)
    return out.index_add_(0, indices, contrib)
