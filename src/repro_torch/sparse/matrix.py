"""CSC design matrices for the solve engine (port of
``repro.sparse.matrix.CSCDesign``, single device).

``CSCDesign`` is the sparse implementation of the design protocol of
``core/engine.py``: flat CSC arrays padded by one column window
(``max_col_nnz`` entries of value 0.0, column id p - 1, row 0) so the
working-set window gather never runs past the end, plus the cached squared
column norms, the only design statistic the datafits need for their
Lipschitz constants. Any scipy sparse matrix converts through
``from_scipy`` (canonicalized to sorted, deduplicated CSC on the host);
indices and column ids are int32, indptr int64.

``ell=True`` flags the ELL layout ``rows/vals [p, m]`` of the reference's
Pallas score kernel. The port's score kernel K5 walks the CSC segments
instead (far fewer bytes on a power-law design), so the layout is never
stored: ``ell_rows`` / ``ell_vals`` derive it from the CSC arrays when
asked (validation only). The flag keeps the reference's public contract:
``has_ell``, ``score_ell_reference``, and ``use_kernels=True`` on a sparse
design requires it (``PALLAS_SPARSE_ELL_ERROR``).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .. import resolve_device
from ..core.engine import Design
from ..kernels import ops as kops
from .ops import (csc_column_windows, csc_gather_columns, csc_incremental_xb,
                  csc_matvec, csc_score, csc_score_ell, csc_weighted_col_sq)

__all__ = ["CSCDesign"]


def _ell_from_flat(data, indices, col_ids, indptr, m):
    """ELL layout [p, m] (rows / vals, padding 0) of flat CSC arrays, on
    their device. CSC order is already column-major, rank-minor."""
    p = indptr.numel() - 1
    nnz = int(indptr[-1])
    cols = col_ids[:nnz].long()
    ranks = torch.arange(nnz, device=indptr.device) - indptr[cols]
    rows = torch.zeros((p, m), dtype=indices.dtype, device=indices.device)
    vals = torch.zeros((p, m), dtype=data.dtype, device=data.device)
    rows[cols, ranks] = indices[:nnz]
    vals[cols, ranks] = data[:nnz]
    return rows, vals


@dataclass(frozen=True)
class CSCDesign(Design):
    """CSC design on one device: data/indices/col_ids [nnz + m]
    (window-padded), indptr [p + 1], col_sq [p]; ``shape`` (n, p), the max
    column nnz ``max_col_nnz`` (m) and the ELL flag ``ell``."""
    data: torch.Tensor
    indices: torch.Tensor
    col_ids: torch.Tensor
    indptr: torch.Tensor
    col_sq: torch.Tensor
    shape: Tuple[int, int]
    max_col_nnz: int
    ell: bool = False

    KIND = "csc"

    # ------------------------------------------------------------ construction
    @classmethod
    def from_scipy(cls, A, *, dtype=None, ell: bool = False,
                   device=None) -> "CSCDesign":
        """Build from any scipy sparse matrix (CSC/CSR/COO; converted and
        canonicalized). ``dtype=None`` keeps a floating matrix's dtype and
        takes float64 otherwise; ``device=None`` means CUDA and raises
        without a card."""
        A = A.tocsc()
        A.sort_indices()
        A.sum_duplicates()
        if dtype is None:
            dtype = A.dtype if A.dtype in (np.float32, np.float64) \
                else np.float64
        return cls.from_arrays(A.data.astype(dtype), A.indices, A.indptr,
                               A.shape, ell=ell, device=device)

    @classmethod
    def from_arrays(cls, data, indices, indptr, shape, *, ell: bool = False,
                    max_col_nnz: Optional[int] = None, device=None):
        """Build from canonical (sorted, deduplicated) flat CSC arrays.
        `max_col_nnz` overrides the derived window size and must be at
        least the true maximum column nnz."""
        device = resolve_device(device)
        data = np.asarray(data)
        indices = np.asarray(indices, np.int32)
        indptr = np.asarray(indptr, np.int64)
        n, p = shape
        col_nnz = np.diff(indptr)
        m = max(1, int(col_nnz.max())) if p else 1
        if max_col_nnz is not None:
            if max_col_nnz < m:
                raise ValueError(
                    f"max_col_nnz={max_col_nnz} is below the true max "
                    f"column nnz {m}: gather windows would silently "
                    f"truncate columns")
            m = max_col_nnz
        col_ids = np.repeat(np.arange(p, dtype=np.int32), col_nnz)
        col_sq = np.zeros(p, data.dtype)
        np.add.at(col_sq, col_ids, data * data)
        # one gather window of padding: value 0.0, last column id, row 0
        pad_d = np.zeros(m, data.dtype)
        pad_i = np.zeros(m, np.int32)
        pad_c = np.full(m, max(p - 1, 0), np.int32)
        put = lambda a: torch.as_tensor(a, device=device)
        return cls(put(np.concatenate([data, pad_d])),
                   put(np.concatenate([indices, pad_i])),
                   put(np.concatenate([col_ids, pad_c])), put(indptr),
                   put(col_sq), (int(n), int(p)), m, bool(ell))

    def to(self, device) -> "CSCDesign":
        """This design with every array on `device`."""
        return dataclasses.replace(
            self, **{f: getattr(self, f).to(device) for f in (
                "data", "indices", "col_ids", "indptr", "col_sq")})

    # -------------------------------------------------------------- protocol
    @property
    def dtype(self):
        return self.data.dtype

    @property
    def device(self):
        return self.data.device

    @property
    def n_rows(self) -> int:
        return self.shape[0]

    @property
    def width(self) -> int:
        return self.shape[1]

    @property
    def nnz(self) -> int:
        """The true nnz, whatever padding the flat arrays carry (a host
        read of indptr's last entry)."""
        return int(self.indptr[-1])

    @property
    def has_ell(self) -> bool:
        return self.ell

    @property
    def ell_rows(self):
        """ELL row indices [p, m] (int32), derived on each call; None
        without the ELL flag."""
        return self._ell()[0]

    @property
    def ell_vals(self):
        """ELL values [p, m], derived on each call; None without the ELL
        flag."""
        return self._ell()[1]

    def _ell(self):
        if not self.ell:
            return None, None
        return _ell_from_flat(self.data, self.indices, self.col_ids,
                              self.indptr, self.max_col_nnz)

    def score(self, raw, use_kernels: bool = False):
        """X.T @ raw without dense X; ``use_kernels`` runs K5 (raw [n]) or
        K5b (raw [n, T], out [p, T])."""
        if use_kernels:
            if not self.has_ell:
                # defensive twin of SolveEngine.validate's entry check
                from ..core.engine import PALLAS_SPARSE_ELL_ERROR
                raise NotImplementedError(PALLAS_SPARSE_ELL_ERROR)
            kern = kops.csc_score_block if raw.ndim == 2 else kops.csc_score
            return kern(self.data, self.indices, self.col_ids, self.indptr,
                        raw)
        return csc_score(self.data, self.indices, self.col_ids, raw,
                         self.width)

    def gather_ws(self, ws):
        """Densify the working-set columns: (Xt_ws [K, n] feature-major,
        the (rows, vals) windows for the incremental Xb update)."""
        rows, vals = csc_column_windows(self.data, self.indices, self.indptr,
                                        ws, self.max_col_nnz)
        return csc_gather_columns(rows, vals, self.n_rows).T, (rows, vals)

    def update_xb(self, Xb, Xt_ws, aux, delta):
        """Xb + X_ws @ delta by a scatter add on the windows in `aux`."""
        rows, vals = aux
        return csc_incremental_xb(Xb, rows, vals, delta)

    def matvec(self, beta):
        """X @ beta for [p] (or [p, T]) coefficients."""
        return csc_matvec(self.data, self.indices, self.col_ids, beta,
                          self.n_rows)

    def lipschitz(self, datafit, w=None, use_kernels: bool = False):
        """Per-coordinate Lipschitz constants from the cached column norms,
        or from the w-weighted ones (K5s with ``use_kernels`` and an ELL
        layout, as the reference routes its Pallas kernel)."""
        if w is None:
            col_sq = self.col_sq
        elif use_kernels and self.has_ell:
            col_sq = kops.csc_weighted_col_sq(self.data, self.indices,
                                              self.col_ids, self.indptr, w)
        else:
            col_sq = csc_weighted_col_sq(self.data, self.indices,
                                         self.col_ids, w, self.width)
        return datafit.lipschitz_cols(col_sq, self.n_rows)

    def col_sq_norms(self):
        return self.col_sq

    @property
    def capacity(self) -> int:
        """Entries the flat arrays hold: nnz, the window of padding and any
        power-of-two padding of a column subset."""
        return self.data.shape[0]

    def take_columns(self, idx, out=None, nnz=None) -> "CSCDesign":
        """The design of the columns `idx` (an int tensor or array), an
        entry -1 giving an empty column (the screened path's power-of-two
        padding), built on this design's device. It keeps this design's
        window ``max_col_nnz`` and ELL flag and, as the reference does,
        pads its flat arrays to a power-of-two length (nnz + window), so
        subsets share their shapes. With `out`, a design of len(idx)
        columns whose flat arrays hold at least nnz + window entries, the
        subset is written into its arrays in place and `out` is returned
        (the screened path refills one design a (width, capacity), so its
        captured steps, which read the design in place, replay); its
        padding beyond the subset is rewritten as padding. `nnz`, the
        subset's nnz when the caller knows it, saves the one host read that
        sizes the arrays."""
        dev = self.device
        idx = torch.as_tensor(idx, device=dev).long()
        width = idx.shape[0]
        valid = idx >= 0
        sel = torch.clamp(idx, min=0)
        starts = self.indptr[sel]
        lens = torch.where(valid, self.indptr[sel + 1] - starts, 0)
        indptr = torch.zeros(width + 1, dtype=torch.int64, device=dev)
        torch.cumsum(lens, 0, out=indptr[1:])
        if nnz is None:
            nnz = int(indptr[-1])
        m = self.max_col_nnz
        if out is None:
            cap = 1 << max(0, nnz + m - 1).bit_length()
            out = CSCDesign(
                torch.empty(cap, dtype=self.dtype, device=dev),
                torch.empty(cap, dtype=torch.int32, device=dev),
                torch.empty(cap, dtype=torch.int32, device=dev),
                torch.empty(width + 1, dtype=torch.int64, device=dev),
                torch.empty(width, dtype=self.dtype, device=dev),
                (self.n_rows, width), m, self.ell)
        elif out.shape != (self.n_rows, width) or out.dtype != self.dtype \
                or out.device != dev or out.max_col_nnz != m \
                or out.capacity < nnz + m:
            raise ValueError(
                f"take_columns: out must be a {self.n_rows} x {width} "
                f"{self.dtype} design on {dev} with window {m} and room for "
                f"{nnz + m} entries, got {out.shape} {out.dtype} on "
                f"{out.device}, window {out.max_col_nnz}, capacity "
                f"{out.capacity}")
        # entry k of the subset: column c = col[k], rank k - indptr[c], at
        # starts[c] + rank in this design's arrays; past nnz, padding
        # (value 0.0, row 0, the last column's id)
        k = torch.arange(out.capacity, device=dev)
        col = torch.searchsorted(indptr, k, right=True) - 1
        inside = k < indptr[-1]
        col = torch.clamp(col, max=width - 1)
        src = torch.where(inside, starts[col] + (k - indptr[col]), 0)
        out.data.copy_(torch.where(inside, self.data[src], 0.0))
        out.indices.copy_(torch.where(inside, self.indices[src], 0))
        out.col_ids.copy_(col.to(torch.int32))
        out.indptr.copy_(indptr)
        out.col_sq.copy_(torch.where(valid, self.col_sq[sel], 0.0))
        return out

    def score_ell_reference(self, raw):
        """X.T @ raw over the ELL layout (validation)."""
        return csc_score_ell(*self._ell(), raw)

    def todense(self):
        """Dense [n, p] numpy copy: tests and debugging only."""
        nnz = self.nnz
        rows = self.indices[:nnz].cpu().numpy()
        cols = self.col_ids[:nnz].cpu().numpy()
        out = np.zeros(self.shape, self.data.cpu().numpy().dtype)
        out[rows, cols] = self.data[:nnz].cpu().numpy()
        return out
