"""K5 and K5s: the sparse score pass (``csrc/csc_score.cu``), its CUDA
launcher and its plain torch version.

K5 (``square=False``) replaces ``repro/sparse/ops.py:csc_score_pallas`` for
a raw vector [n]: ``X.T @ raw`` -> [p]. K5s (``square=True``) replaces
``csc_weighted_col_sq_pallas``: ``sum_i w_i x_ij^2`` -> [p], the weighted
Lipschitz statistic. Both take the design's window-padded CSC arrays:
``data`` and ``indices`` (int32) and ``col_ids`` (int32) of length
nnz + m, ``indptr`` (int64) of length p + 1. The kernel walks each column's
segment ``indptr[j] .. indptr[j+1]``; the plain version is the segment sum
of ``repro_torch.sparse.ops`` over ``col_ids``. The public, checked and
counted wrappers are ``kernels/ops.py:csc_score`` and
``csc_weighted_col_sq``.
"""
from __future__ import annotations

import torch

from ._build import BUILD
from .cd_epoch import _check_rc, _suffix

__all__ = ["csc_score_plain", "csc_score_cuda"]


def csc_score_plain(data, indices, col_ids, indptr, v, *, square=False):
    # imported here: repro_torch.sparse imports the kernel wrappers
    from ..sparse import ops as sops
    p = indptr.shape[0] - 1
    if square:
        return sops.csc_weighted_col_sq(data, indices, col_ids, v, p)
    return sops.csc_score(data, indices, col_ids, v, p)


def csc_score_cuda(data, indices, col_ids, indptr, v, *, square=False):
    """Launch K5 (or K5s) on the tensors' stream."""
    del col_ids                      # the kernel walks indptr's segments
    fn = getattr(BUILD.lib("csc_score"), f"csc_score_{_suffix(data)}")
    p = indptr.shape[0] - 1
    out = torch.empty(p, dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
                v.data_ptr(), out.data_ptr(), p, int(bool(square)), stream)
    _check_rc(rc, "csc_score")
    return out
