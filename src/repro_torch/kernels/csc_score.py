"""K5, K5s and K5b: the sparse score pass (``csrc/csc_score.cu``), its
CUDA launchers and its plain torch version.

K5 (``square=False``) replaces ``repro/sparse/ops.py:csc_score_pallas`` for
a raw vector [n]: ``X.T @ raw`` -> [p]. K5s (``square=True``) replaces
``csc_weighted_col_sq_pallas``: ``sum_i w_i x_ij^2`` -> [p], the weighted
Lipschitz statistic. K5b replaces ``csc_score_pallas`` for a multitask raw
gradient [n, T] (row-major): ``X.T @ raw`` -> [p, T]. All take the
design's window-padded CSC arrays:
``data`` and ``indices`` (int32) and ``col_ids`` (int32) of length
nnz + m, ``indptr`` (int64) of length p + 1. The kernel walks each column's
segment ``indptr[j] .. indptr[j+1]``; the plain version is the segment sum
of ``repro_torch.sparse.ops`` over ``col_ids``. The public, checked and
counted wrappers are ``kernels/ops.py:csc_score``,
``csc_weighted_col_sq`` and ``csc_score_block``.
"""
from __future__ import annotations

import torch

from ._build import BUILD
from .cd_epoch import _check_rc, _suffix

__all__ = ["csc_score_plain", "csc_score_cuda", "csc_score_block_cuda",
           "l2_gather_probe_cuda"]


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


def csc_score_block_cuda(data, indices, col_ids, indptr, raw):
    """Launch K5b on the tensors' stream; raw is contiguous [n, T]."""
    del col_ids                      # the kernel walks indptr's segments
    fn = getattr(BUILD.lib("csc_score"), f"csc_score_block_{_suffix(data)}")
    p = indptr.shape[0] - 1
    T = raw.shape[1]
    out = torch.empty((p, T), dtype=data.dtype, device=data.device)
    with torch.cuda.device(data.device):
        stream = torch.cuda.current_stream(data.device).cuda_stream
        rc = fn(data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
                raw.data_ptr(), out.data_ptr(), p, T, stream)
    _check_rc(rc, "csc_score_block")
    return out


def l2_gather_probe_cuda(buf, gathers, blocks=132 * 8):
    """Enqueue `gathers` reads of rows of `buf` [rows, width] (float64,
    width 1 or 20) at hashed row indices: the floor of the gathers of raw
    through L2 that K5's and K5b's CSC column walk makes (counted in no
    launch count)."""
    lib = BUILD.lib("csc_score")
    rows, width = buf.shape
    out = torch.empty(1, dtype=torch.float64, device=buf.device)
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = lib.l2_gather_probe(buf.data_ptr(), rows, width, gathers, blocks,
                                 out.data_ptr(), stream)
    _check_rc(rc, "l2_gather_probe")
