"""K5, K5s and K5b: the sparse score pass (``csrc/csc_score.cu``), its
launch plan, CUDA launcher, a torch emulation of the kernel's summation
order and its plain torch version.

K5 (``square=False``) replaces ``repro/sparse/ops.py:csc_score_pallas`` for
a raw vector [n]: ``X.T @ raw`` -> [p]. K5s (``square=True``) replaces
``csc_weighted_col_sq_pallas``: ``sum_i w_i x_ij^2`` -> [p], the weighted
Lipschitz statistic. K5b replaces ``csc_score_pallas`` for a multitask raw
gradient [n, T] (row-major): ``X.T @ raw`` -> [p, T]. All take the
design's window-padded CSC arrays: ``data`` and ``indices`` (int32) and
``col_ids`` (int32) of length nnz + m, ``indptr`` (int64) of length p + 1.
The plain version is the segment sum of ``repro_torch.sparse.ops`` over
``col_ids``. The public, checked and counted wrappers are
``kernels/ops.py:csc_score``, ``csc_weighted_col_sq`` and
``csc_score_block``.

One kernel serves all three: a warp walks each column with its lanes
grouped over the entries' rows of raw (``csrc/csc_score.cu`` describes the
design). ``lane_plan`` is the one place that chooses its layout, from T:
the values a lane reads, the lanes an entry and the entries a warp
iteration. ``emulate`` computes the kernel's result in torch, in its
summation order, bit for bit.
"""
from __future__ import annotations

import torch

from ._build import BUILD
from .cd_epoch import _check_rc, _suffix

__all__ = ["csc_score_plain", "csc_score_cuda", "csc_score_block_cuda",
           "csc_walk_cuda", "l2_gather_probe_cuda", "lane_plan", "emulate"]


# lanes a column at T = 1 (K5, K5s; csrc/csc_score.cu's kK5Lanes): a warp
# walks two columns (16 lanes ran ~7% faster than 32, the layout this
# kernel replaced, and than 8 at sparse_fig2; PERF.md section 6)
K5_LANES = 16


def lane_plan(T: int):
    """(V, G, E) for raw [n, T]. T = 1 (K5, K5s): (1, K5_LANES, K5_LANES):
    the slots are a column's lanes. T > 1: V values a lane (2 where T is
    even: 16-byte loads of float64 pairs, else 1), G = min(32, ceil(T /
    V)) lanes an entry and E = 32 // G entries a warp iteration: T = 20
    gives (2, 10, 3), T = 50 (2, 25, 1), entry order."""
    if T == 1:
        return 1, K5_LANES, K5_LANES
    V = 2 if T % 2 == 0 else 1
    G = min(32, -(-T // V))
    return V, G, 32 // G


def emulate(data, indices, indptr, raw, *, square=False):
    """The kernel's result computed in torch in its order: for each column
    and task, slot e (0 <= e < E of ``lane_plan``) sums the products of
    entries indptr[j] + e, + e + E, ... in entry order from 0.0, and the E
    slot sums are added in slot order, or, at T = 1 (the slots are a
    column's lanes), by the shuffle-down tree E / 2, ..., 2, 1. raw is [n]
    (out [p]) or [n, T] (out [p, T])."""
    dev = data.device
    p = indptr.numel() - 1
    r2 = raw.reshape(raw.shape[0], -1)
    T = r2.shape[1]
    E = lane_plan(T)[2]
    ip = indptr.to("cpu", torch.int64)
    nnz = int(ip[-1])
    x = data[:nnz, None]
    g = r2[indices[:nnz].long()]
    prod = ((x * x) * g if square else x * g).double()
    k = torch.arange(nnz)
    col = torch.searchsorted(ip, k, side="right") - 1
    rel = k - ip[col]
    slot, level = (rel % E).to(dev), rel // E
    col = col.to(dev)
    part = torch.zeros(p, E, T, dtype=torch.float64, device=dev)
    for q in torch.unique(level).tolist():
        sel = (level == q).to(dev)
        part[col[sel], slot[sel]] = part[col[sel], slot[sel]] + prod[sel]
    if T == 1:
        o = E // 2
        while o:
            part[:, :o] = part[:, :o] + part[:, o:2 * o]
            o //= 2
        tot = part[:, 0]
    else:
        tot = part[:, 0]
        for e in range(1, E):
            tot = tot + part[:, e]
    return tot.to(data.dtype).reshape((p,) + tuple(raw.shape[1:]))


def csc_score_plain(data, indices, col_ids, indptr, v, *, square=False):
    # imported here: repro_torch.sparse imports the kernel wrappers
    from ..sparse import ops as sops
    p = indptr.shape[0] - 1
    if square:
        return sops.csc_weighted_col_sq(data, indices, col_ids, v, p)
    return sops.csc_score(data, indices, col_ids, v, p)


def _stream(t):
    return torch.cuda.current_stream(t.device).cuda_stream


def csc_walk_cuda(data, indices, indptr, raw, *, square=False):
    """Launch the kernel on the tensors' stream; raw is contiguous [n] or
    [n, T] (at an even T, on a 16-byte boundary). Returns [p] or [p, T]."""
    fn = getattr(BUILD.lib("csc_score"), f"csc_walk_{_suffix(data)}")
    p = indptr.shape[0] - 1
    T = 1 if raw.ndim == 1 else raw.shape[1]
    V, G, _ = lane_plan(T)
    if V == 2 and raw.data_ptr() % 16:
        raise ValueError("csc_score: at an even T raw must start on a "
                         "16-byte boundary (its rows are read 16 bytes at "
                         "a time)")
    out = torch.empty((p,) + tuple(raw.shape[1:]), dtype=data.dtype,
                      device=data.device)
    with torch.cuda.device(data.device):
        rc = fn(data.data_ptr(), indices.data_ptr(), indptr.data_ptr(),
                raw.data_ptr(), out.data_ptr(), p, T, int(bool(square)), V, G,
                _stream(data))
    _check_rc(rc, "csc_score")
    return out


def csc_score_cuda(data, indices, col_ids, indptr, v, *, square=False):
    """Launch K5 (or K5s) on the tensors' stream; v is contiguous [n]."""
    del col_ids                      # the kernel walks indptr's segments
    return csc_walk_cuda(data, indices, indptr, v, square=square)


def csc_score_block_cuda(data, indices, col_ids, indptr, raw):
    """Launch K5b on the tensors' stream; raw is contiguous [n, T]."""
    del col_ids                      # the kernel walks indptr's segments
    return csc_walk_cuda(data, indices, indptr, raw)


def l2_gather_probe_cuda(buf, gathers, blocks=132 * 8):
    """Enqueue `gathers` reads of rows of `buf` [rows, width] (float64,
    width 1 or 20) at hashed row indices: the floor of the gathers of raw
    through L2 that the walk makes (counted in no launch count)."""
    lib = BUILD.lib("csc_score")
    rows, width = buf.shape
    out = torch.empty(1, dtype=torch.float64, device=buf.device)
    with torch.cuda.device(buf.device):
        rc = lib.l2_gather_probe(buf.data_ptr(), rows, width, gathers, blocks,
                                 out.data_ptr(), _stream(buf))
    _check_rc(rc, "l2_gather_probe")
