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

K5r (``csc_row_sum``) is the transpose walk, the CSC scatters of
``CSCDesign.matvec`` and ``CSCDesign.update_xb`` summed row by row in a
fixed order, the order ``index_add_`` adds in on the CPU: ``matvec`` a
row's entries by ascending column, ``update_xb`` the row's entries in the
working-set columns by ascending slot. It walks ``row_major``, a copy of
the design's entries sorted by row once a design (``row_order``: stably,
so a row keeps its entries' column order; zeros and padding left out):
``matvec`` a thread a row, or at T tasks a slice of every row of a
CTA's rows at a time (``matvec_plan``), the update a warp a row
(``UPDATE_PLAN``), keeping the entries whose column has a slot (a slot
map and its bitmap) and ordering each row's kept entries by slot by
counting, with no sort. Its plain version,
``csc_row_sum_plain``, is that ``index_add_`` over the copy.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ._build import BUILD
from .cd_epoch import _check_rc, _suffix

__all__ = ["csc_score_plain", "csc_score_cuda", "csc_score_block_cuda",
           "csc_walk_cuda", "l2_gather_probe_cuda", "lane_plan", "emulate",
           "row_order", "MatvecPlan", "matvec_plan", "UpdatePlan",
           "UPDATE_PLAN", "plan_ctas", "RowMajor", "row_major",
           "slot_bitmap", "slot_map_cuda", "csc_row_sum_plain",
           "csc_row_sum_cuda"]


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


def row_order(rows, n_rows, vals=None):
    """(order int32 [E], ptr int64 [n_rows + 1]) of the row ids `rows` [E]
    (int32): the entries sorted by row, stably (a row's entries keep their
    order), and where each row's run starts. With `vals`, entries whose
    value is 0.0 (the flat arrays' padding, the windows' tails) are sorted
    past the last row and left out of every run: they add a zero, so the
    sums keep their bits, and a design's padding (all on row 0) does not
    make one long run. On the tensors' device, with no host read (a
    captured step computes it)."""
    key = rows.reshape(-1)
    if vals is not None:
        key = torch.where(vals.reshape(-1) != 0, key, n_rows)
    srt, order = torch.sort(key, stable=True)
    bounds = torch.arange(n_rows + 1, dtype=srt.dtype, device=srt.device)
    return order.to(torch.int32), torch.searchsorted(srt, bounds)


# K5r: a row of more than K5R_LONG entries takes the long path
K5R_LONG = 1024
# K5r's matvec at T > 1: the entries of each row staged a slice at a time
K5R_SLICE = 64
# K5r's update: rows a CTA of 256 threads (a warp a row at a time) and
# the kept entries a warp's buffer holds
K5R_UPDATE_ROWS = 64
K5R_KMAX = 128


class MatvecPlan(NamedTuple):
    """K5r's ``matvec`` launch: CTA c takes rows [c R, (c + 1) R) (R =
    ``rows``, R T <= ``threads``: a thread a (row, task)); ``slice`` 0 at
    one task: a thread walks its row, else (T > 1) the CTA stages
    ``slice`` entries of each row at a time; a row of more than ``longer``
    entries takes the long path."""
    rows: int
    slice: int
    longer: int
    threads: int


def matvec_plan(T):
    """K5r's ``matvec`` plan for coef [P, T]: at one task a thread a row
    on 128 threads, no slice; else slices of ``K5R_SLICE`` on the fewest
    warps of at least 256 threads that hold T tasks (T = 20: 12 rows of
    20 on 256 threads)."""
    if T == 1:
        return MatvecPlan(128, 0, K5R_LONG, 128)
    threads = max(256, -(-T // 32) * 32)
    if T < 1 or threads > 512:
        raise ValueError(f"csc_row_sum: no matvec plan for T={T} tasks "
                         f"(1 to 512)")
    return MatvecPlan(threads // T, K5R_SLICE, K5R_LONG, threads)


class UpdatePlan(NamedTuple):
    """K5r's ``update_xb`` launch: CTA c takes rows [c R, (c + 1) R) (R =
    ``rows``), a warp a row at a time, with a buffer of ``kmax`` kept
    entries a warp; a row of more than ``longer`` entries, or with more
    than ``kmax`` kept, takes the CTA's long path."""
    rows: int
    kmax: int
    longer: int
    threads: int


# K5r's update: 64 rows a CTA of 8 warps, 128 kept entries a warp's buffer
UPDATE_PLAN = UpdatePlan(K5R_UPDATE_ROWS, K5R_KMAX, K5R_LONG, 256)


def plan_ctas(plan, ptr):
    """A plan (``matvec_plan`` or ``UPDATE_PLAN``) as K5r reads it: for
    each CTA, (its rows summed in the main loop, its long rows). Host
    reads: tests only."""
    ptr = ptr.tolist()
    out = []
    for r0 in range(0, len(ptr) - 1, plan.rows):
        mine = range(r0, min(r0 + plan.rows, len(ptr) - 1))
        long_rows = [r for r in mine if ptr[r + 1] - ptr[r] > plan.longer]
        out.append(([r for r in mine if r not in long_rows], long_rows))
    return out


class RowMajor(NamedTuple):
    """A design's entries sorted by row (``row_order``): vals and cols
    (int32) [capacity], the zeros and padding last, past ptr[-1]; ptr
    int64 [rows + 1]."""
    vals: torch.Tensor
    cols: torch.Tensor
    ptr: torch.Tensor


def row_major(data, indices, col_ids, n_rows, out=None):
    """The row-major copy of flat CSC arrays on their device: one stable
    sort, no host read. With `out` (a copy of the same capacity and rows),
    written into its tensors in place, so what reads them (a captured
    step) reads the new design."""
    order, ptr = row_order(indices, n_rows, data)
    order = order.long()
    if out is None:
        return RowMajor(data[order], col_ids[order], ptr)
    out.vals.copy_(data[order])
    out.cols.copy_(col_ids[order])
    out.ptr.copy_(ptr)
    return out


def slot_bitmap(slots):
    """The bitmap of a slot map (int32 [p]): int32 [ceil(p / 32)], bit j %
    32 of word j // 32 set where column j has a slot (slots[j] >= 0)."""
    p = slots.shape[0]
    on = torch.zeros(-(-p // 32) * 32, dtype=torch.int64, device=slots.device)
    on[:p] = (slots >= 0).long()
    words = torch.sum(on.view(-1, 32) << torch.arange(32, device=on.device),
                      dim=1)
    return torch.where(words >= 2**31, words - 2**32, words).to(torch.int32)


def slot_map_cuda(ws, p):
    """The update's slot map on the card: (int32 [p], slot_of[ws[k]] = k,
    else -1; its ``slot_bitmap``), by two memsets and a mark launch; ws
    contiguous int64 [K] of distinct features."""
    pos = torch.empty(p, dtype=torch.int32, device=ws.device)
    bits = torch.empty(-(-p // 32), dtype=torch.int32, device=ws.device)
    with torch.cuda.device(ws.device):
        rc = BUILD.lib("csc_score").csc_slot_map(
            ws.data_ptr(), pos.data_ptr(), bits.data_ptr(), p, ws.shape[0],
            _stream(ws))
    _check_rc(rc, "slot_map")
    return pos, bits


def _slot_ranks(row, slot, rows):
    """The permutation that puts kept entries (rows ascending, as in the
    copy) in (row, slot) order, as K5r ranks them: each entry counts its
    row's entries with a smaller slot. No sort; Σ (kept a row)² pairs."""
    M = row.shape[0]
    dev = row.device
    cnt = torch.bincount(row, minlength=rows)
    start = torch.cumsum(cnt, 0) - cnt
    k = cnt[row]
    rep = torch.repeat_interleave(torch.arange(M, device=dev), k)
    off = torch.arange(rep.shape[0], device=dev) - \
        torch.repeat_interleave(torch.cumsum(k, 0) - k, k)
    partner = start[row][rep] + off
    rank = torch.zeros(M, dtype=torch.int64, device=dev).index_add_(
        0, rep, (slot[partner] < slot[rep]).long())
    perm = torch.empty(M, dtype=torch.int64, device=dev)
    perm[start[row] + rank] = torch.arange(M, device=dev)
    return perm


def _keys_of(order, keys, kdiv):
    x = order.long()
    return x, (keys[x].long() if keys is not None else x // kdiv)


def csc_row_sum_plain(val, order, keys, ptr, coef, *, kdiv=0, base=None,
                      slots=None):
    """K5r's plain version: ``base + out`` where out[i] sums val[x] *
    coef[key(x)] over row i's entries x by ``index_add_`` in their order:
    on the CPU, bit for bit the kernel's result. With `order` None, val and
    keys are a row-major copy (``row_major``: its vals and cols, rows
    bounded by ptr) and key(x) = keys[x] (``matvec``) or, with `slots` (a
    map of columns to slots, -1: none), slots[keys[x]], the entries without
    a slot left out and each row's entries taken by ascending slot
    (``update_xb``; ranked by counting, no sort). With `order` (``row_order``
    over any flat arrays), row i's entries are its run of order and key(x)
    = keys[x], or x // kdiv without keys. coef [P] or [P, T]; base None or
    the output's shape [rows] / [rows, T]."""
    rows = ptr.shape[0] - 1
    E = int(ptr[-1])
    rid = torch.repeat_interleave(
        torch.arange(rows, device=ptr.device), ptr[1:] - ptr[:-1])
    if order is not None:
        x, k = _keys_of(order[:E], keys, kdiv)
        v = val[x]
    else:
        v, k = val[:E], keys[:E].long()
        if slots is not None:
            s = slots[k]
            keep = s >= 0
            rid, s, v = rid[keep], s[keep].long(), v[keep]
            perm = _slot_ranks(rid, s, rows)
            rid, k, v = rid[perm], s[perm], v[perm]
    g = coef[k]
    contrib = v * g if g.ndim == 1 else v[:, None] * g
    out = torch.zeros((rows,) + tuple(coef.shape[1:]), dtype=val.dtype,
                      device=val.device).index_add_(0, rid, contrib)
    return out if base is None else base + out


def csc_row_sum_cuda(val, cols, ptr, coef, plan=None, *, base=None,
                     slots=None, bits=None):
    """Launch K5r on the tensors' stream over a row-major copy (val, cols,
    ptr): ``matvec`` (coef contiguous [P] or [P, T]; `plan` a
    ``MatvecPlan``, by default ``matvec_plan(T)``) or, with `slots` and
    `bits` (int32 [P'] and [ceil(P' / 32)], the update's slot map and its
    bitmap), ``update_xb`` (coef the delta [K] or [K, T]; `plan` an
    ``UpdatePlan``, by default ``UPDATE_PLAN``); base None or contiguous
    as the output. Returns [rows] or [rows, T]. Another `plan` is for
    tests and ``cd_sweep.py k5r``'s layouts: the main path takes the
    defaults."""
    lib = BUILD.lib("csc_score")
    rows = ptr.shape[0] - 1
    T = 1 if coef.ndim == 1 else coef.shape[1]
    out = torch.empty((rows,) + tuple(coef.shape[1:]), dtype=val.dtype,
                      device=val.device)
    args = (val.data_ptr(), cols.data_ptr(), ptr.data_ptr())
    tail = (None if base is None else base.data_ptr(), out.data_ptr())
    with torch.cuda.device(val.device):
        if slots is None:
            plan = plan or matvec_plan(T)
            rc = getattr(lib, f"csc_row_matvec_{_suffix(val)}")(
                *args, coef.data_ptr(), *tail, rows, plan.rows, plan.slice,
                plan.longer, plan.threads, T, _stream(val))
        else:
            plan = plan or UPDATE_PLAN
            rc = getattr(lib, f"csc_row_update_{_suffix(val)}")(
                *args, slots.data_ptr(), bits.data_ptr(), coef.data_ptr(),
                *tail, rows, plan.rows, plan.kmax, plan.longer, plan.threads,
                T, coef.shape[0], _stream(val))
    _check_rc(rc, "csc_row_sum")
    return out
