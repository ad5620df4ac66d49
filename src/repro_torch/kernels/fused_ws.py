"""K3 and K3b: the fused working-set head (``csrc/fused_ws.cu``, a score
launch and a select+copy launch), its CUDA launchers and its plain torch
version.

K3 replaces ``repro/kernels/fused_ws.py:fused_ws_pallas`` (scalar form): one
pass over feature tiles of the feature-major design Xt [p, n] yields the
violation scores, the offset-corrected gradient, each tile's top-``kc``
candidates (``kc = min(bp, ws_size)``) under the ``lax.top_k`` order with
the generalized support pinned to +inf, and exact copies of the candidate
columns. The final working set is ``select_working_set`` on the emitted
scores, and ``candidate_columns`` recovers ``X[:, ws]`` from the buffer.
Exhausted slots emit index p with a zero column.

K3b replaces the block branch of the same kernel (multitask coefficients
beta [p, T], raw gradient R [n, T], a block penalty): the gradient is
[p, T] and each feature's score is its row score (``subdiff_dist`` of the
block penalty, or the row norm of the fixed-point difference). In float64
its product runs on the tensor cores (DMMA), and its select launch emits
``cand_idx`` without copying candidate rows: the wrapper
(``kernels/ops.py``) picks the working set from the scores and gathers
those K rows of Xt, so no [tiles * kc, n] buffer exists on its path. The
plain version below covers both forms and keeps the four outputs
(``cand_cols`` included): it is the oracle both heads are held to.
"""
from __future__ import annotations

import torch

from ..core.working_set import priorities, violation_scores
from ._build import BUILD
from .cd_epoch import _check_rc, _suffix, kernel_params
from .common import make_penalty

__all__ = ["pick_bp", "fused_ws_plain", "fused_ws_cuda",
           "fused_ws_block_cuda", "MMA_TASKS"]

# tasks a pass of K3b's float64 product launch (csrc/fused_ws.cu: kMmaT)
MMA_TASKS = 24


def pick_bp(p: int, cap: int = 1024) -> int:
    """Feature-tile width: the whole axis when it fits, else the largest
    divisor of p in (cap/2, cap] (no ragged tile), else `cap`."""
    if p <= cap:
        return p
    for b in range(cap, cap // 2, -1):
        if p % b == 0:
            return b
    return cap


def _tiling(p, ws_size, bp):
    bp = pick_bp(p) if bp is None else min(bp, p)
    return bp, -(-p // bp), min(bp, ws_size)


def fused_ws_plain(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                   ws_size, *, use_fp=False, bp=None):
    p, n = Xt.shape
    bp, tiles, kc = _tiling(p, ws_size, bp)
    grad = Xt @ r
    grad = grad + (offset[:, None] if grad.ndim == 2 else offset)
    scores = violation_scores(make_penalty(penalty_cls, params), beta, grad,
                              L, use_fixed_point=use_fp)
    pri = torch.full((tiles * bp,), -torch.inf, dtype=Xt.dtype,
                     device=Xt.device)
    pri[:p] = priorities(scores, gsupp)
    order = torch.sort(pri.view(tiles, bp), dim=1, descending=True,
                       stable=True).indices[:, :kc]
    gidx = (order + bp * torch.arange(tiles, device=Xt.device)[:, None])
    gidx = gidx.reshape(-1)
    valid = gidx < p
    cand_idx = torch.where(valid, gidx, p).to(torch.int32)
    cand_cols = torch.where(valid[:, None], Xt[torch.clamp(gidx, max=p - 1)],
                            0.0)
    return scores, grad, cand_idx, cand_cols


def fused_ws_cuda(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                  ws_size, *, use_fp=False, bp=None):
    """Launch K3 on the tensors' stream; Xt is contiguous [p, n]."""
    fn = getattr(BUILD.lib("fused_ws"), f"fused_ws_{_suffix(Xt)}")
    p, n = Xt.shape
    bp, tiles, kc = _tiling(p, ws_size, bp)
    pid, p0, p1 = kernel_params(penalty_cls, params)
    # pri: the selection priorities, scratch between the two launches
    scores, grad, pri = (torch.empty_like(beta) for _ in range(3))
    cand_idx = torch.empty(tiles * kc, dtype=torch.int32, device=Xt.device)
    cand_cols = torch.empty((tiles * kc, n), dtype=Xt.dtype, device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = fn(Xt.data_ptr(), r.data_ptr(), beta.data_ptr(), L.data_ptr(),
                offset.data_ptr(), gsupp.data_ptr(), scores.data_ptr(),
                grad.data_ptr(), pri.data_ptr(), cand_idx.data_ptr(),
                cand_cols.data_ptr(),
                n, p, bp, kc, pid, int(bool(use_fp)), p0, p1, stream)
    _check_rc(rc, "fused_ws")
    return scores, grad, cand_idx, cand_cols


_SPLITS: dict = {}


def _mma_splits(Xt):
    """The sample spans of K3b's float64 product launch at Xt's shape on
    its card (csrc/fused_ws.cu: mma_splits), cached."""
    p, n = Xt.shape
    key = (Xt.device, n, p)
    if key not in _SPLITS:
        with torch.cuda.device(Xt.device):
            splits = BUILD.lib("fused_ws").fused_ws_block_splits(n, p)
        if splits < 1:
            raise RuntimeError("fused_ws_block: the card did not report its "
                               "occupancy")
        _SPLITS[key] = splits
    return _SPLITS[key]


def fused_ws_block_cuda(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                        ws_size, *, use_fp=False, bp=None):
    """Launch K3b on the tensors' stream; Xt is contiguous [p, n], R and
    beta are contiguous [n, T] and [p, T]. Returns (scores, grad,
    cand_idx): no candidate rows are copied."""
    fn = getattr(BUILD.lib("fused_ws"), f"fused_ws_block_{_suffix(Xt)}")
    p, n = Xt.shape
    T = R.shape[1]
    bp, tiles, kc = _tiling(p, ws_size, bp)
    pid, p0, p1 = kernel_params(penalty_cls, params)
    scores, pri = torch.empty_like(L), torch.empty_like(L)
    grad = torch.empty_like(beta)
    cand_idx = torch.empty(tiles * kc, dtype=torch.int32, device=Xt.device)
    # float64: the partial products of the sample spans [S, p, 24]
    splits = _mma_splits(Xt) if Xt.dtype == torch.float64 else 1
    part = torch.empty(splits * p * MMA_TASKS if Xt.dtype == torch.float64
                       else 1, dtype=Xt.dtype, device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = fn(Xt.data_ptr(), R.data_ptr(), beta.data_ptr(), L.data_ptr(),
                offset.data_ptr(), gsupp.data_ptr(), scores.data_ptr(),
                grad.data_ptr(), pri.data_ptr(), cand_idx.data_ptr(),
                part.data_ptr(), splits, n, p, T, bp, kc, pid,
                int(bool(use_fp)), p0, p1, stream)
    _check_rc(rc, "fused_ws_block")
    return scores, grad, cand_idx
