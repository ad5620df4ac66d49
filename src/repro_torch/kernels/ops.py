"""Public, checked wrappers of the kernels K1-K5, with launch counters.

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: on the CPU it runs the kernel's plain torch version;
on a CUDA device it launches the CUDA kernel (built at first use) and adds
one to its ``launches`` count, or raises. There is no fallback from the
kernel to the plain version. ``launches`` is a plain int on the wrapper;
``reset_launch_counts`` and ``launch_counts`` cover all of them:

  cd_epoch_gram        K1, CD epochs on the Gram subproblem
  cd_epoch_xb          K2, CD epochs on the Xb state
  fused_ws             K3, the fused working-set head (dense designs)
  ws_score             K4, the two-pass score head (dense designs)
  csc_score            K5, the sparse score pass X.T @ raw (CSC designs)
  csc_weighted_col_sq  K5s, K5 in square mode: sum_i w_i x_ij^2
"""
from __future__ import annotations

import torch

from .cd_epoch import (KIND_IDS, cd_epoch_gram_cuda, cd_epoch_gram_plain,
                       cd_epoch_xb_cuda, cd_epoch_xb_plain)
from .common import (UnsupportedPenaltyError, check_kernel_penalty,
                     check_score_kernel_penalty, make_penalty, penalty_params)
from .csc_score import csc_score_cuda, csc_score_plain
from .fused_ws import fused_ws_cuda, fused_ws_plain
from .ws_score import ws_score_cuda, ws_score_plain

__all__ = ["cd_epoch_gram", "cd_epoch_xb", "fused_ws", "ws_score",
           "csc_score", "csc_weighted_col_sq", "KERNELS",
           "launch_counts", "reset_launch_counts", "penalty_params",
           "make_penalty", "check_kernel_penalty",
           "check_score_kernel_penalty", "UnsupportedPenaltyError"]


def _route(name, **tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on anything else
    (mixed devices, dtypes, or a device type without a kernel route)."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no route for device {dev}")
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: tensors must share one dtype, float32 or "
                        f"float64; got {[str(t.dtype) for t in tensors.values()]}")
    return dev.type == "cuda"


def _check_vec(name, n, **vecs):
    for key, v in vecs.items():
        if v.ndim != 1 or v.shape[0] != n or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous [{n}] "
                             f"vector, got shape {tuple(v.shape)}")


def cd_epoch_gram(G, c, beta0, q0, L, penalty_cls, params, *, epochs=1):
    """K1: `epochs` cyclic CD epochs on the Gram subproblem. G: [K, K] (any
    strides; column-major makes the kernel's column reads contiguous);
    c, beta0, q0, L: [K]. Returns (beta, q)."""
    check_kernel_penalty(penalty_cls)
    on_card = _route("cd_epoch_gram", G=G, c=c, beta0=beta0, q0=q0, L=L)
    K = G.shape[0]
    if G.ndim != 2 or G.shape[1] != K:
        raise ValueError(f"cd_epoch_gram: G must be [K, K], got {tuple(G.shape)}")
    _check_vec("cd_epoch_gram", K, c=c, beta0=beta0, q0=q0, L=L)
    if not on_card:
        return cd_epoch_gram_plain(G, c, beta0, q0, L, penalty_cls, params,
                                   epochs=epochs)
    out = cd_epoch_gram_cuda(G, c, beta0, q0, L, penalty_cls, params,
                             epochs=epochs)
    cd_epoch_gram.launches += 1
    return out


def cd_epoch_xb(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                datafit_kind="quadratic", *, w=None, epochs=1):
    """K2: `epochs` CD epochs maintaining Xb. Xt_ws: contiguous [K, n];
    y, Xb0 (and w): [n]; beta0, L, offset: [K]. Returns (beta, Xb)."""
    check_kernel_penalty(penalty_cls)
    if datafit_kind not in KIND_IDS:
        raise ValueError(f"cd_epoch_xb: unknown datafit kind {datafit_kind!r}")
    if datafit_kind == "svc" and w is not None:
        raise ValueError("QuadraticSVC does not support sample weights")
    extra = {} if w is None else {"w": w}
    on_card = _route("cd_epoch_xb", Xt_ws=Xt_ws, y=y, beta0=beta0, Xb0=Xb0,
                     L=L, offset=offset, **extra)
    if Xt_ws.ndim != 2 or not Xt_ws.is_contiguous():
        raise ValueError("cd_epoch_xb: Xt_ws must be a contiguous [K, n] "
                         f"matrix, got shape {tuple(Xt_ws.shape)}")
    K, n = Xt_ws.shape
    _check_vec("cd_epoch_xb", n, y=y, Xb0=Xb0, **extra)
    _check_vec("cd_epoch_xb", K, beta0=beta0, L=L, offset=offset)
    if not on_card:
        return cd_epoch_xb_plain(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                                 params, datafit_kind, w=w, epochs=epochs)
    out = cd_epoch_xb_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                           params, datafit_kind, w=w, epochs=epochs)
    cd_epoch_xb.launches += 1
    return out


def fused_ws(Xt, r, beta, L, offset, gsupp, penalty_cls, params, ws_size, *,
             use_fp=False, bp=None):
    """K3: fused score + per-tile top-kc + candidate-column copy in one pass
    over the feature-major design Xt [p, n] (contiguous). r: [n]; beta, L,
    offset: [p]; gsupp: bool [p]. Returns ``(scores [p], grad [p],
    cand_idx [C] int32, cand_cols [C, n])``."""
    check_kernel_penalty(penalty_cls)          # scalar form only in this port
    on_card = _route("fused_ws", Xt=Xt, r=r, beta=beta, L=L, offset=offset)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("fused_ws: Xt must be a contiguous [p, n] matrix, "
                         f"got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    _check_vec("fused_ws", n, r=r)
    _check_vec("fused_ws", p, beta=beta, L=L, offset=offset, gsupp=gsupp)
    if gsupp.dtype != torch.bool or gsupp.device != Xt.device:
        raise TypeError("fused_ws: gsupp must be a bool mask on Xt's device")
    if not 1 <= ws_size <= p:
        raise ValueError(f"fused_ws: ws_size must be in [1, {p}], got {ws_size}")
    if not on_card:
        return fused_ws_plain(Xt, r, beta, L, offset, gsupp, penalty_cls,
                              params, ws_size, use_fp=use_fp, bp=bp)
    out = fused_ws_cuda(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                        ws_size, use_fp=use_fp, bp=bp)
    fused_ws.launches += 1
    return out


def ws_score(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
             use_fp=False):
    """K4: violation scores of every feature from ``Xt @ (r * w) +
    offset`` over the feature-major design Xt [p, n] (contiguous). r (and
    w): [n]; beta, L, offset: [p]. Returns the scores [p]."""
    check_kernel_penalty(penalty_cls)
    extra = {} if w is None else {"w": w}
    on_card = _route("ws_score", Xt=Xt, r=r, beta=beta, L=L, offset=offset,
                     **extra)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("ws_score: Xt must be a contiguous [p, n] matrix, "
                         f"got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    _check_vec("ws_score", n, r=r, **extra)
    _check_vec("ws_score", p, beta=beta, L=L, offset=offset)
    if not on_card:
        return ws_score_plain(Xt, r, beta, L, offset, penalty_cls, params,
                              w=w, use_fp=use_fp)
    out = ws_score_cuda(Xt, r, beta, L, offset, penalty_cls, params, w=w,
                        use_fp=use_fp)
    ws_score.launches += 1
    return out


def _check_csc(name, data, indices, col_ids, indptr, v):
    """Check a CSC kernel call's arrays; True when it goes to the card."""
    on_card = _route(name, data=data, v=v)
    for key, t, dtype in (("indices", indices, torch.int32),
                          ("col_ids", col_ids, torch.int32),
                          ("indptr", indptr, torch.int64)):
        if t.dtype != dtype or t.device != data.device or t.ndim != 1 \
                or not t.is_contiguous():
            raise TypeError(f"{name}: {key} must be a contiguous 1-D "
                            f"{dtype} tensor on {data.device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if data.ndim != 1 or not data.is_contiguous():
        raise ValueError(f"{name}: data must be a contiguous 1-D vector")
    if indices.shape != data.shape or col_ids.shape != data.shape:
        raise ValueError(f"{name}: data, indices and col_ids must have one "
                         f"length, got {data.shape[0]}, {indices.shape[0]},"
                         f" {col_ids.shape[0]}")
    if indptr.shape[0] < 1:
        raise ValueError(f"{name}: indptr must hold p + 1 entries")
    if v.ndim != 1 or not v.is_contiguous():
        raise ValueError(f"{name}: the [n] vector must be contiguous 1-D, "
                         f"got shape {tuple(v.shape)}")
    return on_card


def csc_score(data, indices, col_ids, indptr, raw):
    """K5: ``X.T @ raw`` -> [p] over the window-padded CSC arrays of a
    ``CSCDesign`` (data, int32 indices and col_ids, int64 indptr [p + 1]);
    raw: [n]."""
    on_card = _check_csc("csc_score", data, indices, col_ids, indptr, raw)
    if not on_card:
        return csc_score_plain(data, indices, col_ids, indptr, raw)
    out = csc_score_cuda(data, indices, col_ids, indptr, raw)
    csc_score.launches += 1
    return out


def csc_weighted_col_sq(data, indices, col_ids, indptr, w):
    """K5s: ``sum_i w_i x_ij^2`` -> [p] over the same CSC arrays; w: [n]."""
    on_card = _check_csc("csc_weighted_col_sq", data, indices, col_ids,
                         indptr, w)
    if not on_card:
        return csc_score_plain(data, indices, col_ids, indptr, w,
                               square=True)
    out = csc_score_cuda(data, indices, col_ids, indptr, w, square=True)
    csc_weighted_col_sq.launches += 1
    return out


KERNELS = (cd_epoch_gram, cd_epoch_xb, fused_ws, ws_score, csc_score,
           csc_weighted_col_sq)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
