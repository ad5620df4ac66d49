"""Public, checked wrappers of the kernels K1-K3, with launch counters.

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: on the CPU it runs the kernel's plain torch version;
on a CUDA device it launches the CUDA kernel (built at first use) and adds
one to its ``launches`` count, or raises. There is no fallback from the
kernel to the plain version. ``launches`` is a plain int on the wrapper;
``reset_launch_counts`` and ``launch_counts`` cover all three.
"""
from __future__ import annotations

import torch

from .cd_epoch import (KIND_IDS, cd_epoch_gram_cuda, cd_epoch_gram_plain,
                       cd_epoch_xb_cuda, cd_epoch_xb_plain)
from .common import (UnsupportedPenaltyError, check_kernel_penalty,
                     check_score_kernel_penalty, make_penalty, penalty_params)
from .fused_ws import fused_ws_cuda, fused_ws_plain

__all__ = ["cd_epoch_gram", "cd_epoch_xb", "fused_ws", "KERNELS",
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


KERNELS = (cd_epoch_gram, cd_epoch_xb, fused_ws)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


reset_launch_counts()
