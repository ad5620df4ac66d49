"""K1, K1b and K2: the CD-epoch kernels (``csrc/cd_epoch.cu``), their CUDA
launchers and their plain torch versions.

K1 (``cd_epoch_gram``) replaces ``repro/kernels/cd_epoch.py:
cd_epoch_gram_pallas``; K2 (``cd_epoch_xb``) replaces
``cd_epoch_xb_pallas``. K1b (``cd_epoch_gram_block``) is the block form of
K1 for multitask coefficients beta [K, T] with a block penalty; the TPU has
no kernel for it (the reference runs its jax epoch
``repro/core/cd.py:cd_epoch_gram`` there). The plain versions run the same
epochs through ``kernels/ref.py`` (``cd_epoch_gram_plain`` covers both
forms) and are what the CPU takes; the public, checked and counted
wrappers are in ``kernels/ops.py``.
"""
from __future__ import annotations

import torch

from ..core.datafits import Logistic, Quadratic, QuadraticSVC
from ._build import BUILD
from .common import PENALTY_IDS, make_penalty
from .ref import cd_epoch_gram_ref, cd_epoch_xb_ref

__all__ = ["KIND_IDS", "cd_epoch_gram_plain", "cd_epoch_xb_plain",
           "cd_epoch_gram_cuda", "cd_epoch_gram_block_cuda",
           "cd_epoch_xb_cuda", "kernel_params"]

# datafit kind -> the raw-gradient formula id of csrc/cd_epoch.cu
KIND_IDS = {"quadratic": 0, "logistic": 1, "svc": 2}
_KIND_DATAFITS = {"quadratic": Quadratic(), "logistic": Logistic(),
                  "svc": QuadraticSVC()}


def kernel_params(penalty_cls, params):
    """(penalty id, p0, p1): the codec vector as the C launchers take it."""
    vals = [float(v) for v in params.tolist()] + [0.0, 0.0]
    return PENALTY_IDS[penalty_cls], vals[0], vals[1]


def _suffix(t):
    return {torch.float64: "f64", torch.float32: "f32"}[t.dtype]


def _check_rc(rc, name):
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}")


def cd_epoch_gram_plain(G, c, beta0, q0, L, penalty_cls, params, *,
                        epochs=1):
    return cd_epoch_gram_ref(G, c, beta0, q0, L,
                             make_penalty(penalty_cls, params), epochs)


def cd_epoch_xb_plain(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                      datafit_kind="quadratic", *, w=None, epochs=1):
    return cd_epoch_xb_ref(Xt_ws, y, beta0, Xb0, L, offset,
                           _KIND_DATAFITS[datafit_kind],
                           make_penalty(penalty_cls, params), epochs, w=w)


def cd_epoch_gram_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                       epochs=1):
    """Launch K1 on the tensors' stream; G may have any strides."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_{_suffix(G)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), G.shape[0], epochs, pid, p0,
                p1, stream)
    _check_rc(rc, "cd_epoch_gram")
    return beta, q


def cd_epoch_gram_block_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                             epochs=1):
    """Launch K1b on the tensors' stream; G may have any strides, c, beta0
    and q0 are contiguous [K, T]."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_block_{_suffix(G)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
    K, T = beta0.shape
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), K, T, epochs, pid, p0, p1,
                stream)
    _check_rc(rc, "cd_epoch_gram_block")
    return beta, q


def cd_epoch_xb_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                     datafit_kind="quadratic", *, w=None, epochs=1):
    """Launch K2 on the tensors' stream; Xt_ws is contiguous [K, n]."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_xb_{_suffix(Xt_ws)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
    K, n = Xt_ws.shape
    beta, Xb = torch.empty_like(beta0), torch.empty_like(Xb0)
    with torch.cuda.device(Xt_ws.device):
        stream = torch.cuda.current_stream(Xt_ws.device).cuda_stream
        rc = fn(Xt_ws.data_ptr(), y.data_ptr(),
                None if w is None else w.data_ptr(), L.data_ptr(),
                offset.data_ptr(), beta0.data_ptr(), Xb0.data_ptr(),
                beta.data_ptr(), Xb.data_ptr(), K, n, epochs,
                KIND_IDS[datafit_kind], pid, p0, p1, stream)
    _check_rc(rc, "cd_epoch_xb")
    return beta, Xb
