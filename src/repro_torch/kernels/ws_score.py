"""K4: the two-pass score head (a second entry of ``csrc/fused_ws.cu``,
sharing K3's score launch), its CUDA launcher and its plain torch version.

Replaces ``repro/kernels/ws_score.py:ws_score_pallas``: for the
feature-major design Xt [p, n], ``grad = Xt @ (r * w) + offset`` (``w``
optional) and the violation score of every feature, the subdifferential
distance or the fixed-point score ``|beta - prox(beta - grad/L, 1/L)|``.
Returns the scores [p]. The reference's divisibility asserts belong to its
tiling and are not kept. The public, checked and counted wrapper is
``kernels/ops.py:ws_score``.
"""
from __future__ import annotations

import torch

from ..core.working_set import violation_scores
from ._build import BUILD
from .cd_epoch import _check_rc, _suffix, kernel_params
from .common import make_penalty

__all__ = ["ws_score_plain", "ws_score_cuda"]


def ws_score_plain(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
                   use_fp=False):
    grad = Xt @ (r if w is None else r * w) + offset
    return violation_scores(make_penalty(penalty_cls, params), beta, grad,
                            L, use_fixed_point=use_fp)


def ws_score_cuda(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
                  use_fp=False):
    """Launch K4 on the tensors' stream; Xt is contiguous [p, n]."""
    fn = getattr(BUILD.lib("fused_ws"), f"ws_score_{_suffix(Xt)}")
    p, n = Xt.shape
    pid, p0, p1 = kernel_params(penalty_cls, params)
    scores = torch.empty_like(beta)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = fn(Xt.data_ptr(), r.data_ptr(),
                None if w is None else w.data_ptr(), beta.data_ptr(),
                L.data_ptr(), offset.data_ptr(), scores.data_ptr(), n, p, pid,
                int(bool(use_fp)), p0, p1, stream)
    _check_rc(rc, "ws_score")
    return scores
