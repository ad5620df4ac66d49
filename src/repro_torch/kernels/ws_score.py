"""K4: the two-pass score head, its plain torch version. On the card it is
K3's score launch (``fused_ws.score_cuda`` in ``csrc/fused_ws.cu``) with
the weights and the scores alone.

Replaces ``repro/kernels/ws_score.py:ws_score_pallas``: for the
feature-major design Xt [p, n], ``grad = Xt @ (r * w) + offset`` (``w``
optional) and the violation score of every feature, the subdifferential
distance or the fixed-point score ``|beta - prox(beta - grad/L, 1/L)|``.
Returns the scores [p]. The reference's divisibility asserts belong to its
tiling and are not kept. The public, checked and counted wrapper is
``kernels/ops.py:ws_score``.
"""
from __future__ import annotations

from ..core.working_set import violation_scores
from .common import make_penalty

__all__ = ["ws_score_plain"]


def ws_score_plain(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
                   use_fp=False):
    grad = Xt @ (r if w is None else r * w) + offset
    return violation_scores(make_penalty(penalty_cls, params), beta, grad,
                            L, use_fixed_point=use_fp)
