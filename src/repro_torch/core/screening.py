"""Gap-safe screening for the Lasso (Ndiaye et al. 2017; port of
``repro.core.screening``), in plain torch on the design protocol.

Lasso form: P(b) = ||y - X b||^2 / (2n) + lam ||b||_1.
Dual-feasible point: theta = (y - X b) / (lam n), rescaled into the dual box.
Gap-safe sphere: radius r = sqrt(2 gap / n) / lam around theta; feature j is
certifiably zero at the optimum if |x_j^T theta| + r ||x_j|| < 1.

The rule reads the design through ``matvec``, ``score`` and
``col_sq_norms`` only, so a CSC design is never densified; on the kernel
route its score pass is K5. Everything stays on the design's device: the
mask is a bool tensor, read by no one here.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from .engine import DenseDesign

__all__ = ["lasso_gap_safe_mask", "gap_safe_mask_design",
           "screened_fraction"]


def lasso_gap_safe_mask(X, y, beta, lam, device=None):
    """Boolean mask: True = feature *survives* (may be nonzero at optimum).

    Safe: any feature marked False is provably zero in every Lasso solution
    at this lambda. Dense [n, p] array or tensor entry point of
    ``gap_safe_mask_design``, on `device` (``None`` means ``"cuda"`` and
    raises without a card)."""
    design = DenseDesign.from_dense(X, resolve_device(device))
    return gap_safe_mask_design(design, y, beta, lam)


def gap_safe_mask_design(design, y, beta, lam, *, use_kernels=False,
                         col_sq=None):
    """The gap-safe survivor mask (Lasso form) on a dense or CSC design, on
    its device. ``use_kernels`` runs a CSC design's score pass as K5;
    `col_sq`, the design's ``col_sq_norms()``, may be passed by a caller
    that screens many lambdas."""
    y = torch.as_tensor(y, dtype=design.dtype, device=design.device)
    beta = torch.as_tensor(beta, dtype=design.dtype, device=design.device)
    n = y.shape[0]
    resid = y - design.matvec(beta)
    theta = resid / (lam * n)
    corr = design.score(theta, use_kernels=use_kernels)
    scale = torch.clamp(1.0 / torch.clamp(torch.max(torch.abs(corr)),
                                          min=1e-30), max=1.0)
    theta = theta * scale
    corr = corr * scale
    primal = torch.sum(resid ** 2) / (2 * n) + lam * torch.sum(torch.abs(beta))
    dual = (lam * torch.dot(y, theta)
            - 0.5 * lam ** 2 * n * torch.sum(theta ** 2))
    gap = torch.clamp(primal - dual, min=0.0)
    r = torch.sqrt(2.0 * gap / n) / lam
    if col_sq is None:
        col_sq = design.col_sq_norms()
    return torch.abs(corr) + r * torch.sqrt(col_sq) >= 1.0


def screened_fraction(mask) -> float:
    """The fraction of features a mask screens out (one host read)."""
    return float(1.0 - torch.mean(mask.to(torch.float32)))
