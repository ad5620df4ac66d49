"""Anderson extrapolation (paper Algorithm 4; port of
``repro.core.anderson``).

Given the last M+1 iterates beta^(0..M), form U = [beta^(i+1) - beta^(i)]_i,
solve (U U^T + reg I) z = 1_M, c = z / sum(z), and return
sum_i c_i beta^(i+1). The caller guards acceptance with an
objective-decrease test. No host read: a failed or non-finite solve falls
back to the last iterate on the device (``solve_ex`` reports instead of
raising).
"""
from __future__ import annotations

import torch

__all__ = ["anderson_extrapolate"]


def anderson_extrapolate(hist):
    """hist: [M+1, ...] iterate ring (oldest first). Returns the
    extrapolated point."""
    M = hist.shape[0] - 1
    flat = hist.reshape(M + 1, -1)
    U = flat[1:] - flat[:-1]                          # [M, K]
    UUt = U @ U.T                                     # [M, M]
    scale = torch.trace(UUt) / M
    reg = 1e-10 * torch.clamp(scale, min=1e-30)
    eye = torch.eye(M, dtype=flat.dtype, device=flat.device)
    ones = torch.ones((M, 1), dtype=flat.dtype, device=flat.device)
    z, info = torch.linalg.solve_ex(UUt + reg * eye, ones)
    z = z[:, 0]
    denom = torch.sum(z)
    c = z / torch.where(torch.abs(denom) > 1e-30, denom, 1.0)
    extr = c @ flat[1:]
    ok = torch.all(torch.isfinite(extr)) & (torch.abs(denom) > 1e-30) & \
        (info == 0)
    out = torch.where(ok, extr, flat[-1])
    return out.reshape(hist.shape[1:])
