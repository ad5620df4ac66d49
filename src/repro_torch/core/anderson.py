"""Anderson extrapolation (paper Algorithm 4; port of
``repro.core.anderson``).

Given the last M+1 iterates beta^(0..M), form U = [beta^(i+1) - beta^(i)]_i,
solve (U U^T + reg I) z = 1_M, c = z / sum(z), and return
sum_i c_i beta^(i+1). The caller guards acceptance with an
objective-decrease test. No host read: a failed or non-finite solve falls
back to the last iterate on the device (``solve_ex`` reports instead of
raising).

``anderson_extrapolate_lanes`` is the same extrapolation on the iterates of
S lanes at once (``[S, M+1, K]``, or ``[S, M+1, K, T]`` for multitask
lanes, flattened to ``[S, M+1, K*T]`` as the reference flattens a block
history; the chunked driver's lane step): one batched solve, and each lane
falls back to its own last iterate where its solve fails.
"""
from __future__ import annotations

import torch

__all__ = ["anderson_extrapolate", "anderson_extrapolate_lanes"]


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


def anderson_extrapolate_lanes(hist):
    """hist: [S, M+1, K] (or [S, M+1, K, T]) iterate rings of S lanes
    (oldest first). Returns the [S, K] (or [S, K, T]) extrapolated points,
    each lane's decided on its own."""
    shape = hist.shape
    S, M = shape[0], shape[1] - 1
    hist = hist.reshape(S, M + 1, -1)
    U = hist[:, 1:] - hist[:, :-1]                    # [S, M, K]
    UUt = U @ U.transpose(1, 2)                       # [S, M, M]
    scale = torch.diagonal(UUt, dim1=1, dim2=2).sum(-1) / M
    reg = 1e-10 * torch.clamp(scale, min=1e-30)
    eye = torch.eye(M, dtype=hist.dtype, device=hist.device)
    ones = torch.ones((S, M, 1), dtype=hist.dtype, device=hist.device)
    z, info = torch.linalg.solve_ex(UUt + reg[:, None, None] * eye, ones)
    z = z[..., 0]
    denom = torch.sum(z, dim=-1)
    big = torch.abs(denom) > 1e-30
    c = z / torch.where(big, denom, 1.0)[:, None]
    extr = (c[:, None, :] @ hist[:, 1:])[:, 0]
    ok = torch.all(torch.isfinite(extr), dim=-1) & big & (info == 0)
    return torch.where(ok[:, None], extr, hist[:, -1]).reshape(
        (S,) + tuple(shape[2:]))
