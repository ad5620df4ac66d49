"""Coordinate-descent epochs (paper Algorithm 3), plain torch (port of
``repro.core.cd``).

  * cd_epoch_xb:   general datafits. Maintains Xb = X_ws @ beta_ws; each
                   coordinate update costs O(n) (dot + axpy).
  * cd_epoch_gram: quadratic datafits. Maintains q = G @ beta_ws on the
                   working-set Gram G = X_ws^T X_ws; each update is O(K).

Both take scalar coordinates (beta_ws [K]) and multitask blocks
(beta_ws [K, T], with a block penalty whose prox acts on a row). These are
the plain references that the CUDA kernels K1 and K1b (Gram) and K2 (Xb,
scalar) mirror; the block Xb epoch has no kernel and runs as it is on
every device. Every step stays on the tensor's device: no host read. The
inputs are not modified; the updates run in place on copies.
"""
from __future__ import annotations

import torch

__all__ = ["cd_epoch_gram", "cd_epoch_xb"]


def _axpy_(carrier, vec, delta):
    """carrier += vec (x) delta in place, for scalar and block
    coordinates."""
    if delta.ndim == 0:
        carrier.add_(vec * delta)
    else:
        carrier.add_(vec[:, None] * delta[None, :])


def _coord_step(penalty, bj, gj, Lj):
    step = 1.0 / torch.clamp(Lj, min=1e-30)
    new = penalty.prox(bj - gj * step, step)
    return torch.where(Lj > 0.0, new, bj)


def cd_epoch_xb(Xt_ws, y, beta_ws, Xb, L_ws, offset_ws, datafit, penalty,
                w=None):
    """One cyclic CD epoch over the working set; X stored transposed
    [K, n]. `w` is the optional per-sample weight vector forwarded to the
    datafit's raw gradient."""
    beta, Xb = beta_ws.clone(), Xb.clone()
    for i in range(Xt_ws.shape[0]):
        xj = Xt_ws[i]
        raw = datafit.raw_grad(Xb, y) if w is None \
            else datafit.raw_grad(Xb, y, w)
        gj = xj @ raw + offset_ws[i]
        bj = beta[i].clone()
        new = _coord_step(penalty, bj, gj, L_ws[i])
        _axpy_(Xb, xj, new - bj)
        beta[i] = new
    return beta, Xb


def cd_epoch_gram(G, c, beta_ws, q, L_ws, penalty):
    """One cyclic CD epoch on the Gram subproblem: grad = q - c, q = G beta."""
    beta, q = beta_ws.clone(), q.clone()
    for i in range(G.shape[0]):
        bj = beta[i].clone()
        new = _coord_step(penalty, bj, q[i] - c[i], L_ws[i])
        _axpy_(q, G[:, i], new - bj)
        beta[i] = new
    return beta, q
