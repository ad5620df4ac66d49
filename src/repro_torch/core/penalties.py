"""Separable penalties g(beta) = sum_j g_j(beta_j) for Problem (1) of the paper.

Port of ``repro.core.penalties`` (the seven scalar penalties and the two
block ones). Each penalty is a frozen dataclass whose hyper-parameters are
plain floats, or 0-d tensors (``kernels.common.bind_penalty``: the kernel
route's captured step reads them from a device vector), and whose methods
work on tensors:

  value(beta)               -> 0-d tensor penalty value
  prox(x, step)             -> elementwise prox_{step * g_j}(x)
  subdiff_dist(grad, beta)  -> per-coordinate dist(-grad_j, d g_j(beta_j))
  generalized_support(beta) -> bool mask, Definition 4
  HAS_SUBDIFF               -> False when the subdifferential score is
                               uninformative (l_q, 0<q<1) and the fixed-point
                               score must be used instead.

The block penalties ``BlockL1`` and ``BlockMCP`` (multitask, paper
Appendix D) act on the rows W_j: of coefficients W [p, T]: their prox acts
on the last axis, and ``subdiff_dist`` / ``generalized_support`` return one
value per row.

The arithmetic is written op by op in the order the CUDA prox
(``csrc/prox.cuh``) uses, so the kernels and these plain versions round
alike. ``step`` may be a float or a tensor broadcasting against ``x``. No
method branches in Python on a hyper-parameter's value or reads it back,
and a square is a product (``lam * lam``, as the kernels take it), so a
penalty with 0-d tensor fields gives the float penalty's results bit for
bit on the CPU (``tests/test_torch_path.py``).
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

__all__ = ["L1", "L1L2", "MCP", "SCAD", "L05", "L23", "Box", "BlockL1",
           "BlockMCP", "soft_threshold", "cbrt"]

_TWO_PI_3 = 2.0 * math.pi / 3.0


def soft_threshold(x, t):
    """Elementwise ``sign(x) * max(|x| - t, 0)``: the prox of ``t * |.|``."""
    return torch.sign(x) * torch.clamp(torch.abs(x) - t, min=0.0)


def cbrt(x):
    """Real cube root (torch has no ``cbrt``): ``sign(x) * |x|^(1/3)``."""
    return torch.sign(x) * torch.pow(torch.abs(x), 1.0 / 3.0)


def _as_tensor(v, like):
    return v if torch.is_tensor(v) else torch.as_tensor(
        v, dtype=like.dtype, device=like.device)


@dataclass(frozen=True)
class L1:
    """g_j = lam * |.| (the Lasso penalty)."""
    lam: float
    HAS_SUBDIFF = True

    def value(self, beta):
        return self.lam * torch.sum(torch.abs(beta))

    def prox(self, x, step):
        return soft_threshold(x, step * self.lam)

    def subdiff_dist(self, grad, beta):
        at0 = torch.clamp(torch.abs(grad) - self.lam, min=0.0)
        away = torch.abs(grad + self.lam * torch.sign(beta))
        return torch.where(beta == 0.0, at0, away)

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class L1L2:
    """Elastic net: g_j = lam * (rho*|.| + (1-rho)/2 * (.)^2)."""
    lam: float
    rho: float
    HAS_SUBDIFF = True

    def value(self, beta):
        return self.lam * (self.rho * torch.sum(torch.abs(beta))
                           + 0.5 * (1.0 - self.rho) * torch.sum(beta * beta))

    def prox(self, x, step):
        return (soft_threshold(x, step * self.lam * self.rho)
                / (1.0 + step * self.lam * (1.0 - self.rho)))

    def subdiff_dist(self, grad, beta):
        at0 = torch.clamp(torch.abs(grad) - self.lam * self.rho, min=0.0)
        away = torch.abs(grad + self.lam * self.rho * torch.sign(beta)
                         + self.lam * (1.0 - self.rho) * beta)
        return torch.where(beta == 0.0, at0, away)

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class MCP:
    """Minimax concave penalty (Zhang 2010), Proposition 7 of the paper.

    MCP_{lam,gamma}(x) = lam|x| - x^2/(2 gamma)    if |x| <= gamma lam
                       = gamma lam^2 / 2           otherwise
    """
    lam: float
    gamma: float
    HAS_SUBDIFF = True

    def value(self, beta):
        a = torch.abs(beta)
        inner = self.lam * a - a * a / (2.0 * self.gamma)
        outer = 0.5 * self.gamma * (self.lam * self.lam)
        return torch.sum(torch.where(a <= self.gamma * self.lam, inner,
                                     outer))

    def prox(self, x, step):
        # requires gamma > step for a single-valued prox
        a = torch.abs(x)
        shrunk = soft_threshold(x, step * self.lam) / (1.0 - step / self.gamma)
        out = torch.where(a <= self.gamma * self.lam, shrunk, x)
        return torch.where(a <= step * self.lam, 0.0, out)

    def subdiff_dist(self, grad, beta):
        a = torch.abs(beta)
        at0 = torch.clamp(torch.abs(grad) - self.lam, min=0.0)
        mid = torch.abs(grad + self.lam * torch.sign(beta) - beta / self.gamma)
        flat = torch.abs(grad)
        return torch.where(beta == 0.0, at0,
                           torch.where(a < self.gamma * self.lam, mid, flat))

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class SCAD:
    """SCAD penalty (Fan & Li); gamma > 2. Prox requires gamma > 1 + step."""
    lam: float
    gamma: float
    HAS_SUBDIFF = True

    def value(self, beta):
        a = torch.abs(beta)
        lam, g = self.lam, self.gamma
        p1 = lam * a
        p2 = (2.0 * g * lam * a - a * a - lam * lam) / (2.0 * (g - 1.0))
        p3 = lam * lam * (g + 1.0) / 2.0
        return torch.sum(torch.where(a <= lam, p1,
                                     torch.where(a <= g * lam, p2, p3)))

    def prox(self, x, step):
        lam, g = self.lam, self.gamma
        a = torch.abs(x)
        r1 = soft_threshold(x, step * lam)
        r2 = ((g - 1.0) * x - torch.sign(x) * g * lam * step) / (g - 1.0 - step)
        return torch.where(a <= lam * (1.0 + step), r1,
                           torch.where(a <= g * lam, r2, x))

    def subdiff_dist(self, grad, beta):
        lam, g = self.lam, self.gamma
        a = torch.abs(beta)
        at0 = torch.clamp(torch.abs(grad) - lam, min=0.0)
        low = torch.abs(grad + lam * torch.sign(beta))
        mid = torch.abs(grad + torch.sign(beta) * (g * lam - a) / (g - 1.0))
        flat = torch.abs(grad)
        return torch.where(beta == 0.0, at0,
                           torch.where(a <= lam, low,
                                       torch.where(a <= g * lam, mid, flat)))

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class L05:
    """l_{1/2} penalty: g_j = lam * |.|^{1/2} (Appendix C of the paper).

    The subdifferential at 0 is R (HAS_SUBDIFF = False). Prox is the
    half-thresholding operator: zero on [-(3/2)(step lam)^{2/3},
    (3/2)(step lam)^{2/3}] (paper, Eq. 26).
    """
    lam: float
    HAS_SUBDIFF = False

    def value(self, beta):
        return self.lam * torch.sum(torch.sqrt(torch.abs(beta)))

    def prox(self, x, step):
        t = _as_tensor(step * self.lam, x)
        a = torch.abs(x)
        thresh = 1.5 * torch.pow(t, 2.0 / 3.0)
        # phi = arccos((t/4) * (a/3)^{-3/2}); guard the zero region against nan
        safe_a = torch.maximum(a, thresh + 1e-30)
        phi = torch.arccos(torch.clamp(
            0.25 * t * torch.pow(safe_a / 3.0, -1.5), -1.0, 1.0))
        z = (2.0 / 3.0) * safe_a * (1.0 + torch.cos(_TWO_PI_3
                                                   - 2.0 * phi / 3.0))
        return torch.where(a <= thresh, 0.0, torch.sign(x) * z)

    def subdiff_dist(self, grad, beta):
        a = torch.abs(beta)
        away = torch.abs(grad + self.lam * torch.sign(beta)
                         / (2.0 * torch.sqrt(torch.clamp(a, min=1e-30))))
        return torch.where(beta == 0.0, 0.0, away)

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class L23:
    """l_{2/3} penalty: g_j = lam * |.|^{2/3} (paper §2.1).

    The prox solves u^4 - |x| u + (2/3) step lam = 0 with u = z^{1/3} by a
    fixed 40-step guarded Newton from u0 = |x|^{1/3}, then compares the
    objective against z = 0 exactly (same steps and guards as the
    reference, so results agree near the thresholds).
    """
    lam: float
    HAS_SUBDIFF = False

    def value(self, beta):
        return self.lam * torch.sum(torch.pow(torch.abs(beta), 2.0 / 3.0))

    def prox(self, x, step):
        t = _as_tensor(step * self.lam, x)
        a = torch.abs(x)
        a_safe = torch.clamp(a, min=1e-30)
        ub = cbrt(a_safe)
        u = ub                                      # largest-root init
        c = (2.0 / 3.0) * t
        for _ in range(40):
            u2 = u * u
            h = u2 * u2 - a_safe * u + c
            hp = 4.0 * (u2 * u) - a_safe
            u = u - h / torch.where(torch.abs(hp) > 1e-30, hp, 1e-30)
            u = torch.minimum(torch.clamp(u, min=0.0), ub)
        u2 = u * u
        z = u2 * u
        # exact global choice: objective at the stationary point vs at 0
        obj_z = 0.5 * (z - a) * (z - a) + t * torch.pow(z, 2.0 / 3.0)
        obj_0 = 0.5 * a * a
        stationary = torch.abs(u2 * u2 - a_safe * u + c) < \
            1e-6 * torch.clamp(a_safe * a_safe, min=1.0)
        take = stationary & (obj_z < obj_0) & (a > 0)
        return torch.where(take, torch.sign(x) * z, 0.0)

    def subdiff_dist(self, grad, beta):
        a = torch.abs(beta)
        away = torch.abs(grad + self.lam * (2.0 / 3.0) * torch.sign(beta)
                         / cbrt(torch.clamp(a, min=1e-30)))
        return torch.where(beta == 0.0, 0.0, away)

    def generalized_support(self, beta):
        return beta != 0.0


@dataclass(frozen=True)
class Box:
    """Indicator of [0, C]: the dual-SVM 'penalty' (paper Eq. 34).

    Generalized support = {j : 0 < beta_j < C}.
    """
    C: float
    HAS_SUBDIFF = True

    def value(self, beta):
        return torch.zeros((), dtype=beta.dtype, device=beta.device)

    def prox(self, x, step):
        del step
        # clamp(x, 0, C) in two steps: C may be a 0-d tensor
        return torch.clamp(torch.clamp(x, min=0.0), max=self.C)

    def subdiff_dist(self, grad, beta):
        at0 = torch.clamp(-grad, min=0.0)          # N_[0,C](0) = (-inf, 0]
        atC = torch.clamp(grad, min=0.0)           # N_[0,C](C) = [0, +inf)
        inside = torch.abs(grad)
        return torch.where(beta <= 0.0, at0,
                           torch.where(beta >= self.C, atC, inside))

    def generalized_support(self, beta):
        return (beta > 0.0) & (beta < self.C)


def _row_norms(W):
    return torch.sqrt(torch.sum(W ** 2, dim=-1))


@dataclass(frozen=True)
class BlockL1:
    """Multitask l_{2,1}: g_j(W_j:) = lam * ||W_j:||_2 (paper Appendix D)."""
    lam: float
    HAS_SUBDIFF = True

    def value(self, W):
        return self.lam * torch.sum(_row_norms(W))

    def prox(self, x, step):
        # x: [..., T] one block (or a batch of blocks); Proposition 18
        nrm = torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True))
        scale = torch.clamp(nrm - step * self.lam, min=0.0) / \
            torch.clamp(nrm, min=1e-30)
        return x * scale

    def subdiff_dist(self, grad, W):
        # grad, W: [p, T]
        gn = _row_norms(grad)
        wn = _row_norms(W)
        at0 = torch.clamp(gn - self.lam, min=0.0)
        away = _row_norms(grad + self.lam * W
                          / torch.clamp(wn, min=1e-30)[:, None])
        return torch.where(wn == 0.0, at0, away)

    def generalized_support(self, W):
        return _row_norms(W) != 0.0


@dataclass(frozen=True)
class BlockMCP:
    """Multitask MCP: g_j(W_j:) = MCP_{lam,gamma}(||W_j:||), Proposition 18
    (the scalar MCP on the row norm)."""
    lam: float
    gamma: float
    HAS_SUBDIFF = True

    def _scalar(self):
        return MCP(self.lam, self.gamma)

    def value(self, W):
        return self._scalar().value(_row_norms(W))

    def prox(self, x, step):
        nrm = torch.sqrt(torch.sum(x ** 2, dim=-1, keepdim=True))
        p = self._scalar().prox(nrm, step)
        return x * p / torch.clamp(nrm, min=1e-30)

    def subdiff_dist(self, grad, W):
        wn = _row_norms(W)
        gn = _row_norms(grad)
        at0 = torch.clamp(gn - self.lam, min=0.0)
        dirn = W / torch.clamp(wn, min=1e-30)[:, None]
        mid = _row_norms(grad + (self.lam - wn / self.gamma)[:, None] * dirn)
        flat = gn
        return torch.where(wn == 0.0, at0,
                           torch.where(wn < self.gamma * self.lam, mid, flat))

    def generalized_support(self, W):
        return _row_norms(W) != 0.0
