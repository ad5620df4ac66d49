"""Datafit terms F(X beta) for Problem (1) (port of ``repro.core.datafits``).

Each datafit is a frozen dataclass whose methods work on tensors:

  value(Xb, y, w)      -> 0-d tensor F(Xb)
  raw_grad(Xb, y, w)   -> F'(Xb) per sample, shape like Xb
  lipschitz(X, w)      -> per-coordinate L_j of nabla_j f
  lipschitz_cols(col_sq, n)
                       -> the same L_j from the (weighted) squared column
                          norms, for designs that cache them (CSC)
  grad_offset(p, dtype, device)
                       -> constant linear term added to X^T raw_grad (0 for
                          most; -1 for the dual SVM)
  make_gram(X_ws, y, w)-> (G, c) with grad_ws(beta) = G beta - c (HAS_GRAM)
  SAMPLE_MEAN, SUPPORTS_WEIGHTS, HAS_GRAM as in the reference.

``w`` is the optional per-sample weight leaf (``None`` elides every weight
op); the solver normalizes user weights to ``sum(w) = n`` at entry.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

__all__ = ["Quadratic", "Logistic", "QuadraticSVC", "MultitaskQuadratic"]


def _wmul(x, w):
    """w (x) x, broadcasting w over a trailing axis; identity for w=None."""
    if w is None:
        return x
    return x * w if x.ndim == 1 else x * w[:, None]


@dataclass(frozen=True)
class Quadratic:
    """F(Xb) = sum_i w_i (y_i - Xb_i)^2 / (2 n)."""
    HAS_GRAM = True
    SAMPLE_MEAN = True
    SUPPORTS_WEIGHTS = True

    def value(self, Xb, y, w=None):
        n = y.shape[0]
        d = y - Xb
        return torch.sum(_wmul(d * d, w)) / (2.0 * n)

    def raw_grad(self, Xb, y, w=None):
        n = y.shape[0]
        return _wmul(Xb - y, w) / n

    def lipschitz(self, X, w=None):
        n = X.shape[0]
        return torch.sum(_wmul(X * X, w), dim=0) / n

    def lipschitz_cols(self, col_sq, n):
        return col_sq / n

    def grad_offset(self, p, dtype, device):
        return torch.zeros((p,), dtype=dtype, device=device)

    def make_gram(self, X_ws, y, w=None):
        n = y.shape[0]
        G = X_ws.T @ _wmul(X_ws, w) / n
        c = X_ws.T @ _wmul(y, w) / n
        return G, c


@dataclass(frozen=True)
class Logistic:
    """F(Xb) = (1/n) sum w_i log(1 + exp(-y_i * Xb_i)), y in {-1, +1}."""
    HAS_GRAM = False
    SAMPLE_MEAN = True
    SUPPORTS_WEIGHTS = True

    def value(self, Xb, y, w=None):
        n = y.shape[0]
        z = -y * Xb
        return torch.sum(_wmul(torch.logaddexp(torch.zeros_like(z), z),
                               w)) / n

    def raw_grad(self, Xb, y, w=None):
        n = y.shape[0]
        return _wmul(-y * torch.sigmoid(-y * Xb), w) / n

    def lipschitz(self, X, w=None):
        n = X.shape[0]
        return torch.sum(_wmul(X * X, w), dim=0) / (4.0 * n)

    def lipschitz_cols(self, col_sq, n):
        return col_sq / (4.0 * n)

    def grad_offset(self, p, dtype, device):
        return torch.zeros((p,), dtype=dtype, device=device)

    def make_gram(self, X_ws, y, w=None):
        raise NotImplementedError("Logistic has no Gram fast path.")


@dataclass(frozen=True)
class QuadraticSVC:
    """Dual SVM with hinge loss (paper Eq. 33-34).

    Variables alpha in R^n; f(alpha) = 0.5 ||Z^T alpha||^2 - sum(alpha) with
    Z = y[:, None] * X_feat. In Problem (1) form the design is X = Z^T plus
    the constant linear term -1 (grad_offset). Sample weights are rejected.
    """
    HAS_GRAM = True
    SAMPLE_MEAN = False
    SUPPORTS_WEIGHTS = False

    def value(self, Xb, y, w=None):
        del y, w
        return 0.5 * torch.sum(Xb * Xb)

    def raw_grad(self, Xb, y, w=None):
        del y, w
        return Xb

    def lipschitz(self, X, w=None):
        del w
        return torch.sum(X * X, dim=0)

    def lipschitz_cols(self, col_sq, n):
        del n                        # un-normalized sum datafit
        return col_sq

    def grad_offset(self, p, dtype, device):
        return -torch.ones((p,), dtype=dtype, device=device)

    def make_gram(self, X_ws, y, w=None):
        del y, w
        G = X_ws.T @ X_ws
        c = torch.ones((X_ws.shape[1],), dtype=X_ws.dtype,
                       device=X_ws.device)
        return G, c


@dataclass(frozen=True)
class MultitaskQuadratic:
    """F(XW) = sum_i w_i ||Y_i - (XW)_i||^2 / (2 n); blocks = rows of W
    (paper Appendix D).

    Y is [n, T] and the coefficients W are [p, T]: the engine treats the
    rows W_j: as block coordinates; pair it with BlockL1 / BlockMCP. Sample
    weights ``w`` stay [n] (one weight per sample, shared by the tasks).
    """
    HAS_GRAM = True
    SAMPLE_MEAN = True
    SUPPORTS_WEIGHTS = True

    def value(self, Xb, y, w=None):
        n = y.shape[0]
        return torch.sum(_wmul((y - Xb) ** 2, w)) / (2.0 * n)

    def raw_grad(self, Xb, y, w=None):
        n = y.shape[0]
        return _wmul(Xb - y, w) / n

    def lipschitz(self, X, w=None):
        n = X.shape[0]
        return torch.sum(_wmul(X ** 2, w), dim=0) / n

    def lipschitz_cols(self, col_sq, n):
        return col_sq / n

    def grad_offset(self, p, dtype, device):
        return torch.zeros((p,), dtype=dtype, device=device)

    def make_gram(self, X_ws, y, w=None):
        n = y.shape[0]
        G = X_ws.T @ _wmul(X_ws, w) / n
        c = X_ws.T @ _wmul(y, w) / n          # [K, T]
        return G, c
