"""Convenience API: lambda_max, duality gaps, and named solvers (port of
``repro.core.api``). Every function takes ``device``
(``None`` means CUDA, as for ``solve``); the named solvers forward their
keyword arguments, ``device`` included, to :func:`solve`.
"""
from __future__ import annotations

import torch

from .. import resolve_device
from .datafits import Logistic, MultitaskQuadratic, Quadratic, QuadraticSVC
from .engine import as_design
from .penalties import MCP, SCAD, L05, L23, L1, L1L2, BlockL1, BlockMCP, Box
from .solver import normalize_weights, solve

__all__ = ["lambda_max", "lasso_gap", "enet_gap", "logreg_gap",
           "lasso", "elastic_net", "mcp_regression", "scad_regression",
           "l05_regression", "l23_regression", "sparse_logreg", "svc_dual",
           "multitask_lasso", "multitask_mcp"]


def lambda_max(X, y, datafit=None, sample_weight=None, device=None):
    """Smallest lambda with solution 0: ||X^T F'(X 0)||_inf (paper §3.1).
    `X` may be dense, a scipy sparse matrix or a design (the sparse score
    pass never densifies X). `sample_weight` (rescaled to sum to n, as in
    :func:`solve`) weights the raw gradient. For a multitask target
    ``y [n, T]`` it is the largest row norm of ``X^T F'(X 0)``."""
    device = resolve_device(device)
    datafit = Quadratic() if datafit is None else datafit
    design = as_design(X, device)
    y = torch.as_tensor(y, dtype=design.dtype, device=device)
    Xb0 = torch.zeros((design.n_rows,) + tuple(y.shape[1:]),
                      dtype=design.dtype, device=device)
    # a CSC design scores in the walk's fixed order (K5/K5b on a card), so
    # two calls on one design give one lambda
    score = design.score_walk if design.KIND == "csc" else design.score
    if sample_weight is None:
        grad0 = score(datafit.raw_grad(Xb0, y))
    else:
        w = normalize_weights(sample_weight, design.n_rows, design.dtype,
                              device)
        grad0 = score(datafit.raw_grad(Xb0, y, w))
    if grad0.ndim == 2:
        return float(torch.max(torch.sqrt(torch.sum(grad0 ** 2, dim=-1))))
    return float(torch.max(torch.abs(grad0)))


def _tensors(device, X, y, beta):
    device = resolve_device(device)
    X = torch.as_tensor(X, device=device)
    return (X, torch.as_tensor(y, dtype=X.dtype, device=device),
            torch.as_tensor(beta, dtype=X.dtype, device=device))


def lasso_gap(X, y, beta, lam, device=None):
    """Duality gap + primal for the Lasso."""
    X, y, beta = _tensors(device, X, y, beta)
    n = y.shape[0]
    r = y - X @ beta
    primal = torch.sum(r * r) / (2 * n) + lam * torch.sum(torch.abs(beta))
    theta = r / n
    scale = torch.clamp(lam / torch.clamp(torch.max(torch.abs(X.T @ theta)),
                                          min=1e-30), max=1.0)
    theta = theta * scale
    d = theta - y / n
    dual = 0.5 * torch.sum(y * y) / n - 0.5 * n * torch.sum(d * d)
    return float(primal - dual), float(primal)


def enet_gap(X, y, beta, lam, rho, device=None):
    """Elastic-net duality gap + primal value at beta."""
    X, y, beta = _tensors(device, X, y, beta)
    n = y.shape[0]
    r = y - X @ beta
    primal = (torch.sum(r * r) / (2 * n)
              + lam * rho * torch.sum(torch.abs(beta))
              + 0.5 * lam * (1 - rho) * torch.sum(beta * beta))
    theta = r / n
    z = X.T @ theta - lam * (1 - rho) * beta
    scale = torch.clamp(lam * rho / torch.clamp(torch.max(torch.abs(z)),
                                                min=1e-30), max=1.0)
    theta_s = theta * scale
    d = theta_s - y / n
    dual = (0.5 * torch.sum(y * y) / n - 0.5 * n * torch.sum(d * d)
            - 0.5 * lam * (1 - rho) * torch.sum(beta * beta) * scale ** 2)
    return float(primal - dual), float(primal)


def logreg_gap(X, y, beta, lam, device=None):
    """L1-logistic duality gap + primal value at beta."""
    X, y, beta = _tensors(device, X, y, beta)
    n = y.shape[0]
    Xb = X @ beta
    z = -y * Xb
    primal = torch.sum(torch.logaddexp(torch.zeros_like(z), z)) / n + \
        lam * torch.sum(torch.abs(beta))
    raw = -y * torch.sigmoid(z) / n
    scale = torch.clamp(lam / torch.clamp(torch.max(torch.abs(X.T @ raw)),
                                          min=1e-30), max=1.0)
    theta = -raw * scale
    u = torch.clamp(n * y * theta, 1e-12, 1 - 1e-12)
    dual = -torch.sum(u * torch.log(u) + (1 - u) * torch.log(1 - u)) / n
    return float(primal - dual), float(primal)


def lasso(X, y, lam, **kw):
    """Lasso: quadratic datafit + L1 penalty. Returns a SolveResult."""
    return solve(X, y, Quadratic(), L1(lam), **kw)


def elastic_net(X, y, lam, rho=0.5, **kw):
    """Elastic net: quadratic datafit + L1L2(lam, rho)."""
    return solve(X, y, Quadratic(), L1L2(lam, rho), **kw)


def mcp_regression(X, y, lam, gamma=3.0, **kw):
    """MCP-penalized regression (non-convex, lower bias than L1)."""
    return solve(X, y, Quadratic(), MCP(lam, gamma), **kw)


def scad_regression(X, y, lam, gamma=3.7, **kw):
    """SCAD-penalized regression (non-convex; gamma > 2)."""
    return solve(X, y, Quadratic(), SCAD(lam, gamma), **kw)


def l05_regression(X, y, lam, **kw):
    """l_{1/2}-penalized regression (fixed-point scores)."""
    return solve(X, y, Quadratic(), L05(lam), **kw)


def l23_regression(X, y, lam, **kw):
    """l_{2/3}-penalized regression (fixed-point scores)."""
    return solve(X, y, Quadratic(), L23(lam), **kw)


def sparse_logreg(X, y, lam, **kw):
    """L1-penalized logistic regression, y in {-1, +1}."""
    return solve(X, y, Logistic(), L1(lam), **kw)


def svc_dual(X, y, C=1.0, **kw):
    """Dual SVM (paper Eq. 34). Returns the SolveResult (alpha) and the
    primal w = Z^T alpha (Eq. 35)."""
    device = resolve_device(kw.get("device"))
    X = torch.as_tensor(X, device=device)
    y = torch.as_tensor(y, dtype=X.dtype, device=device)
    Z = y[:, None] * X
    res = solve(Z.T, y, QuadraticSVC(), Box(C), **kw)
    return res, Z.T @ res.beta


def multitask_lasso(X, Y, lam, **kw):
    """Multitask Lasso: Frobenius datafit + row-block l_{2,1} penalty.
    ``Y`` is ``[n, T]``; the solution is ``[p, T]`` with whole zero rows
    (shared support across tasks: the M/EEG model, paper Fig. 4)."""
    return solve(X, Y, MultitaskQuadratic(), BlockL1(lam), **kw)


def multitask_mcp(X, Y, lam, gamma=3.0, **kw):
    """Multitask MCP: the block non-convex penalty on the row norms, which
    localizes sources the convex l_{2,1} misses (paper Fig. 4)."""
    return solve(X, Y, MultitaskQuadratic(), BlockMCP(lam, gamma), **kw)
