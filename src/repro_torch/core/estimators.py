"""scikit-learn-style estimators over the solver (port of the non-CV part of
``repro.core.estimators``).

Any datafit pairs with any penalty through ``GeneralizedLinearEstimator``;
``fit(X, y)`` runs Algorithm 1 and stores the fitted state as numpy arrays
in trailing-underscore attributes (``coef_``, ``intercept_``, ...).
``fit`` takes ``device`` (``None``: the estimator's, whose default is CUDA,
raising without a card), ``sample_weight`` and, for quadratic datafits,
``fit_intercept`` centering. ``X`` may be dense, a scipy sparse matrix or a
``repro_torch.sparse.CSCDesign``: sparse fits run CSC-native, without
densifying, and reject ``fit_intercept`` (centering would densify X).
"""
from __future__ import annotations

import numpy as np
import torch

from .. import resolve_device
from .datafits import Logistic, Quadratic, QuadraticSVC
from .engine import DenseDesign, is_scipy_sparse
from .penalties import MCP, SCAD, L1, L1L2, Box
from .solver import solve

__all__ = ["GeneralizedLinearEstimator", "Lasso", "ElasticNet",
           "MCPRegression", "SCADRegression", "SparseLogisticRegression",
           "LinearSVC"]

# datafits whose fit supports fit_intercept=True via X/y centering
_CENTERABLE_DATAFITS = (Quadratic,)


def _host(X):
    """A numpy view of a dense input (array, tensor or DenseDesign)."""
    if isinstance(X, DenseDesign):
        X = X.X
    if torch.is_tensor(X):
        return X.detach().cpu().numpy()
    return np.asarray(X)


def _is_sparse_input(X):
    """True for inputs with no dense [n, p] representation to center."""
    return getattr(X, "KIND", "dense") != "dense" or is_scipy_sparse(X)


def _design_matmul(X, coef):
    """X @ coef (numpy) for dense arrays, scipy sparse matrices or
    designs."""
    if getattr(X, "KIND", None) == "csc":
        beta = torch.as_tensor(coef, dtype=X.dtype, device=X.device)
        return X.matvec(beta).cpu().numpy()
    if is_scipy_sparse(X):
        return np.asarray(X @ coef)
    return _host(X) @ coef


def _center_data(X, y, sample_weight):
    """(X - X_mean, y - y_mean, X_mean, y_mean), with weighted means when
    sample_weight is given; sparse inputs reject (centering would densify
    the design)."""
    if _is_sparse_input(X):
        raise NotImplementedError(
            "fit_intercept=True would densify a sparse design "
            "(column centering); pre-center or add a constant "
            "feature instead")
    Xd, yd = _host(X), _host(y)
    if sample_weight is None:
        X_mean, y_mean = Xd.mean(axis=0), yd.mean(axis=0)
    else:
        w = np.asarray(_host(sample_weight), np.float64)
        s = w.sum()
        X_mean, y_mean = (w @ Xd) / s, (w @ yd) / s
    return Xd - X_mean, yd - y_mean, X_mean, y_mean


class GeneralizedLinearEstimator:
    """Composable estimator: any datafit x any separable penalty.

    `fit_intercept=True` (quadratic datafits only) fits on centered X/y and
    exposes the un-centered `intercept_`; `predict` adds it back.
    """

    def __init__(self, datafit=None, penalty=None, *, tol=1e-6, max_outer=50,
                 max_epochs=1000, M=5, p0=64, fit_intercept=False,
                 use_kernels=None, device=None, **solve_kw):
        self.datafit = Quadratic() if datafit is None else datafit
        self.penalty = L1(1.0) if penalty is None else penalty
        self.tol = tol
        self.max_outer = max_outer
        self.max_epochs = max_epochs
        self.M = M
        self.p0 = p0
        self.use_kernels = use_kernels
        self.device = device
        self.fit_intercept = fit_intercept
        self.solve_kw = solve_kw
        if fit_intercept and \
                not isinstance(self.datafit, _CENTERABLE_DATAFITS):
            raise NotImplementedError(
                f"fit_intercept=True is only supported for quadratic "
                f"datafits (X/y centering), not "
                f"{type(self.datafit).__name__}; center the data beforehand")

    def _solve(self, X, y, device, sample_weight=None):
        return solve(X, y, self.datafit, self.penalty,
                     device=self.device if device is None else device,
                     tol=self.tol, max_outer=self.max_outer,
                     max_epochs=self.max_epochs, M=self.M, p0=self.p0,
                     use_kernels=self.use_kernels,
                     sample_weight=sample_weight, **self.solve_kw)

    def _store(self, res):
        self.kkt_ = res.kkt
        self.converged_ = res.converged
        self.n_iter_ = res.n_outer
        self.n_epochs_ = res.n_epochs
        self.result_ = res
        self.diagnostics_ = res.diagnostics

    def fit(self, X, y, sample_weight=None, *, device=None):
        """Run Algorithm 1 on (X, y); fitted state lands on ``coef_``,
        ``intercept_``, ``kkt_``, ``converged_``, ``n_iter_``,
        ``n_epochs_``, ``result_`` and ``diagnostics_``."""
        self.intercept_ = 0.0
        X_mean = y_mean = None
        if self.fit_intercept:
            X, y, X_mean, y_mean = _center_data(X, y, sample_weight)
        res = self._solve(X, y, device, sample_weight)
        self.coef_ = res.beta.detach().cpu().numpy()
        if self.fit_intercept:
            self.intercept_ = y_mean - X_mean @ self.coef_
        self._store(res)
        return self

    def _linear(self, X):
        return _design_matmul(X, self.coef_) + self.intercept_

    def predict(self, X):
        """Linear predictions ``X @ coef_ + intercept_`` (numpy; dense,
        scipy sparse or design input)."""
        return self._linear(X)

    def score(self, X, y):
        """R^2 for regressors (classifiers override)."""
        y = _host(y)
        resid = y - self.predict(X)
        ss_res = float(np.sum(resid ** 2))
        ss_tot = float(np.sum((y - y.mean(axis=0)) ** 2))
        return 1.0 - ss_res / max(ss_tot, 1e-30)


class Lasso(GeneralizedLinearEstimator):
    """L1-penalized least squares: ``Quadratic() + L1(alpha)``."""

    def __init__(self, alpha=1.0, **kw):
        super().__init__(Quadratic(), L1(alpha), **kw)
        self.alpha = alpha


class ElasticNet(GeneralizedLinearEstimator):
    """Elastic net: ``Quadratic() + L1L2(alpha, l1_ratio)``."""

    def __init__(self, alpha=1.0, l1_ratio=0.5, **kw):
        super().__init__(Quadratic(), L1L2(alpha, l1_ratio), **kw)
        self.alpha, self.l1_ratio = alpha, l1_ratio


class MCPRegression(GeneralizedLinearEstimator):
    """MCP-penalized least squares: ``Quadratic() + MCP(alpha, gamma)``."""

    def __init__(self, alpha=1.0, gamma=3.0, **kw):
        super().__init__(Quadratic(), MCP(alpha, gamma), **kw)
        self.alpha, self.gamma = alpha, gamma


class SCADRegression(GeneralizedLinearEstimator):
    """SCAD-penalized least squares: ``Quadratic() + SCAD(alpha, gamma)``
    (gamma > 2)."""

    def __init__(self, alpha=1.0, gamma=3.7, **kw):
        super().__init__(Quadratic(), SCAD(alpha, gamma), **kw)
        self.alpha, self.gamma = alpha, gamma


class _Classifier(GeneralizedLinearEstimator):
    def predict(self, X):
        return np.sign(self._linear(X) + 1e-30)

    def score(self, X, y):
        return float(np.mean(self.predict(X) == _host(y)))


class SparseLogisticRegression(_Classifier):
    """L1-penalized logistic regression, labels in {-1, +1}:
    ``Logistic() + L1(alpha)``."""

    def __init__(self, alpha=1.0, **kw):
        super().__init__(Logistic(), L1(alpha), **kw)
        self.alpha = alpha

    def predict_proba(self, X):
        p1 = 1.0 / (1.0 + np.exp(-self._linear(X)))
        return np.stack([1 - p1, p1], axis=-1)


class LinearSVC(_Classifier):
    """Dual SVM with hinge loss (paper Eq. 33-35): solves for alpha on the
    label-signed design Z^T = (y * X)^T, then coef_ = Z^T alpha. A scipy
    sparse X keeps Z^T sparse."""

    def __init__(self, C=1.0, **kw):
        super().__init__(QuadraticSVC(), Box(C), **kw)
        self.C = C

    def fit(self, X, y, sample_weight=None, *, device=None):
        """Fit the dual SVM. ``sample_weight`` is rejected: per-sample
        weights rescale the box constraint, not the smooth dual datafit."""
        if sample_weight is not None:
            raise NotImplementedError(
                "sample_weight=...: the dual SVM weights its box "
                "constraint, not the smooth datafit; pass a weighted Box "
                "penalty instead")
        dev = resolve_device(self.device if device is None else device)
        if is_scipy_sparse(X):
            yn = _host(y)
            Zt = X.multiply(yn[:, None]).T.tocsc()       # [d, n] sparse
            res = self._solve(Zt, yn, dev)
            coef = _design_matmul(Zt, res.beta.detach().cpu().numpy())
        elif _is_sparse_input(X):
            raise NotImplementedError(
                "LinearSVC: pass a sparse X as a scipy sparse matrix (the "
                "label-signed design is built from it)")
        else:
            X = torch.as_tensor(_host(X), device=dev)
            yt = torch.as_tensor(_host(y), dtype=X.dtype, device=dev)
            Zt = (yt[:, None] * X).T                     # [d, n]
            res = self._solve(Zt, yt, dev)
            coef = (Zt @ res.beta).detach().cpu().numpy()
        self.intercept_ = 0.0
        self.dual_coef_ = res.beta.detach().cpu().numpy()   # alpha
        self.coef_ = coef                                # Eq. 35
        self._store(res)
        return self
