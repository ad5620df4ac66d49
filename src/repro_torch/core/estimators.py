"""scikit-learn-style estimators over the solver (port of
``repro.core.estimators``).

Any datafit pairs with any penalty through ``GeneralizedLinearEstimator``;
``fit(X, y)`` runs Algorithm 1 and stores the fitted state as numpy arrays
in trailing-underscore attributes (``coef_``, ``intercept_``, ...).
``fit`` takes ``device`` (``None``: the estimator's, whose default is CUDA,
raising without a card), ``sample_weight`` and, for quadratic datafits,
``fit_intercept`` centering. ``X`` may be dense, a scipy sparse matrix or a
``repro_torch.sparse.CSCDesign``: sparse fits run CSC-native, without
densifying, and reject ``fit_intercept`` (centering would densify X).

The CV estimators (``LassoCV``, ``MCPRegressionCV``,
``SparseLogisticRegressionCV``) tune lambda on a grid: k-fold CV as one
(fold x lambda) grid through ``cross_val_path`` and a warm-started refit,
or AIC/BIC/EBIC (``information_criterion``) on one chunked full-data path.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .. import resolve_device
from .datafits import Logistic, MultitaskQuadratic, Quadratic, QuadraticSVC
from .engine import DenseDesign, as_design, is_scipy_sparse
from .penalties import MCP, SCAD, L1, L1L2, BlockL1, BlockMCP, Box
from .solver import solve

__all__ = ["GeneralizedLinearEstimator", "Lasso", "ElasticNet",
           "MCPRegression", "SCADRegression", "SparseLogisticRegression",
           "LinearSVC", "MultiTaskLasso", "MultiTaskMCP", "LassoCV",
           "MCPRegressionCV", "SparseLogisticRegressionCV",
           "information_criterion"]

# datafits whose fit supports fit_intercept=True via X/y centering
_CENTERABLE_DATAFITS = (Quadratic, MultitaskQuadratic)


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
    exposes the un-centered `intercept_` (``[T]`` for multitask targets);
    `predict` adds it back.
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


class MultiTaskLasso(GeneralizedLinearEstimator):
    """Multitask Lasso: ``MultitaskQuadratic() + BlockL1(alpha)``.
    ``fit(X, Y)`` takes targets ``[n, T]`` and produces ``coef_ [p, T]``
    with whole zero rows (support shared by the tasks); ``predict`` returns
    ``[n, T]``."""

    def __init__(self, alpha=1.0, **kw):
        super().__init__(MultitaskQuadratic(), BlockL1(alpha), **kw)
        self.alpha = alpha


class MultiTaskMCP(GeneralizedLinearEstimator):
    """Multitask MCP: ``MultitaskQuadratic() + BlockMCP(alpha, gamma)``,
    the block non-convex penalty that localizes sources the convex
    l_{2,1} misses (paper Fig. 4)."""

    def __init__(self, alpha=1.0, gamma=3.0, **kw):
        super().__init__(MultitaskQuadratic(), BlockMCP(alpha, gamma), **kw)
        self.alpha, self.gamma = alpha, gamma


# --------------------------------------------------------- model selection
def information_criterion(criterion, datafit, loss, n, p, df, *,
                          ebic_gamma=0.5):
    """AIC / BIC / EBIC value(s) of fitted model(s), lower is better.

    ``criterion`` puts 2 (AIC), log n (BIC) or log n + 2 ebic_gamma log p
    (EBIC) on each degree of freedom ``df`` (nonzero count); quadratic
    datafits fit by the Gaussian profile ``n log(MSE)`` (their ``value`` is
    half the MSE), other losses by the deviance ``2 n loss``. ``loss`` is
    the mean datafit loss per model. Returns a numpy array shaped like
    ``loss``."""
    loss = np.asarray(loss, np.float64)
    df = np.asarray(df, np.float64)
    pens = {"aic": 2.0, "bic": np.log(n),
            "ebic": np.log(n) + 2.0 * ebic_gamma * np.log(max(p, 1))}
    if criterion not in pens:
        raise ValueError(f"unknown criterion {criterion!r}; supported: "
                         f"'aic' | 'bic' | 'ebic' (or 'cv')")
    if isinstance(datafit, (Quadratic, MultitaskQuadratic)):
        fit = n * np.log(np.maximum(2.0 * loss, 1e-300))
    else:
        fit = 2.0 * n * loss                      # deviance
    return fit + pens[criterion] * df


class _CVEstimatorMixin:
    """Fit logic of the CV estimators: sweep a lambda grid (the whole
    (fold x lambda) grid at once for ``criterion='cv'``, one full-data
    chunked path scored by AIC/BIC/EBIC otherwise), then expose the
    winner (``alpha_``, ``alphas_``, ``coef_``, ...)."""

    _ENGINE_KEYS = ("M", "max_epochs", "accel", "use_fp_score", "use_gram",
                    "use_kernels")
    # keywords the grid drivers take beside the engine's
    _DRIVER_KEYS = ("engine", "mesh", "obs")

    def _init_grid(self, alphas, n_alphas, eps, cv, criterion, ebic_gamma,
                   vmap_chunk, seed, checkpoint=None, resume=None):
        if criterion not in ("cv", "aic", "bic", "ebic"):
            raise ValueError(f"unknown criterion {criterion!r}; supported: "
                             f"'cv' | 'aic' | 'bic' | 'ebic'")
        if (checkpoint is not None or resume is not None) \
                and criterion != "cv":
            raise ValueError(
                "checkpoint/resume apply to the CV grid only "
                "(criterion='cv'); information-criterion paths are single "
                "solves with nothing to snapshot")
        if checkpoint is not None or resume is not None:
            from .path import _LATER
            raise NotImplementedError(f"checkpoint=/resume=: "
                                      f"{_LATER['checkpoint']}")
        extra = set(self.solve_kw) - set(self._DRIVER_KEYS) \
            - set(self._ENGINE_KEYS)
        if extra:
            raise ValueError(
                f"CV estimators do not support solve kwargs "
                f"{sorted(extra)}: the grid drivers cannot honor them, so "
                f"the tuning sweep would run a different solver than the "
                f"refit")
        self.alphas = alphas
        self.n_alphas = n_alphas
        self.eps = eps
        self.cv = cv
        self.criterion = criterion
        self.ebic_gamma = ebic_gamma
        self.vmap_chunk = vmap_chunk
        self.seed = seed

    def _grid_kw(self):
        """The solver configuration of the tuning sweep: the refit's."""
        kw = {k: v for k, v in self.solve_kw.items()
              if k in self._DRIVER_KEYS or k in self._ENGINE_KEYS}
        kw.update(M=self.M, max_epochs=self.max_epochs,
                  use_kernels=self.use_kernels)
        return kw

    def fit(self, X, y, sample_weight=None, *, device=None):
        """Tune lambda on (X, y) and fit the winning model.

        ``criterion='cv'`` solves the (fold x lambda) grid at once
        (``cross_val_path``), picks the lambda of least mean held-out loss
        and refits on the full data, warm-started from the fold-mean
        solution. ``criterion='aic'|'bic'|'ebic'`` solves one full-data
        chunked path and selects by the criterion. Fitted state:
        ``alpha_``, ``alphas_``, ``coef_``, ``intercept_``, and
        ``cv_loss_``/``grid_result_`` (CV) or ``criterion_path_``."""
        from .api import lambda_max
        from .path import cross_val_path, reg_path
        from .solver import normalize_weights

        dev = resolve_device(self.device if device is None else device)
        X_mean = y_mean = None
        if self.fit_intercept:
            X, y, X_mean, y_mean = _center_data(X, y, sample_weight)
        design = as_design(X, dev, ell=True)
        y = torch.as_tensor(_host(y), dtype=design.dtype, device=dev)
        if self.alphas is None:
            lmax = lambda_max(design, y, self.datafit,
                              sample_weight=sample_weight, device=dev)
            alphas = lmax * np.geomspace(1.0, self.eps, self.n_alphas)
        else:
            alphas = np.asarray(self.alphas, np.float64)
        if self.criterion == "cv":
            grid = cross_val_path(
                design, y, self.datafit, self.penalty, lambdas=alphas,
                cv=self.cv, sample_weight=sample_weight, seed=self.seed,
                tol=self.tol, vmap_chunk=self.vmap_chunk, p0=self.p0,
                max_outer=self.max_outer, device=dev, **self._grid_kw())
            self.grid_result_ = grid
            self.alphas_ = grid.lambdas
            self.cv_loss_ = grid.cv_loss
            self.alpha_ = grid.best_lambda
            self.penalty = dataclasses.replace(self.penalty, lam=self.alpha_)
            self.alpha = self.alpha_
            # refit on the full data at the winner, warm-started from the
            # fold-mean solution
            beta0 = grid.betas[:, grid.best_index].mean(axis=0)
            res = solve(design, y, self.datafit, self.penalty, device=dev,
                        tol=self.tol, max_outer=self.max_outer,
                        max_epochs=self.max_epochs, M=self.M, p0=self.p0,
                        beta0=beta0, use_kernels=self.use_kernels,
                        sample_weight=sample_weight, **self.solve_kw)
            self.coef_ = res.beta.detach().cpu().numpy()
            self._store(res)
        else:
            path = reg_path(
                design, y, self.penalty, self.datafit, lambdas=alphas,
                tol=self.tol, vmap_chunk=max(2, self.vmap_chunk),
                sample_weight=sample_weight, p0=self.p0,
                max_outer=self.max_outer, device=dev, **self._grid_kw())
            self.path_result_ = path
            self.alphas_ = path.lambdas
            n, p = design.shape
            w = None if sample_weight is None else \
                normalize_weights(sample_weight, n, design.dtype, dev)
            losses = []
            for b in path.betas:
                Xb = design.matvec(torch.as_tensor(b, device=dev))
                losses.append(float(
                    self.datafit.value(Xb, y) if w is None
                    else self.datafit.value(Xb, y, w)))
            self.criterion_path_ = information_criterion(
                self.criterion, self.datafit, losses, n, p, path.nnzs,
                ebic_gamma=self.ebic_gamma)
            i = int(np.argmin(self.criterion_path_))
            self.alpha_ = float(path.lambdas[i])
            self.penalty = dataclasses.replace(self.penalty, lam=self.alpha_)
            self.alpha = self.alpha_
            self.coef_ = np.asarray(path.betas[i])
            self.kkt_ = float(path.kkts[i])
            self.converged_ = bool(path.kkts[i] <= self.tol)
            self.n_iter_ = int(path.n_outer[i])
            self.n_epochs_ = int(path.n_epochs[i])
            self.result_ = path
            self.diagnostics_ = path.diagnostics
        self.intercept_ = 0.0 if not self.fit_intercept \
            else y_mean - X_mean @ self.coef_
        return self


class LassoCV(_CVEstimatorMixin, Lasso):
    """Lasso with lambda tuned on a grid: k-fold CV solved as one (fold x
    lambda) grid (``criterion='cv'``, the default) or AIC/BIC/EBIC on one
    full-data path. After ``fit``: ``alpha_``, ``alphas_``, ``cv_loss_``
    ``[n_folds, n_alphas]`` held-out half-MSE (``mse_path_ = 2 *
    cv_loss_``), ``coef_``/``intercept_`` refit on the full data."""

    def __init__(self, *, alphas=None, n_alphas=30, eps=1e-2, cv=5,
                 criterion="cv", ebic_gamma=0.5, vmap_chunk=10, seed=0,
                 checkpoint=None, resume=None, **kw):
        super().__init__(alpha=1.0, **kw)
        self._init_grid(alphas, n_alphas, eps, cv, criterion, ebic_gamma,
                        vmap_chunk, seed, checkpoint=checkpoint,
                        resume=resume)

    @property
    def mse_path_(self):
        """Held-out MSE per (fold, alpha): twice the stored half-MSE."""
        return 2.0 * self.cv_loss_


class MCPRegressionCV(_CVEstimatorMixin, MCPRegression):
    """MCP regression with lambda tuned by the CV grid or AIC/BIC/EBIC
    (gamma fixed)."""

    def __init__(self, *, gamma=3.0, alphas=None, n_alphas=30, eps=1e-2,
                 cv=5, criterion="cv", ebic_gamma=0.5, vmap_chunk=10,
                 seed=0, checkpoint=None, resume=None, **kw):
        super().__init__(alpha=1.0, gamma=gamma, **kw)
        self._init_grid(alphas, n_alphas, eps, cv, criterion, ebic_gamma,
                        vmap_chunk, seed, checkpoint=checkpoint,
                        resume=resume)


class SparseLogisticRegressionCV(_CVEstimatorMixin,
                                 SparseLogisticRegression):
    """L1 logistic regression with lambda tuned by the CV grid (held-out
    mean log-loss) or AIC/BIC/EBIC on the deviance; the fold weights ride
    the weighted Xb inner solve."""

    def __init__(self, *, alphas=None, n_alphas=30, eps=1e-2, cv=5,
                 criterion="cv", ebic_gamma=0.5, vmap_chunk=10, seed=0,
                 checkpoint=None, resume=None, **kw):
        super().__init__(alpha=1.0, **kw)
        self._init_grid(alphas, n_alphas, eps, cv, criterion, ebic_gamma,
                        vmap_chunk, seed, checkpoint=checkpoint,
                        resume=resume)
