"""Synthetic sparse-GLM data generators (numpy, seeded).

Own copies of ``repro.data.synth.make_correlated_design`` and
``make_classification``: the same seed gives the same arrays, bit for bit.
``make_correlated_design`` follows the paper's §E.5 setup: X with
corr(X_j, X_j') = rho^{|j-j'|} (AR(1) process), a sparse ground truth, and
Gaussian noise at a prescribed signal-to-noise ratio.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_correlated_design", "make_classification"]


def make_correlated_design(n=1000, p=2000, n_nonzero=200, rho=0.6, snr=5.0,
                           seed=0, dtype=np.float64, normalize=False):
    rng = np.random.default_rng(seed)
    # AR(1): x_t = rho x_{t-1} + sqrt(1-rho^2) eps_t gives corr rho^{|j-j'|}
    eps = rng.standard_normal((n, p))
    X = np.empty((n, p))
    X[:, 0] = eps[:, 0]
    scale = np.sqrt(1.0 - rho ** 2)
    for j in range(1, p):
        X[:, j] = rho * X[:, j - 1] + scale * eps[:, j]
    beta_true = np.zeros(p)
    supp = rng.choice(p, size=n_nonzero, replace=False)
    beta_true[supp] = 1.0
    signal = X @ beta_true
    noise = rng.standard_normal(n)
    noise *= np.linalg.norm(signal) / (snr * np.linalg.norm(noise))
    y = signal + noise
    if normalize:
        X /= np.linalg.norm(X, axis=0) / np.sqrt(n)   # columns to norm sqrt(n)
    return X.astype(dtype), y.astype(dtype), beta_true.astype(dtype)


def make_classification(n=500, p=1000, n_nonzero=50, seed=0, dtype=np.float64):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    beta_true = np.zeros(p)
    supp = rng.choice(p, size=n_nonzero, replace=False)
    beta_true[supp] = rng.standard_normal(n_nonzero)
    probs = 1.0 / (1.0 + np.exp(-X @ beta_true))
    y = np.where(rng.uniform(size=n) < probs, 1.0, -1.0)
    return X.astype(dtype), y.astype(dtype), beta_true.astype(dtype)
