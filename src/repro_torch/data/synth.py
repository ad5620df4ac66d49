"""Synthetic sparse-GLM data generators (numpy, seeded).

Own copies of ``repro.data.synth.make_correlated_design``,
``make_classification``, ``make_sparse_design``, ``make_multitask`` and
``make_leadfield``: the same seed gives the same arrays, bit for bit.
``make_correlated_design`` follows the paper's §E.5 setup: X with
corr(X_j, X_j') = rho^{|j-j'|} (AR(1) process), a sparse ground truth, and
Gaussian noise at a prescribed signal-to-noise ratio.
"""
from __future__ import annotations

import numpy as np

__all__ = ["make_correlated_design", "make_classification",
           "make_sparse_design", "make_multitask", "make_leadfield"]


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


def make_sparse_design(n=10000, p=50000, density=1e-3, n_nonzero=100,
                       snr=5.0, power=1.1, max_col_frac=0.02, seed=0,
                       dtype=np.float64):
    """News20-like sparse design: power-law column densities (column j
    holds ~(j+1)^-power of the nnz, clipped to ``max_col_frac * n``, total
    ``density * n * p``), standard-normal values, a sparse ground truth
    drawn from the denser half of the columns, Gaussian noise at the
    prescribed SNR. Returns (X as scipy CSC, y, beta_true)."""
    from scipy import sparse as sp

    rng = np.random.default_rng(seed)
    target_nnz = density * n * p
    cap = max(1, int(max_col_frac * n))
    w = (np.arange(p, dtype=np.float64) + 1.0) ** -power
    # the clip removes head mass, so rescale until the tail absorbs it
    scale = target_nnz / w.sum()
    col_nnz = np.clip(np.round(w * scale), 1, cap).astype(np.int64)
    for _ in range(16):
        tot = col_nnz.sum()
        if tot >= 0.98 * target_nnz or (col_nnz == cap).all():
            break
        scale *= target_nnz / tot
        col_nnz = np.clip(np.round(w * scale), 1, cap).astype(np.int64)
    # rows drawn with replacement, duplicate (col, row) pairs dropped
    cols = np.repeat(np.arange(p, dtype=np.int64), col_nnz)
    rows = rng.integers(0, n, cols.shape[0])
    keys = np.unique(cols * n + rows)
    cols, rows = keys // n, keys % n
    vals = rng.standard_normal(len(keys)).astype(dtype)
    X = sp.csc_matrix((vals, (rows, cols)), shape=(n, p), dtype=dtype)
    X.sort_indices()

    beta_true = np.zeros(p, dtype)
    supp = rng.choice(p // 2, size=min(n_nonzero, p // 2), replace=False)
    beta_true[supp] = rng.standard_normal(len(supp))
    signal = X @ beta_true
    noise = rng.standard_normal(n)
    nrm = np.linalg.norm(signal)
    if nrm > 0:
        noise *= nrm / (snr * np.linalg.norm(noise))
    y = (signal + noise).astype(dtype)
    return X, y, beta_true


def make_multitask(n=300, p=600, n_tasks=10, n_nonzero=20, snr=3.0, seed=0,
                   dtype=np.float64):
    """Gaussian X [n, p], a row-sparse ground truth W [p, n_tasks] with
    ``n_nonzero`` standard-normal rows, Y = X W + noise at the prescribed
    SNR. Returns (X, Y, W)."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    W = np.zeros((p, n_tasks))
    supp = rng.choice(p, size=n_nonzero, replace=False)
    W[supp] = rng.standard_normal((n_nonzero, n_tasks))
    signal = X @ W
    noise = rng.standard_normal((n, n_tasks))
    noise *= np.linalg.norm(signal) / (snr * np.linalg.norm(noise))
    Y = signal + noise
    return X.astype(dtype), Y.astype(dtype), W.astype(dtype)


def make_leadfield(n=60, p_per_hemi=150, T=20, *, coherence=0.98, snr=1.5,
                   seed=0):
    """The Figure 4 M/EEG-analog forward problem: two "hemisphere" blocks of
    highly column-coherent leadfield-like features hide one true source row
    each (the second 4x weaker). Returns (X [n, 2*p_per_hemi], Y [n, T],
    W_true, true_rows)."""
    rng = np.random.default_rng(seed)
    cols = []
    true_rows = []
    for h in range(2):
        base = rng.standard_normal((n, 1))
        block = (coherence * base
                 + np.sqrt(1 - coherence ** 2)
                 * rng.standard_normal((n, p_per_hemi)))
        cols.append(block)
        true_rows.append(int(h * p_per_hemi + rng.integers(0, p_per_hemi)))
    X = np.concatenate(cols, axis=1)
    X /= np.linalg.norm(X, axis=0) / np.sqrt(n)
    W = np.zeros((2 * p_per_hemi, T))
    t = np.linspace(0, 1, T)
    W[true_rows[0]] = np.sin(2 * np.pi * 5 * t)
    W[true_rows[1]] = np.cos(2 * np.pi * 3 * t) * 0.25
    signal = X @ W
    noise = rng.standard_normal((n, T))
    noise *= np.linalg.norm(signal) / (snr * np.linalg.norm(noise))
    return X, signal + noise, W, true_rows
