"""Replicate-weight generators for grid solves (numpy; own copy of
``repro.data.folds``: the same seed gives the same weights, bit for bit).

The grid driver (``repro_torch.core.cross_val_path``) treats every
cross-validation fold or bootstrap replicate as a per-sample weight vector
on the SAME (X, y): 0/1 train membership for k-fold CV, resample counts for
the bootstrap. All replicates then share one static problem shape, so one
captured step per working-set bucket serves the whole (fold x lambda)
grid. These helpers build the ``[n_replicates, n]`` weight matrices host-side; held-out
rows of a replicate are exactly its zero-weight rows (out-of-bag rows for
the bootstrap).
"""
from __future__ import annotations

import numpy as np

__all__ = ["kfold_weights", "bootstrap_weights"]


def kfold_weights(n, n_folds=5, *, seed=0, shuffle=True, dtype=np.float64):
    """0/1 train-membership weights for k-fold cross-validation.

    Returns ``[n_folds, n]``: row f is 1.0 on the training rows of fold f
    and 0.0 on its held-out rows. Fold sizes differ by at most one sample;
    ``shuffle=False`` assigns contiguous blocks instead of a permuted split.
    """
    if not 2 <= n_folds <= n:
        raise ValueError(f"n_folds must be in [2, n={n}], got {n_folds}")
    idx = np.arange(n)
    if shuffle:
        idx = np.random.default_rng(seed).permutation(n)
    W = np.ones((n_folds, n), dtype=dtype)
    for f, test in enumerate(np.array_split(idx, n_folds)):
        W[f, test] = 0.0
    return W


def bootstrap_weights(n, n_replicates, *, seed=0, dtype=np.float64):
    """Bootstrap resample counts: ``[n_replicates, n]`` integer-valued
    weights, row r counting how often each sample appears in the r-th
    resample of size n (FaSTGLZ-style simultaneous bootstrap fitting).
    Out-of-bag rows carry weight 0 and are the replicate's held-out set.
    """
    if n_replicates < 1:
        raise ValueError(f"n_replicates must be >= 1, got {n_replicates}")
    rng = np.random.default_rng(seed)
    W = np.zeros((n_replicates, n), dtype=dtype)
    for r in range(n_replicates):
        np.add.at(W[r], rng.integers(0, n, size=n), 1.0)
    return W
