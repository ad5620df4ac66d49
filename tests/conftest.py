"""Shared test fixtures.

x64 is enabled for the whole test process: the solver tests validate KKT
conditions / duality gaps to tolerances below float32 resolution. Model code
pins its own dtypes (bf16/f32) so it is unaffected. Do NOT set
xla_force_host_platform_device_count here — smoke tests must see 1 device
(assignment contract); multi-device tests run in subprocesses.
"""
import jax

jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402
import pytest       # noqa: E402

from repro.data.synth import (make_classification, make_correlated_design,
                              make_multitask)


@pytest.fixture(scope="session")
def lasso_data():
    X, y, beta_true = make_correlated_design(n=200, p=400, n_nonzero=15,
                                             rho=0.5, snr=5.0, seed=0)
    return jax.numpy.asarray(X), jax.numpy.asarray(y), beta_true


@pytest.fixture(scope="session")
def big_lasso_data():
    X, y, beta_true = make_correlated_design(n=400, p=1500, n_nonzero=40,
                                             rho=0.6, snr=5.0, seed=1)
    return jax.numpy.asarray(X), jax.numpy.asarray(y), beta_true


@pytest.fixture(scope="session")
def logreg_data():
    X, y, beta_true = make_classification(n=250, p=500, n_nonzero=20, seed=0)
    return jax.numpy.asarray(X), jax.numpy.asarray(y), beta_true


@pytest.fixture(scope="session")
def multitask_data():
    X, Y, W = make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12, seed=0)
    return jax.numpy.asarray(X), jax.numpy.asarray(Y), W


def rng(seed=0):
    return np.random.default_rng(seed)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs a CUDA card (the port's kernels); skips "
        "with a reason where there is none")
