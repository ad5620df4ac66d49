"""The port's solve path on the CPU against the JAX package's jax backend.

Same seeded numpy data and the same problem through ``repro.core.solve``
(``use_kernels=False``: the reference Pallas kernels do not run on this
JAX version) and ``repro_torch.core.solve(device="cpu")`` on both routes:
``use_kernels=False`` (plain torch) and ``use_kernels=True`` (the kernel
route's engine logic, with the kernels' plain versions on CPU tensors).
Tolerance: 1e-6 absolute on beta at tol 1e-10, the bound of the
reference's kernel-vs-jax test (``tests/test_engine.py``).
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.data.synth import make_classification, make_correlated_design
import repro_torch.core as tc
from repro_torch.convert import from_reference, load_fitted, warm_start

KERNEL_CASES = [
    (jc.Quadratic(), jc.L1(1.0)),
    (jc.Quadratic(), jc.L1L2(1.0, 0.6)),
    (jc.Quadratic(), jc.MCP(1.0, 3.0)),
    (jc.Quadratic(), jc.SCAD(1.0, 3.7)),
    (jc.Quadratic(), jc.L05(1.0)),
    (jc.Quadratic(), jc.L23(1.0)),
    (jc.Logistic(), jc.L1(1.0)),
    (jc.Logistic(), jc.MCP(1.0, 3.0)),
]
KERNEL_IDS = [f"{type(d).__name__}-{type(p).__name__}"
              for d, p in KERNEL_CASES]
KW = dict(tol=1e-10, max_outer=80)


def _data(logistic):
    if logistic:
        return make_classification(n=120, p=240, n_nonzero=10, seed=0)[:2]
    return make_correlated_design(n=120, p=240, n_nonzero=10, seed=0)[:2]


@functools.lru_cache(maxsize=None)
def _reference(case):
    """(X, y, penalty, JAX beta) of KERNEL_CASES[case], solved once."""
    datafit, penalty = KERNEL_CASES[case]
    logistic = isinstance(datafit, jc.Logistic)
    X, y = _data(logistic)
    frac = 3 if logistic else 8
    lam = jc.lambda_max(jnp.asarray(X), jnp.asarray(y), datafit) / frac
    penalty = dataclasses.replace(penalty, lam=lam)
    res = jc.solve(jnp.asarray(X), jnp.asarray(y), datafit, penalty, **KW)
    assert res.converged
    return X, y, penalty, np.asarray(res.beta)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain",
                                                            "kernels"])
@pytest.mark.parametrize("case", range(len(KERNEL_CASES)), ids=KERNEL_IDS)
def test_solve_matches_jax(case, use_kernels):
    X, y, penalty, beta_j = _reference(case)
    datafit = KERNEL_CASES[case][0]
    res = tc.solve(X, y, from_reference(datafit), from_reference(penalty),
                   device="cpu", use_kernels=use_kernels, **KW)
    assert res.converged
    np.testing.assert_allclose(res.beta.numpy(), beta_j, atol=1e-6)
    # one read per outer step, as the reference (tests/test_engine.py)
    assert res.n_host_syncs == len(res.kkt_history)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain",
                                                            "kernels"])
def test_svc_dual_matches_jax(logreg_data, use_kernels):
    X, y, _ = logreg_data
    X, y = np.asarray(X)[:80, :60], np.asarray(y)[:80]
    res_j, w_j = jc.svc_dual(jnp.asarray(X), jnp.asarray(y), C=1.0,
                             tol=1e-10)
    res_t, w_t = tc.svc_dual(X, y, C=1.0, tol=1e-10, device="cpu",
                             use_kernels=use_kernels)
    assert res_j.converged and res_t.converged
    np.testing.assert_allclose(res_t.beta.numpy(), np.asarray(res_j.beta),
                               atol=1e-6)
    np.testing.assert_allclose(w_t.numpy(), np.asarray(w_j), atol=1e-6)


def test_max_outer_zero_gives_inf_kkt():
    X, y = _data(False)
    res = tc.solve(X, y, tc.Quadratic(), tc.L1(0.1), device="cpu",
                   max_outer=0)
    assert res.n_outer == 0 and not res.converged
    assert res.kkt == float("inf") and res.n_host_syncs == 0


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain",
                                                            "kernels"])
@pytest.mark.parametrize("logistic", [False, True], ids=["quad", "logistic"])
def test_sample_weight_matches_jax(logistic, use_kernels):
    X, y = _data(logistic)
    w = np.random.default_rng(4).random(X.shape[0]) * 2.0
    w[:10] = 0.0
    jd = jc.Logistic() if logistic else jc.Quadratic()
    lam = jc.lambda_max(jnp.asarray(X), jnp.asarray(y), jd,
                        sample_weight=w) / 4
    res_j = jc.solve(jnp.asarray(X), jnp.asarray(y), jd, jc.L1(lam),
                     sample_weight=w, **KW)
    lam_t = tc.lambda_max(X, y, from_reference(jd), sample_weight=w,
                          device="cpu")
    np.testing.assert_allclose(lam_t, lam * 4, rtol=1e-12)
    res_t = tc.solve(X, y, from_reference(jd), tc.L1(lam), sample_weight=w,
                     device="cpu", use_kernels=use_kernels, **KW)
    assert res_t.converged
    np.testing.assert_allclose(res_t.beta.numpy(), np.asarray(res_j.beta),
                               atol=1e-6)


ESTIMATORS = [
    ("Lasso", dict(alpha=0.05), dict(fit_intercept=True)),
    ("ElasticNet", dict(alpha=0.05, l1_ratio=0.7), {}),
    ("MCPRegression", dict(alpha=0.08, gamma=3.0), {}),
    ("SCADRegression", dict(alpha=0.08, gamma=3.7), {}),
    ("SparseLogisticRegression", dict(alpha=0.03), {}),
    ("LinearSVC", dict(C=0.5), {}),
]


@pytest.mark.parametrize("name,hyper,extra", ESTIMATORS,
                         ids=[e[0] for e in ESTIMATORS])
def test_estimators_match_jax(name, hyper, extra):
    classify = name in ("SparseLogisticRegression", "LinearSVC")
    X, y = _data(classify)
    if name == "LinearSVC":
        X = X[:80, :60]
        y = y[:80]
    kw = dict(tol=1e-10, max_outer=80, **extra)
    est_j = getattr(jc, name)(**hyper, **kw).fit(jnp.asarray(X),
                                                 jnp.asarray(y))
    est_t = getattr(tc, name)(**hyper, **kw).fit(X, y, device="cpu")
    assert est_t.converged_
    np.testing.assert_allclose(est_t.coef_, est_j.coef_, atol=1e-6)
    np.testing.assert_allclose(est_t.intercept_, est_j.intercept_, atol=1e-6)
    pred_j, pred_t = np.asarray(est_j.predict(X)), est_t.predict(X)
    if classify:
        assert np.mean(pred_t == pred_j) >= 0.98
    else:
        np.testing.assert_allclose(pred_t, pred_j, atol=1e-5)


def test_weighted_intercept_fit_matches_jax():
    X, y = _data(False)
    w = np.random.default_rng(2).random(X.shape[0]) + 0.5
    est_j = jc.Lasso(alpha=0.05, fit_intercept=True, tol=1e-10).fit(
        jnp.asarray(X), jnp.asarray(y), sample_weight=w)
    est_t = tc.Lasso(alpha=0.05, fit_intercept=True, tol=1e-10).fit(
        X, y, sample_weight=w, device="cpu")
    np.testing.assert_allclose(est_t.coef_, est_j.coef_, atol=1e-6)
    np.testing.assert_allclose(est_t.intercept_, est_j.intercept_, atol=1e-6)


def test_converted_fit_predicts_like_jax():
    """A JAX fit's coef_/intercept_ carried into a port estimator predicts
    the same values to 1e-12."""
    X, y = _data(False)
    est_j = jc.Lasso(alpha=0.05, fit_intercept=True, tol=1e-8).fit(
        jnp.asarray(X), jnp.asarray(y))
    est_t = load_fitted(tc.Lasso(alpha=0.05), est_j.coef_, est_j.intercept_)
    np.testing.assert_allclose(est_t.predict(X),
                               np.asarray(est_j.predict(X)), atol=1e-12,
                               rtol=1e-12)


@pytest.mark.parametrize("use_kernels", [False, True], ids=["plain",
                                                            "kernels"])
def test_jax_warm_start_converges_at_first_outer(use_kernels):
    """A converged JAX beta as the port's beta0: the first outer step's kkt
    already passes tol (one probe read, one head read)."""
    X, y, penalty, beta_j = _reference(2)                  # Quadratic-MCP
    res = tc.solve(X, y, tc.Quadratic(), from_reference(penalty),
                   device="cpu", tol=1e-8, use_kernels=use_kernels,
                   beta0=warm_start(beta_j, device="cpu"))
    assert res.converged and res.n_outer == 0
    assert res.n_host_syncs == 2
    np.testing.assert_array_equal(res.beta.numpy(), beta_j)


def test_entry_rejections():
    X, y = _data(False)
    with pytest.raises(NotImplementedError, match="need a block penalty"):
        tc.solve(X, np.stack([y, y], 1), tc.Quadratic(), tc.L1(0.1),
                 device="cpu")
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tc.solve(X, y, tc.Quadratic(), tc.L1(0.1), device="cpu", obs=object())
    with pytest.raises(NotImplementedError, match="does not support sample"):
        tc.solve(X, y, tc.QuadraticSVC(), tc.Box(1.0), device="cpu",
                 sample_weight=np.ones(X.shape[0]))
    with pytest.raises(ValueError, match="no Xb kernel"):
        @dataclasses.dataclass(frozen=True)
        class Custom(tc.Quadratic):
            pass
        tc.solve(X, y, Custom(), tc.L1(0.1), device="cpu", use_gram=False,
                 use_kernels=True)


def test_float32_input_keeps_its_dtype():
    X, y = _data(False)
    res = tc.solve(X.astype(np.float32), y.astype(np.float32),
                   tc.Quadratic(), tc.L1(0.2), device="cpu", tol=1e-4)
    assert res.beta.dtype == torch.float32 and res.converged
