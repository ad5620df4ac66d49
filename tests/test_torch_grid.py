"""The port's CV grid and CV estimators on the CPU, against the JAX
package's jax backend.

The same seeded numpy data go through ``repro.core.cross_val_path`` and
the CV estimators (jax backend, as the reference's own green tests in
``tests/test_cv_grid.py`` run them) and through their ports on
``device="cpu"``. Bounds, as the reference's tests set them: betas within
1e-6 and cv_loss within 1e-10 (``test_cv_grid.py:99`` holds cv_mean to
1e-10 at tol 1e-11; the parity cases run at tol 1e-12 so that two solvers
meeting their tolerance agree that far), the lambdas, best index and fold
weights equal, every kkt at or below tol; a fold lane against the
row-subset sequential path below 1e-8 at tol 1e-11 (``:88``); CSC against
dense cv_mean within 1e-10; the estimators' alpha_ equal and coef_ within
1e-6.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp

import repro.core as jc
from repro.data.folds import bootstrap_weights
from repro.data.synth import make_classification, make_correlated_design
from repro.sparse import CSCDesign as JCSCDesign
import repro_torch.core as tc
from repro_torch.sparse import CSCDesign


def _dense(seed=0):
    return make_correlated_design(n=200, p=400, n_nonzero=15, rho=0.5,
                                  seed=seed)[:2]


def _small():
    """A smaller dense problem for the parity cases run at tol 1e-12."""
    return make_correlated_design(n=90, p=120, n_nonzero=8, rho=0.5,
                                  seed=3)[:2]


def _csc():
    rng = np.random.default_rng(2)
    Xs = sp.random(150, 256, density=0.08, random_state=2, format="csc")
    beta = np.zeros(256)
    beta[:10] = rng.standard_normal(10)
    y = np.asarray(Xs @ beta) + 0.1 * rng.standard_normal(150)
    return Xs, y


def _logistic():
    return make_classification(n=150, p=120, n_nonzero=10, seed=1)[:2]


# name -> (data, datafit, grid keywords); every case at tol 1e-12 unless
# it names its own
GRID_CASES = {
    "dense": ("dense", "quadratic", dict(n_lambdas=6, cv=3, vmap_chunk=3)),
    "csc-design": ("csc-design", "quadratic",
                   dict(n_lambdas=5, cv=3, vmap_chunk=5,
                        lambda_min_ratio=0.05)),
    "scipy": ("scipy", "quadratic", dict(n_lambdas=5, cv=3, vmap_chunk=2,
                                         lambda_min_ratio=0.05)),
    "sample-weight": ("dense", "quadratic",
                      dict(n_lambdas=5, cv=4, vmap_chunk=2,
                           lambda_min_ratio=0.05, sample_weight="uniform")),
    "bootstrap": ("dense", "quadratic",
                  dict(n_lambdas=4, vmap_chunk=4, lambda_min_ratio=0.05,
                       fold_weights="bootstrap")),
    "logistic": ("logistic", "logistic",
                 dict(n_lambdas=5, cv=3, lambda_min_ratio=0.05,
                      vmap_chunk=5)),
    # 7 lambdas on chunks of 3: the last round leaves dead slots
    "dead-slots": ("dense", "quadratic",
                   dict(n_lambdas=7, cv=2, vmap_chunk=3, sync_every=2,
                        lambda_min_ratio=0.05)),
}


def _grid_args(data, kw):
    """(reference X, port X, y, keywords of both) of a case."""
    kw = dict(kw)
    if data == "dense":
        X, y = _small()
        jX, tX = jnp.asarray(X), X
    elif data == "logistic":
        X, y = _logistic()
        jX, tX = jnp.asarray(X), X
    else:
        X, y = _csc()
        jX = JCSCDesign.from_scipy(X) if data == "csc-design" else X
        tX = CSCDesign.from_scipy(X, device="cpu") if data == "csc-design" \
            else X
    if kw.get("sample_weight") == "uniform":
        kw["sample_weight"] = np.random.default_rng(0).uniform(0.5, 2.0,
                                                               len(y))
    if kw.get("fold_weights") == "bootstrap":
        kw["fold_weights"] = bootstrap_weights(len(y), 4, seed=0)
    kw.setdefault("tol", 1e-12)
    return jX, tX, y, kw


def _grid_from_reference(jX, y, jdf, kw):
    """`kw` with the grid of `lambdas` made from the reference's
    lambda_max (the port's, a reduction in another order, can differ from
    it in the last bit: ``test_grid_lambdas_follow_lambda_max``)."""
    kw = dict(kw)
    lmax = float(jc.lambda_max(jX, jnp.asarray(y), jdf,
                               sample_weight=kw.get("sample_weight")))
    kw["lambdas"] = lmax * np.geomspace(1.0, kw.pop("lambda_min_ratio", 1e-2),
                                        kw.pop("n_lambdas"))
    return kw


@pytest.mark.parametrize("case", sorted(GRID_CASES))
def test_cross_val_path_matches_reference(case):
    data, df, kw = GRID_CASES[case]
    jX, tX, y, kw = _grid_args(data, kw)
    jdf, tdf = (jc.Quadratic(), tc.Quadratic()) if df == "quadratic" \
        else (jc.Logistic(), tc.Logistic())
    kw = _grid_from_reference(jX, y, jdf, kw)
    ref = jc.cross_val_path(jX, jnp.asarray(y), jdf, jc.L1(1.0), **kw)
    got = tc.cross_val_path(tX, y, tdf, tc.L1(1.0), device="cpu", **kw)
    np.testing.assert_array_equal(got.lambdas, ref.lambdas)
    np.testing.assert_array_equal(got.fold_weights, ref.fold_weights)
    assert got.betas.shape == ref.betas.shape
    assert np.max(np.abs(got.betas - ref.betas)) < 1e-6
    assert np.max(np.abs(got.cv_loss - ref.cv_loss)) < 1e-10
    assert got.best_index == ref.best_index
    assert np.max(got.kkts) <= kw["tol"]
    # one read a dispatch on the CPU, a dispatch a scheduler round
    assert got.n_host_syncs == got.n_dispatches == got.n_rounds
    assert got.n_dispatches <= got.n_outer


@pytest.mark.parametrize("data", ["dense", "scipy", "logistic"])
def test_grid_lambdas_follow_lambda_max(data):
    """Without a grid, cross_val_path's lambdas are the reference's to the
    last bit or two (lambda_max is a reduction in another order)."""
    jX, tX, y, _ = _grid_args(data, {})
    jdf, tdf = (jc.Logistic(), tc.Logistic()) if data == "logistic" \
        else (jc.Quadratic(), tc.Quadratic())
    want = float(jc.lambda_max(jX, jnp.asarray(y), jdf)) * \
        np.geomspace(1.0, 1e-2, 30)
    got = tc.cross_val_path(tX, y, tdf, tc.L1(1.0), n_lambdas=30, cv=2,
                            vmap_chunk=15, tol=1e-6, max_outer=1,
                            device="cpu")
    np.testing.assert_allclose(got.lambdas, want, rtol=1e-15, atol=0)


def test_cross_val_path_kernel_route_matches_plain():
    """The kernel route's engine logic (the lane kernels' plain versions)
    against the plain route, dense and CSC."""
    for data in ("dense", "csc-design"):
        _, tX, y, kw = _grid_args(data, dict(n_lambdas=3, cv=2,
                                             vmap_chunk=2, tol=1e-10,
                                             lambda_min_ratio=0.1))
        if data == "csc-design":
            # the kernel route takes a CSCDesign with the ELL flag
            tX = CSCDesign.from_scipy(_csc()[0], ell=True, device="cpu")
        a = tc.cross_val_path(tX, y, device="cpu", use_kernels=True, **kw)
        b = tc.cross_val_path(tX, y, device="cpu", **kw)
        assert np.max(np.abs(a.betas - b.betas)) < 1e-8
        assert np.max(a.kkts) <= 1e-10


def test_grid_folds_match_row_subset_paths():
    """Each fold lane equals the sequential warm-started path on that
    fold's row subset, < 1e-8 at tol 1e-11 (``test_cv_grid.py:88``)."""
    X, y = _dense()
    lams = tc.lambda_max(X, y, device="cpu") * np.geomspace(1.0, 0.05, 8)
    g = tc.cross_val_path(X, y, tc.Quadratic(), tc.L1(1.0), lambdas=lams,
                          cv=3, tol=1e-11, vmap_chunk=4, seed=0,
                          device="cpu")
    assert g.betas.shape == (3, 8, X.shape[1])
    for f in range(3):
        keep = g.fold_weights[f] > 0
        sub = tc.reg_path(X[keep], y[keep], tc.L1(1.0), tc.Quadratic(),
                          lambdas=lams, tol=1e-11, device="cpu")
        assert np.max(np.abs(sub.betas - g.betas[f])) < 1e-8, f


def test_grid_csc_matches_dense():
    Xs, y = _csc()
    lams = tc.lambda_max(CSCDesign.from_scipy(Xs, device="cpu"), y,
                         device="cpu") * np.geomspace(1.0, 0.1, 5)
    kw = dict(lambdas=lams, cv=3, tol=1e-11, vmap_chunk=5, seed=0,
              device="cpu")
    gs = tc.cross_val_path(Xs, y, tc.Quadratic(), tc.L1(1.0), **kw)
    gd = tc.cross_val_path(Xs.toarray(), y, tc.Quadratic(), tc.L1(1.0), **kw)
    assert np.max(np.abs(gs.betas - gd.betas)) < 1e-8
    np.testing.assert_allclose(gs.cv_mean, gd.cv_mean, atol=1e-10)


def test_grid_heldout_scores_match_host():
    X, y = _small()
    g = tc.cross_val_path(X, y, tc.Quadratic(), tc.L1(1.0), n_lambdas=5,
                          cv=3, tol=1e-9, vmap_chunk=5, seed=0, device="cpu")
    for f in range(3):
        held = g.fold_weights[f] == 0
        for i in range(5):
            resid = y[held] - X[held] @ g.betas[f, i]
            assert np.isclose(g.cv_loss[f, i], 0.5 * np.mean(resid ** 2),
                              atol=1e-10)


def test_cv_grid_budget_5x30():
    """``test_cv_grid.py:161`` on the port's plain route: a 5-fold x
    30-lambda grid on 50 lanes, one read a dispatch and no more
    dispatches than outer steps, an interior CV minimum."""
    X, y = make_correlated_design(n=200, p=400, n_nonzero=15, seed=1)[:2]
    eng = tc.make_engine(tc.L1(1.0), tc.Quadratic(), device="cpu")
    g = tc.cross_val_path(X, y, tc.Quadratic(), tc.L1(1.0), n_lambdas=30,
                          cv=5, tol=1e-8, vmap_chunk=10, engine=eng)
    assert g.betas.shape == (5, 30, 400)
    assert np.max(g.kkts) <= 1e-8
    assert g.n_outer > 0
    assert g.n_dispatches <= g.n_outer
    assert g.n_host_syncs == g.n_dispatches
    assert 0 < g.best_index < 29
    # the lane pool stays full until the queue drains
    assert g.occupancy[0] == 1.0 and np.all(g.occupancy > 0)


def test_grid_progress_events():
    X, y = _small()
    events = []
    g = tc.cross_val_path(X, y, n_lambdas=4, cv=2, tol=1e-8, vmap_chunk=2,
                          device="cpu", progress=events.append)
    bucket = [e for e in events if e["event"] == "bucket"]
    assert len(bucket) == g.n_rounds
    assert any(e["event"] == "chunk" for e in events)
    assert events[-1]["lambdas_done"] == 4


def test_grid_entry_errors_match_reference():
    """``test_cv_grid.py:200``: the reference's messages, word for word."""
    X, y = _dense()
    n = X.shape[0]
    calls = [dict(fold_weights=np.ones((2, 7))),
             dict(fold_weights=np.vstack([np.ones(n), np.zeros(n)])),
             dict(fold_weights=np.ones((2, n))),
             dict(fold_weights=-np.ones((2, n))),
             dict(lambdas=[0.1, -0.2])]
    for kw in calls:
        with pytest.raises(ValueError) as a:
            tc.cross_val_path(X, y, tc.Quadratic(), tc.L1(1.0), n_lambdas=3,
                              device="cpu", **kw)
        with pytest.raises(ValueError) as b:
            jc.cross_val_path(jnp.asarray(X), jnp.asarray(y), jc.Quadratic(),
                              jc.L1(1.0), n_lambdas=3, **kw)
        assert str(a.value) == str(b.value), kw
    with pytest.raises(ValueError, match="kwargs"):
        tc.cross_val_path(X, y, tc.Quadratic(), tc.L1(1.0), n_lambdas=3,
                          device="cpu", beta0=np.zeros(400))


# -------------------------------------------------------------- estimators
def test_information_criterion_matches_reference():
    for crit in ("aic", "bic", "ebic"):
        for tdf, jdf in ((tc.Quadratic(), jc.Quadratic()),
                         (tc.Logistic(), jc.Logistic())):
            a = tc.information_criterion(crit, tdf, [0.5, 0.25, 0.3], 100, 50,
                                         [3, 10, 4], ebic_gamma=0.3)
            b = jc.information_criterion(crit, jdf, [0.5, 0.25, 0.3], 100, 50,
                                         [3, 10, 4], ebic_gamma=0.3)
            np.testing.assert_array_equal(a, b)
    expect = 100 * np.log([1.0, 0.5]) + np.log(100) * np.array([3, 10])
    np.testing.assert_allclose(
        tc.information_criterion("bic", tc.Quadratic(), [0.5, 0.25], 100, 50,
                                 [3, 10]), expect)
    with pytest.raises(ValueError, match="criterion"):
        tc.information_criterion("nope", tc.Quadratic(), [0.5], 10, 5, [1])


# name -> (estimator, data, constructor keywords)
EST_CASES = {
    "lasso-cv": ("LassoCV", "dense", dict(n_alphas=6, cv=3, vmap_chunk=3)),
    "lasso-bic": ("LassoCV", "dense", dict(n_alphas=6, criterion="bic")),
    "lasso-aic-sparse": ("LassoCV", "scipy",
                         dict(n_alphas=5, criterion="aic")),
    "lasso-cv-sparse": ("LassoCV", "scipy",
                        dict(n_alphas=5, cv=3, vmap_chunk=5)),
    "mcp-cv": ("MCPRegressionCV", "dense",
               dict(n_alphas=4, cv=3, vmap_chunk=4)),
    "mcp-ebic": ("MCPRegressionCV", "dense",
                 dict(n_alphas=5, criterion="ebic")),
    "logreg-cv": ("SparseLogisticRegressionCV", "logistic",
                  dict(n_alphas=5, cv=3, eps=0.05, vmap_chunk=5)),
    "logreg-bic-sparse": ("SparseLogisticRegressionCV", "logistic-sparse",
                          dict(n_alphas=5, eps=0.05, criterion="bic")),
}


def _alphas(jX, y, datafit, kw, sample_weight=None):
    """`kw` with the estimators' grid made from the reference's lambda_max
    (see ``_grid_from_reference``), so both select on one grid."""
    kw = dict(kw)
    lmax = float(jc.lambda_max(jX, jnp.asarray(y), datafit,
                               sample_weight=sample_weight))
    kw["alphas"] = lmax * np.geomspace(1.0, kw.pop("eps", 1e-2),
                                       kw.pop("n_alphas"))
    return kw


@pytest.mark.parametrize("case", sorted(EST_CASES))
def test_cv_estimators_match_reference(case):
    name, data, kw = EST_CASES[case]
    n_alphas = kw["n_alphas"]
    if data == "dense":
        X, y = _small()
    elif data == "scipy":
        X, y = _csc()
    else:
        X, y = _logistic()
        if data == "logistic-sparse":
            X = sp.csc_matrix(X)
    jX = X if sp.issparse(X) else jnp.asarray(X)
    tol = 1e-10
    kw = _alphas(jX, y, jc.Logistic() if "logistic" in data
                 else jc.Quadratic(), kw)
    ref = getattr(jc, name)(tol=tol, **kw).fit(jX, jnp.asarray(y))
    got = getattr(tc, name)(tol=tol, device="cpu", **kw).fit(X, y)
    np.testing.assert_array_equal(got.alphas_, ref.alphas_)
    assert got.alpha_ == ref.alpha_
    np.testing.assert_allclose(got.coef_, np.asarray(ref.coef_), atol=1e-6)
    if kw.get("criterion", "cv") == "cv":
        assert got.cv_loss_.shape == (3, n_alphas)
    else:
        np.testing.assert_allclose(got.criterion_path_, ref.criterion_path_,
                                   rtol=1e-6, atol=1e-6)


def test_lasso_cv_sample_weight_and_intercept():
    X, y = _small()
    sw = np.random.default_rng(0).uniform(0.5, 2.0, X.shape[0])
    Xc = X - (sw @ X) / sw.sum()
    yc = y - (sw @ y) / sw.sum()
    kw = _alphas(jnp.asarray(Xc), yc, jc.Quadratic(),
                 dict(n_alphas=5, cv=3, tol=1e-10, vmap_chunk=5,
                      fit_intercept=True), sample_weight=sw)
    ref = jc.LassoCV(**kw).fit(jnp.asarray(X), jnp.asarray(y + 3.0),
                               sample_weight=sw)
    got = tc.LassoCV(device="cpu", **kw).fit(X, y + 3.0, sample_weight=sw)
    assert got.alpha_ == ref.alpha_
    np.testing.assert_allclose(got.coef_, np.asarray(ref.coef_), atol=1e-6)
    assert abs(got.intercept_ - float(ref.intercept_)) < 1e-6
    assert got.mse_path_.shape == (3, 5)


def test_cv_estimator_errors_match_reference():
    for kw in (dict(criterion="nope"), dict(criterion="bic", checkpoint=1),
               dict(use_ws=False)):
        with pytest.raises(ValueError) as a:
            tc.LassoCV(**kw)
        with pytest.raises(ValueError) as b:
            jc.LassoCV(**kw)
        assert str(a.value) == str(b.value), kw


# ------------------------------------------------------- not yet ported
@pytest.mark.parametrize("call,later", [
    (lambda X, y: tc.cross_val_path(X, y, device="cpu", checkpoint=object()),
     "checkpoint/ slice"),
    (lambda X, y: tc.cross_val_path(X, y, device="cpu", resume="dir"),
     "checkpoint/ slice"),
    (lambda X, y: tc.cross_val_path(X, y, device="cpu", obs=object()),
     "obs/ slice"),
    (lambda X, y: tc.cross_val_path(X, y, device="cpu", mesh=object()),
     "mesh slice"),
    (lambda X, y: tc.LassoCV(checkpoint=object()), "checkpoint/ slice"),
], ids=["checkpoint", "resume", "obs", "mesh", "estimator-checkpoint"])
def test_not_yet_ported_options_raise(call, later):
    X, y = _dense()
    with pytest.raises(NotImplementedError, match=later):
        call(X[:40, :30], y[:40])
