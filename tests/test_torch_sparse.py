"""The port's sparse design path on the CPU against the JAX package.

Same seeded numpy/scipy inputs through ``repro`` and ``repro_torch``:

* ``make_sparse_design`` bit for bit, and ``CSCDesign`` array for array
  (window padding, index dtypes, column norms, ELL layout);
* every primitive of ``sparse/ops.py`` against its reference at 1e-12;
* the plain versions of K5 / K5s against ``csc_score_pallas`` /
  ``csc_weighted_col_sq_pallas`` in interpret mode, and of K4 against
  ``ws_score_pallas`` in interpret mode, at 1e-12;
* ``solve`` on a CSC design against the reference's jax backend at tol
  1e-9, within 1e-8 on beta (the bound of ``tests/test_sparse.py``), on
  both port routes (``use_kernels`` False/True; on CPU tensors the kernel
  route runs the kernels' plain versions). The reference's own sparse
  Pallas solve does not run on this JAX version (its dense CD kernels
  crash), so it is not the oracle;
* ``lambda_max``, ``Lasso`` and ``LinearSVC`` on sparse input, and the
  entry errors, whose messages must equal the reference's.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as jc
import repro.core.penalties as jpen
from repro.core.engine import PALLAS_SPARSE_ELL_ERROR as J_ELL_ERROR
from repro.data.synth import make_sparse_design as j_make_sparse_design
from repro.kernels.common import penalty_params as j_penalty_params
from repro.kernels.ws_score import ws_score_pallas
from repro.sparse import CSCDesign as JCSCDesign
from repro.sparse import ops as jops
import repro_torch.core as tc
from repro_torch.convert import csc_design_from_reference, from_reference
from repro_torch.core.engine import PALLAS_SPARSE_ELL_ERROR
from repro_torch.data import make_sparse_design
from repro_torch.kernels import ops
from repro_torch.kernels.common import penalty_params
from repro_torch.sparse import CSCDesign
from repro_torch.sparse import ops as tops

CPU = "cpu"
SMALL = dict(n=1000, p=4000, density=5e-3, n_nonzero=40)
J_PENALTIES = [jpen.L1(0.11), jpen.L1L2(0.11, 0.6), jpen.MCP(0.11, 3.0),
               jpen.SCAD(0.11, 3.7), jpen.Box(0.8), jpen.L05(0.05),
               jpen.L23(0.05)]
PEN_IDS = [type(p).__name__ for p in J_PENALTIES]


@functools.lru_cache(maxsize=None)
def _small_design():
    return make_sparse_design(**SMALL)


def _random_csc(kind):
    """scipy fixtures: 'random' as tests/test_sparse.py builds them,
    'edges' with empty columns and one dense column."""
    rng = np.random.default_rng(3)
    X = sp.random(300, 600, density=0.02, random_state=2, format="csc",
                  data_rvs=rng.standard_normal)
    if kind == "edges":
        X = X.tolil()
        X[:, :7] = 0.0
        X[:, 11] = rng.standard_normal((300, 1))
        X = X.tocsc()
        X.eliminate_zeros()
    return X


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _arrays(jd):
    """The reference design's arrays as csc_design_from_reference takes
    them."""
    out = {k: np.asarray(getattr(jd, k)) for k in
           ("data", "indices", "col_ids", "indptr", "col_sq")}
    out.update(shape=jd.shape, max_col_nnz=jd.max_col_nnz,
               rows=None if jd.ell_rows is None else np.asarray(jd.ell_rows),
               vals=None if jd.ell_vals is None else np.asarray(jd.ell_vals))
    return out


# ------------------------------------------------------------------ designs
@pytest.mark.parametrize("kw", [SMALL, dict(n=400, p=1200, density=5e-3,
                                            n_nonzero=30, seed=4)],
                         ids=["1000x4000", "400x1200"])
def test_make_sparse_design_bit_for_bit(kw):
    Xj, yj, bj = j_make_sparse_design(**kw)
    Xt, yt, bt = make_sparse_design(**kw)
    for a, b in ((Xj.data, Xt.data), (Xj.indices, Xt.indices),
                 (Xj.indptr, Xt.indptr), (yj, yt), (bj, bt)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert Xj.shape == Xt.shape


@pytest.mark.parametrize("ell", [False, True], ids=["flat", "ell"])
@pytest.mark.parametrize("src", ["design", "random", "edges", "csr"])
def test_csc_design_matches_reference(src, ell):
    X = _small_design()[0] if src == "design" else \
        _random_csc("edges" if src == "edges" else "random")
    if src == "csr":
        X = X.tocsr()
    jd = JCSCDesign.from_scipy(X.copy(), ell=ell)
    td = CSCDesign.from_scipy(X.copy(), ell=ell, device=CPU)
    for k in ("data", "indices", "col_ids", "indptr", "col_sq"):
        np.testing.assert_array_equal(getattr(td, k).numpy(),
                                      np.asarray(getattr(jd, k)))
    assert td.indices.dtype == torch.int32 and \
        td.col_ids.dtype == torch.int32 and td.indptr.dtype == torch.int64
    assert (td.shape, td.max_col_nnz, td.nnz, td.has_ell) == \
        (jd.shape, jd.max_col_nnz, jd.nnz, jd.has_ell)
    if ell:
        np.testing.assert_array_equal(td.ell_rows.numpy(),
                                      np.asarray(jd.ell_rows))
        np.testing.assert_array_equal(td.ell_vals.numpy(),
                                      np.asarray(jd.ell_vals))
    np.testing.assert_array_equal(td.todense(), X.toarray())


def test_max_col_nnz_error_matches_reference():
    X = _random_csc("random")
    args = (X.data, X.indices, X.indptr, X.shape)
    with pytest.raises(ValueError) as ej:
        JCSCDesign.from_arrays(*args, max_col_nnz=1)
    with pytest.raises(ValueError) as et:
        CSCDesign.from_arrays(*args, max_col_nnz=1, device=CPU)
    assert str(et.value) == str(ej.value)


@pytest.mark.parametrize("ell", [False, True], ids=["flat", "ell"])
def test_csc_design_from_reference(ell):
    X = _random_csc("edges")
    jd = JCSCDesign.from_scipy(X, ell=ell)
    td = csc_design_from_reference(_arrays(jd), device=CPU)
    ref = CSCDesign.from_scipy(X, ell=ell, device=CPU)
    for f in dataclasses.fields(CSCDesign):
        a, b = getattr(td, f.name), getattr(ref, f.name)
        if torch.is_tensor(b):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


# --------------------------------------------------------------- primitives
@pytest.mark.parametrize("src", ["design", "edges"])
def test_sparse_ops_match_reference(src):
    X = _small_design()[0] if src == "design" else _random_csc("edges")
    jd = JCSCDesign.from_scipy(X, ell=True)
    td = CSCDesign.from_scipy(X, ell=True, device=CPU)
    n, p = X.shape
    rng = np.random.default_rng(5)
    raw, w = rng.standard_normal(n), rng.random(n) * 2.0
    raw2, beta = rng.standard_normal((n, 3)), rng.standard_normal(p)
    beta2 = rng.standard_normal((p, 2))
    J = dict(data=jd.data, indices=jd.indices, col_ids=jd.col_ids)
    T = dict(data=td.data, indices=td.indices, col_ids=td.col_ids)

    def close(got, want):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                                   atol=1e-12)

    for r in (raw, raw2):
        close(tops.csc_score(**T, raw=_t(r), p=p),
              jops.csc_score(**J, raw=jnp.asarray(r), p=p))
    close(tops.csc_weighted_col_sq(**T, w=_t(w), p=p),
          jops.csc_weighted_col_sq(**J, w=jnp.asarray(w), p=p))
    close(tops.csc_score_ell(td.ell_rows, td.ell_vals, _t(raw)),
          jops.csc_score_ell(jd.ell_rows, jd.ell_vals, jnp.asarray(raw)))
    for b in (beta, beta2):
        close(tops.csc_matvec(**T, beta=_t(b), n_rows=n),
              jops.csc_matvec(**J, beta=jnp.asarray(b), n_rows=n))
    cols = rng.choice(p, 48, replace=False)
    cols[:3] = [0, 11, p - 1]
    rows_t, vals_t = tops.csc_column_windows(td.data, td.indices, td.indptr,
                                             _t(cols), td.max_col_nnz)
    rows_j, vals_j = jops.csc_column_windows(jd.data, jd.indices, jd.indptr,
                                             jnp.asarray(cols),
                                             jd.max_col_nnz)
    np.testing.assert_array_equal(rows_t.numpy(), np.asarray(rows_j))
    np.testing.assert_array_equal(vals_t.numpy(), np.asarray(vals_j))
    Xws_t = tops.csc_gather_columns(rows_t, vals_t, n)
    np.testing.assert_array_equal(
        Xws_t.numpy(), np.asarray(jops.csc_gather_columns(rows_j, vals_j, n)))
    np.testing.assert_array_equal(Xws_t.numpy(), X.toarray()[:, cols])
    Xb = rng.standard_normal(n)
    for delta in (rng.standard_normal(48), rng.standard_normal((48, 2))):
        xb = Xb if delta.ndim == 1 else rng.standard_normal((n, 2))
        close(tops.csc_incremental_xb(_t(xb), rows_t, vals_t, _t(delta)),
              jops.csc_incremental_xb(jnp.asarray(xb), rows_j, vals_j,
                                      jnp.asarray(delta)))
    # the design's protocol on top of them
    Xt_ws, aux = td.gather_ws(_t(cols))
    assert Xt_ws.is_contiguous() and Xt_ws.shape == (48, n)
    np.testing.assert_array_equal(Xt_ws.numpy(), X.toarray()[:, cols].T)
    close(td.update_xb(_t(Xb), Xt_ws, aux, _t(delta[:, 0])),
          Xb + X.toarray()[:, cols] @ delta[:, 0])


# ------------------------------------------------------ K5 / K5s / K4 plain
@pytest.mark.parametrize("src", ["design", "random", "edges"])
def test_k5_plain_matches_pallas_interpret(src):
    X = _small_design()[0] if src == "design" else _random_csc(src)
    jd = JCSCDesign.from_scipy(X, ell=True)
    td = CSCDesign.from_scipy(X, ell=True, device=CPU)
    rng = np.random.default_rng(6)
    raw, w = rng.standard_normal(X.shape[0]), rng.random(X.shape[0]) + 0.5
    ops.reset_launch_counts()
    args = (td.data, td.indices, td.col_ids, td.indptr)
    got = ops.csc_score(*args, _t(raw))
    want = jops.csc_score_pallas(jd.ell_rows, jd.ell_vals, jnp.asarray(raw),
                                 interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    got = ops.csc_weighted_col_sq(*args, _t(w))
    want = jops.csc_weighted_col_sq_pallas(jd.ell_rows, jd.ell_vals,
                                           jnp.asarray(w), interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)
    # CPU tensors take the plain version: no launch is counted
    assert ops.csc_score.launches == 0
    assert ops.csc_weighted_col_sq.launches == 0


def test_k5_wrappers_reject_bad_input():
    td = CSCDesign.from_scipy(_random_csc("random"), device=CPU)
    raw = torch.zeros(td.n_rows, dtype=torch.float64)
    args = (td.data, td.indices, td.col_ids, td.indptr)
    with pytest.raises(TypeError):
        ops.csc_score(td.data, td.indices.long(), td.col_ids, td.indptr, raw)
    with pytest.raises(TypeError):
        ops.csc_score(*args, raw.float())
    with pytest.raises(ValueError):
        ops.csc_score(*args, raw[:, None])
    with pytest.raises(ValueError):
        ops.csc_weighted_col_sq(td.data[:-1], td.indices, td.col_ids,
                                td.indptr, raw)


@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
@pytest.mark.parametrize("use_fp", [False, True], ids=["sd", "fp"])
@pytest.mark.parametrize("jp", J_PENALTIES, ids=PEN_IDS)
def test_k4_plain_matches_pallas_interpret(jp, use_fp, weighted):
    rng = np.random.default_rng(8)
    n, p = 256, 512                  # divide the reference's bp=256, bn=2048
    X = rng.standard_normal((n, p))
    r = rng.standard_normal(n) / n
    beta = rng.standard_normal(p) * (rng.random(p) < 0.3)
    L = np.sum(X * X, axis=0) / n
    off = rng.standard_normal(p) * 0.01
    w = rng.random(n) * 2.0 if weighted else None
    want = ws_score_pallas(*map(jnp.asarray, (X, r, beta, L, off)), type(jp),
                           j_penalty_params(jp),
                           w=None if w is None else jnp.asarray(w),
                           use_fp=use_fp, interpret=True)
    tp = from_reference(jp)
    got = ops.ws_score(_t(X.T).contiguous(), _t(r), _t(beta), _t(L), _t(off),
                       type(tp), penalty_params(tp),
                       w=None if w is None else _t(w), use_fp=use_fp)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-12,
                               atol=1e-12)


# ------------------------------------------------------------- solve parity
SOLVE_CASES = ["Quadratic-L1", "Quadratic-MCP", "Logistic-L1",
               "weighted-Quadratic-L1"]
KW = dict(tol=1e-9, max_outer=80)


def _logreg_data():
    X = _random_csc("random")
    rng = np.random.default_rng(3)
    bt = np.zeros(X.shape[1])
    bt[rng.choice(X.shape[1], 20, replace=False)] = rng.standard_normal(20)
    probs = 1.0 / (1.0 + np.exp(-(X @ bt)))
    y = np.where(rng.uniform(size=X.shape[0]) < probs, 1.0, -1.0)
    return X, y


@functools.lru_cache(maxsize=None)
def _reference_solve(case):
    """(X, y, datafit, penalty, sample_weight, JAX beta) of a case."""
    if case == "Logistic-L1":
        X, y = _logreg_data()
        datafit, frac, pen = jc.Logistic(), 3, jc.L1
    else:
        X, y, _ = _small_design()
        datafit = jc.Quadratic()
        frac, pen = (5, lambda lam: jc.MCP(lam, 3.0)) if "MCP" in case \
            else (10, jc.L1)
    w = np.random.default_rng(9).random(X.shape[0]) * 2.0 \
        if case.startswith("weighted") else None
    lam = jc.lambda_max(X, jnp.asarray(y), datafit, sample_weight=w) / frac
    penalty = pen(lam)
    res = jc.solve(X, jnp.asarray(y), datafit, penalty, sample_weight=w,
                   use_kernels=False, **KW)
    assert res.converged
    return X, y, datafit, penalty, w, np.asarray(res.beta)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("case", SOLVE_CASES)
def test_sparse_solve_matches_jax(case, use_kernels, monkeypatch):
    X, y, datafit, penalty, w, beta_j = _reference_solve(case)
    calls = {"csc_score": 0, "csc_weighted_col_sq": 0, "fused_ws": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    design = CSCDesign.from_scipy(X, ell=True, device=CPU)
    res = tc.solve(design, y, from_reference(datafit),
                   from_reference(penalty), sample_weight=w, device=CPU,
                   use_kernels=use_kernels, **KW)
    assert res.converged
    np.testing.assert_allclose(res.beta.numpy(), beta_j, atol=1e-8)
    # the kernel route scores every outer head with K5 and never runs K3;
    # the weighted fit takes its Lipschitz constants from K5s once
    heads = len(res.kkt_history)
    assert calls["fused_ws"] == 0
    assert calls["csc_score"] == (heads if use_kernels else 0)
    assert calls["csc_weighted_col_sq"] == \
        (1 if use_kernels and w is not None else 0)


@pytest.mark.parametrize("src", ["design", "logreg"])
def test_lambda_max_sparse(src):
    X, y = (_small_design()[:2] if src == "design" else _logreg_data())
    w = np.random.default_rng(2).random(X.shape[0])
    jd = jc.Logistic() if src == "logreg" else jc.Quadratic()
    for sw in (None, w):
        want = jc.lambda_max(X, jnp.asarray(y), jd, sample_weight=sw)
        got = tc.lambda_max(X, y, from_reference(jd), sample_weight=sw,
                            device=CPU)
        np.testing.assert_allclose(got, want, rtol=1e-12)
        design = CSCDesign.from_scipy(X, device=CPU)
        assert tc.lambda_max(design, y, from_reference(jd), sample_weight=sw,
                             device=CPU) == got


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_lasso_sparse_fit_predict(use_kernels):
    X, y, _ = _small_design()
    lam = jc.lambda_max(X, jnp.asarray(y)) / 10
    ej = jc.Lasso(alpha=lam, tol=1e-10).fit(X, y)
    design = CSCDesign.from_scipy(X, ell=True, device=CPU)
    # a scipy X converts with the ELL flag on the kernel route
    for Xin in (X, design):
        et = tc.Lasso(alpha=lam, tol=1e-10, use_kernels=use_kernels) \
            .fit(Xin, y, device=CPU)
        assert et.converged_
        np.testing.assert_allclose(et.coef_, ej.coef_, atol=1e-8)
        for Xp in (X, design, X.toarray()):
            np.testing.assert_allclose(et.predict(Xp), ej.predict(X),
                                       atol=1e-8)


def test_linear_svc_sparse_fit_predict():
    # every sample holds a nonzero (an empty one pins the dual KKT at 1)
    rng = np.random.default_rng(4)
    X = sp.random(150, 50, density=0.2, random_state=5, format="csc",
                  data_rvs=rng.standard_normal)
    y = np.sign(X @ rng.standard_normal(50) + 0.3 * rng.standard_normal(150))
    ej = jc.LinearSVC(C=1.0, tol=1e-10).fit(X, y)
    et = tc.LinearSVC(C=1.0, tol=1e-10).fit(X, y, device=CPU)
    assert et.converged_
    np.testing.assert_allclose(et.dual_coef_, ej.dual_coef_, atol=1e-6)
    np.testing.assert_allclose(et.coef_, ej.coef_, atol=1e-6)
    np.testing.assert_array_equal(et.predict(X), ej.predict(X))
    assert et.score(X, y) == ej.score(X, y)


def test_linear_svc_sparse_kernel_route(monkeypatch):
    """The dual SVM on a scipy X through the kernel route: the label-signed
    Zt converts with the ELL flag, every outer head is scored by K5 (its
    plain version on the CPU), K3 never runs, and the fit matches the
    reference."""
    rng = np.random.default_rng(4)
    X = sp.random(150, 50, density=0.2, random_state=5, format="csr",
                  data_rvs=rng.standard_normal)
    y = np.sign(X @ rng.standard_normal(50) + 0.3 * rng.standard_normal(150))
    calls = {"csc_score": 0, "fused_ws": 0}
    for name in calls:
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    ej = jc.LinearSVC(C=1.0, tol=1e-10).fit(X, y)
    et = tc.LinearSVC(C=1.0, tol=1e-10, use_kernels=True).fit(X, y,
                                                              device=CPU)
    assert et.converged_
    assert calls == {"csc_score": len(et.result_.kkt_history),
                     "fused_ws": 0}
    np.testing.assert_allclose(et.coef_, ej.coef_, atol=1e-6)
    np.testing.assert_array_equal(et.predict(X), ej.predict(X))


def test_sparse_entry_errors_match_reference():
    X, y, _ = _small_design()
    lam = jc.lambda_max(X, jnp.asarray(y)) / 10
    assert PALLAS_SPARSE_ELL_ERROR == J_ELL_ERROR
    # a kernel solve needs the ELL flag, at entry and in the design: a
    # design built without it raises the reference's text (a scipy X
    # converts with the flag, so it solves)
    td = CSCDesign.from_scipy(X, device=CPU)
    with pytest.raises(NotImplementedError) as e:
        tc.solve(td, y, tc.Quadratic(), tc.L1(lam), device=CPU,
                 use_kernels=True)
    assert str(e.value) == J_ELL_ERROR
    assert tc.solve(X, y, tc.Quadratic(), tc.L1(lam), device=CPU,
                    use_kernels=True, tol=1e-8).converged
    with pytest.raises(NotImplementedError) as e:
        td.score(torch.zeros(X.shape[0], dtype=torch.float64),
                 use_kernels=True)
    assert str(e.value) == J_ELL_ERROR
    # fit_intercept would densify a sparse design
    with pytest.raises(NotImplementedError) as ej:
        jc.Lasso(alpha=lam, fit_intercept=True).fit(X, y)
    for Xin in (X, td):
        with pytest.raises(NotImplementedError) as et:
            tc.Lasso(alpha=lam, fit_intercept=True).fit(Xin, y, device=CPU)
        assert str(et.value) == str(ej.value)
