"""The CSC sums in a fixed order on the CPU: K5r's plain version
(``kernels/csc_score.py: csc_row_sum_plain`` over ``row_order``, the
route ``CSCDesign.matvec`` and ``update_xb`` take on a card) and the walk
``lambda_max`` takes (``CSCDesign.score_walk``), against the present
``index_add_`` results (within 1e-14 relative; on the CPU they are the
same adds, bit for bit) and, through ``lambda_max`` and a screened path
with the ordered route forced, against the reference's jax backend on the
same sparse data at its sparse tolerance, 1e-8."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.data.synth import make_sparse_design
from repro_torch.convert import from_reference
import repro_torch.core as tc
from repro_torch.kernels import ops
from repro_torch.kernels.csc_score import csc_row_sum_plain, row_order
from repro_torch.sparse import CSCDesign
from repro_torch.sparse.ops import csc_incremental_xb, csc_matvec


def _rel(a, b):
    return float(torch.max(torch.abs(a - b)) /
                 max(float(torch.max(torch.abs(b))), 1e-300))


def _design(seed=0, n=300, p=900):
    X, y, _ = make_sparse_design(n=n, p=p, density=1e-2, n_nonzero=20,
                                 seed=seed)
    return X, y, CSCDesign.from_scipy(X, device="cpu")


@pytest.mark.parametrize("zeros_out", [False, True], ids=["all", "nz"])
@pytest.mark.parametrize("T", [None, 1, 4])
def test_ordered_matvec_equals_index_add(T, zeros_out):
    """X @ beta as row sums over ``row_order`` of the design's entries,
    the padding included or, as the design orders them, its zeros left
    out: equal to ``index_add_``'s and within 1e-14 of scipy's product."""
    X, _, d = _design()
    rng = np.random.default_rng(1)
    shape = (d.width,) if T is None else (d.width, T)
    beta = torch.as_tensor(rng.standard_normal(shape))
    order, ptr = row_order(d.indices, d.n_rows,
                           d.data if zeros_out else None)
    assert order.dtype == torch.int32 and ptr.dtype == torch.int64
    assert int(ptr[-1]) == (d.nnz if zeros_out else d.capacity)
    got = ops.csc_row_sum(d.data, order, d.col_ids, ptr, beta)
    want = csc_matvec(d.data, d.indices, d.col_ids, beta, d.n_rows)
    assert torch.equal(got, want)
    ref = torch.as_tensor(X @ beta.numpy())
    assert _rel(got, ref) <= 1e-14


@pytest.mark.parametrize("zeros_out", [False, True], ids=["all", "nz"])
@pytest.mark.parametrize("K,T", [(1, None), (64, None), (64, 3), (300, 2)])
def test_ordered_update_xb_equals_index_add(K, T, zeros_out):
    """Xb + X_ws delta over the working set's windows sorted by row
    (``kdiv``: the window's slot): equal to ``index_add_``'s and within
    1e-14 of the dense product."""
    X, _, d = _design(seed=2)
    rng = np.random.default_rng(K)
    ws = torch.as_tensor(rng.choice(d.width, K, replace=False))
    Xt_ws, (rows, vals) = d.gather_ws(ws)
    tail = () if T is None else (T,)
    delta = torch.as_tensor(rng.standard_normal((K,) + tail))
    Xb = torch.as_tensor(rng.standard_normal((d.n_rows,) + tail))
    order, ptr = row_order(rows, d.n_rows, vals if zeros_out else None)
    got = ops.csc_row_sum(vals.reshape(-1), order, None, ptr, delta,
                          kdiv=rows.shape[1], base=Xb)
    want = csc_incremental_xb(Xb, rows, vals, delta)
    assert torch.equal(got, want)
    dense = Xb + (Xt_ws.T @ delta)
    assert _rel(got, dense) <= 1e-14
    assert torch.equal(csc_row_sum_plain(vals.reshape(-1), order, None, ptr,
                                         delta, kdiv=rows.shape[1], base=Xb),
                       got)


def test_row_order_is_stable_and_bounds_each_row():
    """Each row's run lists its entries in their first order, and ptr
    bounds the runs (an empty row has an empty run); entries of value 0.0
    leave the runs."""
    rows = torch.tensor([3, 0, 3, 1, 0, 3, 1], dtype=torch.int32)
    order, ptr = row_order(rows, 5)
    assert order.tolist() == [1, 4, 3, 6, 0, 2, 5]
    assert ptr.tolist() == [0, 2, 4, 4, 7, 7]
    # zero values leave the runs (sorted past the last row)
    vals = torch.tensor([1.0, 0.0, 2.0, 3.0, 4.0, 0.0, 5.0])
    order, ptr = row_order(rows, 5, vals)
    assert order.tolist()[:5] == [4, 3, 6, 0, 2]
    assert ptr.tolist() == [0, 1, 3, 3, 5, 5]


@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
@pytest.mark.parametrize("multitask", [False, True], ids=["T1", "T3"])
def test_lambda_max_walk_matches_jax(weighted, multitask):
    """``lambda_max`` on a CSC design (``score_walk``, with or without the
    ELL flag) against the reference's on the same sparse data."""
    X, y, _ = make_sparse_design(n=300, p=900, density=1e-2, n_nonzero=20,
                                 seed=4)
    w = np.random.default_rng(3).uniform(0.5, 1.5, 300) if weighted \
        else None
    if multitask:
        y = np.stack([y, 0.5 * y + 0.1, -y], axis=1)
        df, jdf = tc.MultitaskQuadratic(), jc.MultitaskQuadratic()
    else:
        df, jdf = tc.Quadratic(), jc.Quadratic()
    ref = float(jc.lambda_max(X, jnp.asarray(y), jdf, sample_weight=w))
    for ell in (False, True):
        d = CSCDesign.from_scipy(X, ell=ell, device="cpu")
        got = tc.lambda_max(d, y, df, sample_weight=w, device="cpu")
        assert abs(got - ref) <= 1e-8 * ref
        if not multitask:
            raw = torch.as_tensor(y) / 300 * (1 if w is None else
                                              torch.as_tensor(w))
            assert torch.equal(d.score_walk(raw), d.score(raw))


def test_screened_path_on_the_ordered_route_matches_jax(monkeypatch):
    """A gap-safe screened Lasso path on a CSC design with the card's
    route forced (K5r's plain row sums for ``matvec`` and ``update_xb``)
    equals the CPU route's bit for bit and the reference's path within
    1e-8."""
    X, y, _ = make_sparse_design(n=400, p=1200, density=5e-3, n_nonzero=30,
                                 seed=0)
    kw = dict(n_lambdas=5, lambda_min_ratio=0.05, tol=1e-9)
    ref = jc.reg_path(X, jnp.asarray(y), jc.L1(1.0), jc.Quadratic(),
                      engine=jc.make_engine(jc.L1(1.0), jc.Quadratic()),
                      **kw)
    base = tc.reg_path(CSCDesign.from_scipy(X, device="cpu"), y,
                       from_reference(jc.L1(1.0)), screen="gap_safe",
                       device="cpu", **kw)
    calls = []
    real = ops.csc_row_sum

    def spy(*a, **k):
        calls.append(1)
        return real(*a, **k)
    monkeypatch.setattr(CSCDesign, "ordered_sums", property(lambda s: True))
    monkeypatch.setattr(ops, "csc_row_sum", spy)
    res = tc.reg_path(CSCDesign.from_scipy(X, device="cpu"), y,
                      from_reference(jc.L1(1.0)), screen="gap_safe",
                      device="cpu", **kw)
    assert calls
    np.testing.assert_array_equal(res.betas, base.betas)
    np.testing.assert_allclose(res.betas, np.asarray(ref.betas), atol=1e-8)
    assert np.all(res.kkts <= kw["tol"])
