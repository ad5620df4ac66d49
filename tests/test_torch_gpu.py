"""The port's CUDA kernels K1-K5 on a card, against their plain versions.

Each ``gpu``-marked test launches one CUDA kernel (through the checked,
counted wrapper of ``repro_torch.kernels.ops``) and its plain torch version
on the same float64 inputs on the card. Tolerances are the reference kernel
tests' (``tests/test_kernels.py``): 1e-12 absolute + 1e-5 relative for K1,
1e-11 + 1e-8 for K2; K3's scores within 1e-12 + 1e-11 relative, gradients
within 1e-12 + 1e-10 relative, an identical working set and bit-exact
gathered columns. K4's scores are held as K3's; K5 and K5s within
1e-12 absolute + 1e-12 relative (the plain segment sum adds with atomics on
the card, in another order than the kernel). Without a card they skip: the
CUDA kernels have no CPU or interpret mode.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed::

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import penalties as P
from repro_torch.core.working_set import candidate_columns, select_working_set
from repro_torch.kernels import ops
from repro_torch.kernels.cd_epoch import cd_epoch_gram_plain, cd_epoch_xb_plain
from repro_torch.kernels.common import penalty_params
from repro_torch.kernels.csc_score import csc_score_plain
from repro_torch.kernels.fused_ws import fused_ws_plain
from repro_torch.kernels.ws_score import ws_score_plain

PENALTIES = [P.L1(0.11), P.L1L2(0.11, 0.6), P.MCP(0.11, 3.0),
             P.SCAD(0.11, 3.7), P.Box(0.8), P.L05(0.05), P.L23(0.05)]
IDS = [type(p).__name__ for p in PENALTIES]
XB_CASES = [("quadratic", False), ("quadratic", True), ("logistic", False),
            ("logistic", True), ("svc", False)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the CUDA kernels have no CPU or "
                    "interpret mode")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.as_tensor(np.ascontiguousarray(a, dtype=np.float64),
                            device=dev) for a in arrays]


@pytest.mark.gpu
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_k1_cuda_matches_plain(cuda, pen):
    rng = np.random.default_rng(0)
    K = 256
    X = rng.standard_normal((3 * K, K))
    G = X.T @ X / (3 * K)
    beta0 = rng.standard_normal(K) * 0.1
    G, c, beta0, q0, L = _on(cuda, G, X.T @ rng.standard_normal(3 * K) /
                             (3 * K), beta0, G @ beta0, np.diag(G))
    G = G.t().contiguous().t()                  # column-major, as the engine
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen))
    for epochs in (1, 5):
        n0 = ops.cd_epoch_gram.launches
        bk, qk = ops.cd_epoch_gram(*args, epochs=epochs)
        assert ops.cd_epoch_gram.launches == n0 + 1
        br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
        torch.testing.assert_close(bk, br, atol=1e-12, rtol=1e-5)
        torch.testing.assert_close(qk, qr, atol=1e-12, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("kind,weighted", XB_CASES,
                         ids=[f"{k}-w{int(w)}" for k, w in XB_CASES])
def test_k2_cuda_matches_plain(cuda, kind, weighted):
    rng = np.random.default_rng(1)
    K, n = 128, 3000
    Xt = rng.standard_normal((K, n))
    y = np.sign(rng.standard_normal(n))
    beta0 = rng.standard_normal(K) * 0.05
    L = np.sum(Xt * Xt, axis=1)
    L = L / n if kind == "quadratic" else L / (4 * n) if kind == "logistic" \
        else L
    w = rng.random(n) * 2.0
    off = -np.ones(K) if kind == "svc" else np.zeros(K)
    Xt, y, beta0, Xb0, L, off, w = _on(cuda, Xt, y, beta0, beta0 @ Xt, L,
                                       off, w * (n / w.sum()))
    pen = P.Box(0.9) if kind == "svc" else P.L1(0.07)
    args = (Xt, y, beta0, Xb0, L, off, type(pen), penalty_params(pen), kind)
    wt = w if weighted else None
    bk, xk = ops.cd_epoch_xb(*args, w=wt, epochs=2)
    br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=2)
    torch.testing.assert_close(bk, br, atol=1e-11, rtol=1e-8)
    torch.testing.assert_close(xk, xr, atol=1e-11, rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
@pytest.mark.parametrize("use_fp", [False, True], ids=["sd", "fp"])
def test_k3_cuda_matches_plain(cuda, pen, use_fp):
    rng = np.random.default_rng(3)
    n, p = 500, 5000
    X = rng.standard_normal((n, p))
    beta = rng.standard_normal(p) * (rng.random(p) < 0.3)
    Xt, r, beta, L, off = _on(cuda, X.T, rng.standard_normal(n), beta,
                              np.sum(X * X, axis=0) / n, np.zeros(p))
    gs = pen.generalized_support(beta)
    for ws in (64, 1024):
        args = (Xt, r, beta, L, off, gs, type(pen), penalty_params(pen), ws)
        sk, gk, ik, ck = ops.fused_ws(*args, use_fp=use_fp)
        sr, gr, _, _ = fused_ws_plain(*args, use_fp=use_fp)
        torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
        torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
        ws_k = select_working_set(sk, gs, ws)
        assert torch.equal(ws_k, select_working_set(sr, gs, ws))
        assert torch.equal(candidate_columns(ik, ck, ws_k, p), Xt[ws_k].T)


@pytest.mark.gpu
def test_k3_cuda_exact_ties(cuda):
    """Duplicated integer columns tie exactly: identical scores, the
    lax.top_k lowest-index choice, bit-exact columns."""
    rng = np.random.default_rng(7)
    n, p, ws = 64, 3000, 256
    half = rng.integers(-3, 4, size=(n, p // 2)).astype(np.float64)
    X = np.concatenate([half, half], axis=1)
    beta = np.where(rng.random(p) < 0.02, 1.0, 0.0)
    Xt, r, beta, L, off = _on(cuda, X.T, rng.integers(-2, 3, n), beta,
                              np.maximum(np.sum(X * X, 0) / n, 1e-12),
                              np.zeros(p))
    pen = P.L1(0.5)
    gs = pen.generalized_support(beta)
    args = (Xt, r, beta, L, off, gs, P.L1, penalty_params(pen), ws)
    sk, _, ik, ck = ops.fused_ws(*args)
    sr, _, _, _ = fused_ws_plain(*args)
    assert torch.equal(sk, sr)
    ws_k = select_working_set(sk, gs, ws)
    assert torch.equal(candidate_columns(ik, ck, ws_k, p), Xt[ws_k].T)


@pytest.mark.gpu
def test_solve_on_card_uses_kernels(cuda):
    """A small Lasso on the card: the default route launches K3 and K1 and
    agrees with the plain route to 1e-6."""
    from repro_torch.core import L1, Quadratic, lambda_max, solve
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 400))
    y = X[:, :5].sum(1) + 0.1 * rng.standard_normal(200)
    lam = lambda_max(X, y, device=cuda) / 10
    ops.reset_launch_counts()
    res_k = solve(X, y, Quadratic(), L1(lam), tol=1e-8)
    counts = ops.launch_counts()
    res_p = solve(X, y, Quadratic(), L1(lam), tol=1e-8, use_kernels=False)
    assert counts["fused_ws"] > 0 and counts["cd_epoch_gram"] > 0
    assert res_k.converged and res_p.converged
    torch.testing.assert_close(res_k.beta, res_p.beta, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_k2_cuda_matches_plain_at_n50k(cuda):
    """K2's global-memory branch (Xb, y and w do not fit in shared memory
    at n = 50,000)."""
    rng = np.random.default_rng(2)
    K, n = 64, 50_000
    Xt = rng.standard_normal((K, n))
    y = np.sign(rng.standard_normal(n))
    beta0 = rng.standard_normal(K) * 0.05
    w = rng.random(n) + 0.5
    Xt, y, beta0, Xb0, L, off, w = _on(cuda, Xt, y, beta0, beta0 @ Xt,
                                       np.sum(Xt * Xt, axis=1) / (4 * n),
                                       np.zeros(K), w * (n / w.sum()))
    args = (Xt, y, beta0, Xb0, L, off, P.L1, penalty_params(P.L1(0.002)),
            "logistic")
    for wt in (None, w):
        bk, xk = ops.cd_epoch_xb(*args, w=wt, epochs=2)
        br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=2)
        torch.testing.assert_close(bk, br, atol=1e-11, rtol=1e-8)
        torch.testing.assert_close(xk, xr, atol=1e-11, rtol=1e-8)


@pytest.mark.gpu
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_k4_cuda_matches_plain(cuda, pen):
    rng = np.random.default_rng(4)
    n, p = 1000, 3000
    X = rng.standard_normal((n, p))
    beta = rng.standard_normal(p) * (rng.random(p) < 0.3)
    Xt, r, beta, L, off, w = _on(cuda, X.T, rng.standard_normal(n) / n, beta,
                                 np.sum(X * X, axis=0) / n,
                                 rng.standard_normal(p) * 0.01,
                                 rng.random(n) * 2.0)
    args = (Xt, r, beta, L, off, type(pen), penalty_params(pen))
    for use_fp in (False, True):
        for wt in (None, w):
            n0 = ops.ws_score.launches
            sk = ops.ws_score(*args, w=wt, use_fp=use_fp)
            assert ops.ws_score.launches == n0 + 1
            sr = ws_score_plain(*args, w=wt, use_fp=use_fp)
            torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)


def _sparse_cases():
    import scipy.sparse as sp
    from repro_torch.data import make_sparse_design
    X = make_sparse_design(n=2000, p=8000, density=5e-3, n_nonzero=40)[0]
    edges = X[:, :500].tolil()
    edges[:, :9] = 0.0                          # empty columns
    edges[:, 17] = np.random.default_rng(0).standard_normal((2000, 1))
    return [X, sp.csc_matrix(edges)]


@pytest.mark.gpu
def test_k5_cuda_matches_plain(cuda):
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(5)
    for X in _sparse_cases():
        d = CSCDesign.from_scipy(X, ell=True, device=cuda)
        raw, w = _on(cuda, rng.standard_normal(X.shape[0]),
                     rng.random(X.shape[0]) + 0.5)
        args = (d.data, d.indices, d.col_ids, d.indptr)
        for square, fn, v in ((False, ops.csc_score, raw),
                              (True, ops.csc_weighted_col_sq, w)):
            n0 = fn.launches
            got = fn(*args, v)
            assert fn.launches == n0 + 1
            torch.testing.assert_close(
                got, csc_score_plain(*args, v, square=square), atol=1e-12,
                rtol=1e-12)
        # the kernel is deterministic and agrees with the ELL reference
        assert torch.equal(ops.csc_score(*args, raw), ops.csc_score(*args,
                                                                    raw))
        torch.testing.assert_close(ops.csc_score(*args, raw),
                                   d.score_ell_reference(raw), atol=1e-12,
                                   rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
def test_sparse_solve_on_card_uses_k5(cuda, weighted):
    """A small sparse Lasso on the card: the kernel route scores every
    outer head with K5 (K5s once for weighted Lipschitz constants), runs K1
    inside, never K3, and agrees with the plain route to 1e-6."""
    from repro_torch.core import L1, Quadratic, lambda_max, solve
    from repro_torch.data import make_sparse_design
    from repro_torch.sparse import CSCDesign
    X, y, _ = make_sparse_design(n=1000, p=4000, density=5e-3,
                                 n_nonzero=40)
    w = np.random.default_rng(1).random(1000) + 0.5 if weighted else None
    d = CSCDesign.from_scipy(X, ell=True, device=cuda)
    lam = lambda_max(d, y, sample_weight=w, device=cuda) / 10
    ops.reset_launch_counts()
    res_k = solve(d, y, Quadratic(), L1(lam), tol=1e-8, sample_weight=w)
    counts = ops.launch_counts()
    res_p = solve(d, y, Quadratic(), L1(lam), tol=1e-8, sample_weight=w,
                  use_kernels=False)
    assert counts["csc_score"] == len(res_k.kkt_history)
    assert counts["csc_weighted_col_sq"] == (1 if weighted else 0)
    assert counts["cd_epoch_gram"] > 0 and counts["fused_ws"] == 0
    assert res_k.converged and res_p.converged
    torch.testing.assert_close(res_k.beta, res_p.beta, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_sparse_estimators_on_card_default_route(cuda):
    """Lasso, SparseLogisticRegression and LinearSVC on a scipy X with their
    default arguments run the kernel route on the card: K5 scores every
    outer head, K3 never runs, and each fit agrees with the plain route."""
    import scipy.sparse as sp
    from repro_torch.core import (Lasso, LinearSVC, Logistic,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.data import make_sparse_design
    X, y, _ = make_sparse_design(n=1000, p=4000, density=5e-3,
                                 n_nonzero=40)
    ys = np.sign(y)
    rng = np.random.default_rng(4)
    Xs = sp.random(300, 100, density=0.2, random_state=5, format="csr",
                   data_rvs=rng.standard_normal)
    ysvc = np.sign(Xs @ rng.standard_normal(100)
                   + 0.3 * rng.standard_normal(300))
    lam = lambda_max(X, y, device=cuda) / 10
    lam_log = lambda_max(X, ys, Logistic(), device=cuda) / 3
    cases = [(lambda **k: Lasso(alpha=lam, **k), X, y, "cd_epoch_gram"),
             (lambda **k: SparseLogisticRegression(alpha=lam_log, **k), X,
              ys, "cd_epoch_xb"),
             (lambda **k: LinearSVC(C=1.0, **k), Xs, ysvc,
              "cd_epoch_gram")]
    for make, Xin, yin, inner in cases:
        ops.reset_launch_counts()
        ek = make(tol=1e-8).fit(Xin, yin)
        counts = ops.launch_counts()
        ep = make(tol=1e-8, use_kernels=False).fit(Xin, yin)
        assert ek.converged_ and ep.converged_
        assert counts["csc_score"] == len(ek.result_.kkt_history)
        assert counts[inner] > 0 and counts["fused_ws"] == 0
        np.testing.assert_allclose(ek.coef_, ep.coef_, atol=1e-6)
