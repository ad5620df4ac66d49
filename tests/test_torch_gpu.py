"""The port's CUDA kernels K1-K5 and their block forms K1b, K3b and K5b on
a card, against their plain versions.

Each ``gpu``-marked test launches one CUDA kernel (through the checked,
counted wrapper of ``repro_torch.kernels.ops``) and its plain torch version
on the same float64 inputs on the card. Tolerances are the reference kernel
tests' (``tests/test_kernels.py``): 1e-12 absolute + 1e-5 relative for K1,
1e-11 + 1e-8 for K2; K3's scores within 1e-12 + 1e-11 relative, gradients
within 1e-12 + 1e-10 relative, an identical working set and bit-exact
gathered columns. K4's scores are held as K3's; K5 and K5s within
1e-12 absolute + 1e-12 relative (the plain segment sum adds with atomics on
the card, in another order than the kernel). The block forms are held as
their scalar ones: K1b as K1, K3b as K3, K5b as K5. K2 and K1b are also
run at shapes that take each branch of their launch plans (K1b's one CTA,
a cluster with its slices in shared memory, a cluster in global memory),
at fewer samples or rows than CTAs and at splits that are not even, and
at forced cluster sizes; each of those launches twice and must repeat bit
for bit (a race between the CTAs of a cluster would show as a difference),
and the plan's branch counter must move. The solve tests hold the captured
outer step (a CUDA graph a bucket, one host read a step) to the per-block
host loop bit for bit, and the cluster plans' step-down (a placement test
refusing 16 CTAs) to the 16-CTA fits. Without a card they skip: the CUDA
kernels have no CPU or interpret mode.

This file imports neither JAX nor the JAX package, so it also runs where
JAX is not installed::

    python -m pytest -q --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from repro_torch.core import penalties as P
from repro_torch.core.working_set import (candidate_columns, priorities,
                                          select_working_set)
from repro_torch.kernels import ops
from repro_torch.kernels.cd_epoch import cd_epoch_gram_plain, cd_epoch_xb_plain
from repro_torch.kernels.common import penalty_params
from repro_torch.kernels.csc_score import csc_score_plain
from repro_torch.kernels.fused_ws import fused_ws_plain, pick_bp
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
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, cuda))
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
    args = (Xt, y, beta0, Xb0, L, off, type(pen), penalty_params(pen, cuda),
            kind)
    wt = w if weighted else None
    bk, xk = ops.cd_epoch_xb(*args, w=wt, epochs=2)
    br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=2)
    torch.testing.assert_close(bk, br, atol=1e-11, rtol=1e-8)
    torch.testing.assert_close(xk, xr, atol=1e-11, rtol=1e-8)


def _k3_check(args, use_fp=False, exact=False):
    """K3 (the score and select launches, the working set and the gather of
    its rows) against the plain version's four outputs: scores and
    gradient within K3's bounds (equal with `exact`), cand_idx exact, the
    working set identical and its rows bit for bit those that
    ``candidate_columns`` recovers from the plain candidate buffer."""
    Xt, gs, ws = args[0], args[5], args[8]
    n0 = ops.fused_ws.launches
    sk, gk, ik, ws_k, xk = ops.fused_ws(*args, use_fp=use_fp)
    assert ops.fused_ws.launches == n0 + 1
    sr, gr, ir, cr = fused_ws_plain(*args, use_fp=use_fp)
    if exact:
        assert torch.equal(sk, sr) and torch.equal(gk, gr)
    torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
    torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
    assert torch.equal(ik, ir)
    assert torch.equal(ws_k, select_working_set(sr, gs, ws))
    assert torch.equal(xk, candidate_columns(ir, cr, ws_k, Xt.shape[0]).T)
    assert torch.equal(xk, Xt[ws_k])


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
        _k3_check((Xt, r, beta, L, off, gs, type(pen),
                   penalty_params(pen, cuda), ws), use_fp=use_fp)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p", [(500, 5000), (301, 777), (64, 3), (1, 5)])
def test_k3_cuda_score_launch_matches_plain(cuda, n, p):
    """The score launch at odd and tiny shapes (a CTA with warps past p,
    rows shorter than a warp) against the plain scores and gradient, and
    K4 on it with weights; the select launch then gives the plain
    cand_idx."""
    from repro_torch.kernels.fused_ws import score_cuda, select_cuda
    rng = np.random.default_rng(9)
    X = rng.standard_normal((n, p))
    Xt, r, beta, L, off, w = _on(
        cuda, X.T, rng.standard_normal(n), rng.standard_normal(p) *
        (rng.random(p) < 0.3), np.sum(X * X, axis=0) / n,
        rng.standard_normal(p) * 0.01, rng.random(n) + 0.5)
    pen = P.MCP(0.11, 3.0)
    gs = pen.generalized_support(beta)
    args = (Xt, r, beta, L, off, P.MCP, penalty_params(pen, cuda))
    sk, gk, pk = score_cuda(*args, gsupp=gs)
    sr, gr, ir, _ = fused_ws_plain(*args[:5], gs, *args[5:], min(64, p))
    torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
    torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
    assert torch.equal(pk, priorities(sk, gs))
    bp = pick_bp(p)
    assert torch.equal(select_cuda(pk, bp, min(bp, 64)), ir)
    torch.testing.assert_close(
        score_cuda(*args, w=w),
        ws_score_plain(*args, w=w), atol=1e-12, rtol=1e-11)


@pytest.mark.gpu
@pytest.mark.parametrize("p,bp,ws", [
    (20_000, None, 1024),     # the main path's shape: 20 tiles, ws >= bp
    (20_000, None, 64),
    (5000, 777, 4096),        # a ragged last tile
    (30_000, None, 8192),     # past MERGE_SMEM_K: lists in global memory
    (3000, None, 3000),       # ws = p
    (700, None, 700),         # one tile
    (1, None, 1),
])
@pytest.mark.parametrize("levels", [3, 1_000_000], ids=["ties", "spread"])
def test_k3_cuda_merge_matches_select_working_set(cuda, p, bp, ws, levels):
    """K3's merge launch gives ``select_working_set`` exactly, order and
    ties included: priorities of a few integer levels (ties everywhere,
    broken by the lowest index) or spread, 2% of them pinned to +inf."""
    from repro_torch.kernels.fused_ws import merge_cuda, select_cuda
    g = torch.Generator(device=cuda).manual_seed(p + ws + levels)
    scores = torch.randint(0, levels, (p,), generator=g, device=cuda).to(
        torch.float64)
    gs = torch.rand(p, generator=g, device=cuda) < 0.02
    pri = priorities(scores, gs)
    bp = pick_bp(p) if bp is None else bp
    got = merge_cuda(pri, select_cuda(pri, bp, min(bp, ws)), bp, ws)
    assert got.dtype == torch.int64
    assert torch.equal(got, select_working_set(scores, gs, ws))


@pytest.mark.gpu
def test_k3_cuda_exact_ties(cuda):
    """Duplicated integer columns tie exactly: identical scores, the
    lax.top_k lowest-index choice in cand_idx and in the working set,
    bit-exact rows, for every penalty x {sd, fp} x ws in {64, 1024}; the
    penalties whose score arithmetic is not exact on integer data are held
    to K3's bounds, with cand_idx and the working set still exact."""
    rng = np.random.default_rng(7)
    n, p = 64, 3000
    half = rng.integers(-3, 4, size=(n, p // 2)).astype(np.float64)
    X = np.concatenate([half, half], axis=1)
    beta = np.where(rng.random(p) < 0.02, 1.0, 0.0)
    Xt, r, beta, L, off = _on(cuda, X.T, rng.integers(-2, 3, n), beta,
                              np.maximum(np.sum(X * X, 0) / n, 1e-12),
                              np.zeros(p))
    # the first three: score arithmetic exact on integer data
    pens = [P.L1(0.5), P.L1L2(0.5, 0.5), P.Box(0.8)] + PENALTIES
    for i, pen in enumerate(pens):
        gs = pen.generalized_support(beta)
        for use_fp in (False, True):
            for ws in (64, 1024):
                _k3_check((Xt, r, beta, L, off, gs, type(pen),
                           penalty_params(pen, cuda), ws), use_fp=use_fp,
                          exact=i < 3 and not use_fp)


@pytest.mark.gpu
@pytest.mark.parametrize("n,p,ws", [(2000, 6000, 1024), (1001, 5000, 1024)])
def test_k3_cuda_allocates_no_candidate_buffer(cuda, n, p, ws):
    """At ws >= bp the old candidate buffer [tiles * kc, n] was as large as
    X: one K3 call now raises the peak of allocated memory by less than a
    quarter of X's bytes (the scores, the gradient, the priorities,
    cand_idx, the working set and its K rows)."""
    rng = np.random.default_rng(11)
    Xt, r, beta, L, off = _on(cuda, rng.standard_normal((p, n)),
                              rng.standard_normal(n), np.zeros(p),
                              np.ones(p), np.zeros(p))
    pen = P.L1(0.1)
    gs = pen.generalized_support(beta)
    args = (Xt, r, beta, L, off, gs, P.L1, penalty_params(pen, cuda), ws)
    assert pick_bp(p) <= ws
    ops.fused_ws(*args)                           # builds the library
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    out = ops.fused_ws(*args)
    torch.cuda.synchronize()
    rise = torch.cuda.max_memory_allocated() - base
    assert rise < Xt.numel() * Xt.element_size() / 4, rise
    assert out[4].shape == (ws, n)


@pytest.mark.gpu
def test_dense_design_from_dense_holds_x_once(cuda):
    """From a numpy X the card holds X once while the design is built:
    the peak rises by at most X's bytes + 64 MiB, and Xt equals X.T."""
    from repro_torch.core.engine import DenseDesign
    X = np.random.default_rng(12).standard_normal((3000, 20_000))
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    d = DenseDesign.from_dense(X, cuda)
    torch.cuda.synchronize()
    assert torch.cuda.max_memory_allocated() - base <= X.nbytes + 2**26
    assert torch.equal(d.Xt.cpu(), torch.as_tensor(X.T))


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
    args = (Xt, y, beta0, Xb0, L, off, P.L1, penalty_params(P.L1(0.002), cuda),
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
    args = (Xt, r, beta, L, off, type(pen), penalty_params(pen, cuda))
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


def _replayed(fn):
    """fn()'s result from a replay of a CUDA graph that captured it (warmed
    up on a side stream first, as ``core/flow.py`` captures a step)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = fn()
    graph.replay()
    torch.cuda.synchronize()
    return out.clone()


def _walk_cases():
    """Designs beside ``_sparse_cases``: n = 20,011 (a dense column, a
    column of the first 40 rows, a 1000-entry head column, empty columns,
    the last row) and fewer columns than SMs (p = 50)."""
    import scipy.sparse as sp
    rng = np.random.default_rng(8)
    n = 20_011
    X = sp.random(n, 300, density=0.004, random_state=8, format="csc",
                  data_rvs=rng.standard_normal).tolil()
    X[:, 3:9] = 0.0
    X[:, 12] = rng.standard_normal((n, 1))
    X[:, 20] = 0.0
    X[:40, 20] = rng.standard_normal((40, 1))
    X[:, 0] = 0.0
    X[rng.choice(n, 1000, replace=False), 0] = 1.0
    X[-1, 299] = 2.0
    narrow = sp.random(700, 50, density=0.05, random_state=9, format="csc",
                       data_rvs=rng.standard_normal)
    return [sp.csc_matrix(X), narrow]


@pytest.mark.gpu
def test_k5_cuda_matches_plain(cuda):
    """K5 and K5s against the plain version; bit for bit against the
    emulation of the kernel's order, with every SM's shared memory
    NaN-filled before each launch, launched eagerly and replayed from a
    CUDA graph."""
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    from repro_torch.kernels.csc_score import emulate
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(5)
    for X in _sparse_cases() + _walk_cases():
        d = CSCDesign.from_scipy(X, ell=True, device=cuda)
        raw, w = _on(cuda, rng.standard_normal(X.shape[0]),
                     rng.random(X.shape[0]) + 0.5)
        args = (d.data, d.indices, d.col_ids, d.indptr)
        for square, fn, v in ((False, ops.csc_score, raw),
                              (True, ops.csc_weighted_col_sq, w)):
            n0 = fn.launches
            fill_shared_memory_cuda(cuda)
            got = fn(*args, v)
            assert fn.launches == n0 + 1
            torch.testing.assert_close(
                got, csc_score_plain(*args, v, square=square), atol=1e-12,
                rtol=1e-12)
            assert torch.equal(got, emulate(d.data, d.indices, d.indptr, v,
                                            square=square))
            fill_shared_memory_cuda(cuda)
            assert torch.equal(got, _replayed(lambda: fn(*args, v)))
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


BLOCK_PENALTIES = [P.BlockL1(0.11), P.BlockMCP(0.11, 3.0)]
BLOCK_IDS = [type(p).__name__ for p in BLOCK_PENALTIES]


def _gram_block_inputs(K, T, dev, seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((3 * K, K))
    G = X.T @ X / (3 * K)
    beta0 = rng.standard_normal((K, T)) * 0.1 * (rng.random((K, 1)) < 0.5)
    c = X.T @ rng.standard_normal((3 * K, T)) / (3 * K)
    G, c, beta0, q0, L = _on(dev, G, c, beta0, G @ beta0, np.diag(G))
    return G.t().contiguous().t(), c, beta0, q0, L


@pytest.mark.gpu
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
@pytest.mark.parametrize("K,T", [(64, 5), (256, 20), (2048, 20), (40, 50)])
def test_k1b_cuda_matches_plain(cuda, pen, K, T):
    """K1b in shared memory (K * T values fit) and in global memory
    (K = 2048, T = 20)."""
    G, c, beta0, q0, L = _gram_block_inputs(K, T, cuda)
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, cuda))
    for epochs in (1, 3):
        n0 = ops.cd_epoch_gram_block.launches
        bk, qk = ops.cd_epoch_gram_block(*args, epochs=epochs)
        assert ops.cd_epoch_gram_block.launches == n0 + 1
        br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
        torch.testing.assert_close(bk, br, atol=1e-12, rtol=1e-5)
        torch.testing.assert_close(qk, qr, atol=1e-12, rtol=1e-5)
        assert torch.any(bk != beta0)


@pytest.mark.gpu
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
@pytest.mark.parametrize("use_fp", [False, True], ids=["sd", "fp"])
@pytest.mark.parametrize("n,p,T", [(500, 5000, 20), (301, 777, 3),
                                   (200, 1500, 70)])
def test_k3b_cuda_matches_plain(cuda, pen, use_fp, n, p, T):
    """K3b (the float64 tensor-core product, the select launch emitting
    cand_idx only, the gather of the working set's rows) against the plain
    version's four outputs, with every SM's shared memory set to NaN
    before each launch (a read of a staged tile's unwritten part shows):
    scores and gradient within K3's bounds, cand_idx exact, the working
    set identical and its rows bit for bit those that
    ``candidate_columns`` recovers from the plain candidate buffer. The
    shapes take a ragged last feature tile, an odd n (8-byte copies) and
    T > 24 (several task passes)."""
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    rng = np.random.default_rng(6)
    X = rng.standard_normal((n, p))
    beta = rng.standard_normal((p, T)) * (rng.random((p, 1)) < 0.3)
    Xt, R, beta, L, off = _on(cuda, X.T, rng.standard_normal((n, T)), beta,
                              np.sum(X * X, axis=0) / n,
                              rng.standard_normal(p) * 0.01)
    gs = pen.generalized_support(beta)
    for ws in (64, 512):
        args = (Xt, R, beta, L, off, gs, type(pen), penalty_params(pen, cuda),
                min(ws, p))
        n0 = ops.fused_ws_block.launches
        fill_shared_memory_cuda(cuda)
        sk, gk, ik, ws_k, xk = ops.fused_ws_block(*args, use_fp=use_fp)
        assert ops.fused_ws_block.launches == n0 + 1
        sr, gr, ir, cr = fused_ws_plain(*args, use_fp=use_fp)
        torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
        torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
        assert torch.equal(ik, ir)
        assert torch.equal(ws_k, select_working_set(sr, gs, min(ws, p)))
        assert torch.equal(xk, candidate_columns(ir, cr, ws_k, p).T)
        fill_shared_memory_cuda(cuda)
        assert _same(ops.fused_ws_block(*args, use_fp=use_fp),
                     (sk, gk, ik, ws_k, xk))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [3, 20, 50])
def test_k5b_cuda_matches_plain(cuda, T):
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    from repro_torch.kernels.csc_score import emulate
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(7)
    for X in _sparse_cases():
        d = CSCDesign.from_scipy(X, ell=True, device=cuda)
        (raw,) = _on(cuda, rng.standard_normal((X.shape[0], T)))
        args = (d.data, d.indices, d.col_ids, d.indptr)
        n0 = ops.csc_score_block.launches
        got = ops.csc_score_block(*args, raw)
        assert ops.csc_score_block.launches == n0 + 1
        torch.testing.assert_close(got, csc_score_plain(*args, raw),
                                   atol=1e-12, rtol=1e-12)
        assert torch.equal(got, ops.csc_score_block(*args, raw))
        torch.testing.assert_close(got, torch.as_tensor(
            X.T @ raw.cpu().numpy(), device=cuda), atol=1e-12, rtol=1e-12)
        # bit for bit the kernel's order, with shared memory NaN-filled,
        # and from a graph replay
        assert torch.equal(got, emulate(d.data, d.indices, d.indptr, raw))
        fill_shared_memory_cuda(cuda)
        assert torch.equal(got, ops.csc_score_block(*args, raw))
        assert torch.equal(got, _replayed(
            lambda: ops.csc_score_block(*args, raw)))


@pytest.mark.gpu
@pytest.mark.parametrize("T", [1, 2, 200, 257])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_k5b_cuda_widths(cuda, T, dtype):
    """K5b at one task, two, one entry an iteration (T = 200: entry order)
    and in two task blocks (T = 257, one value a lane), in float64 and
    float32: bit for bit its emulation."""
    from repro_torch.kernels.csc_score import emulate
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(T)
    for X in _walk_cases():
        d = CSCDesign.from_scipy(X, dtype=np.float64 if dtype == torch.float64
                                 else np.float32, ell=True, device=cuda)
        raw = torch.as_tensor(rng.standard_normal((X.shape[0], T)),
                              dtype=dtype, device=cuda)
        args = (d.data, d.indices, d.col_ids, d.indptr)
        got = ops.csc_score_block(*args, raw)
        assert got.dtype == dtype
        assert torch.equal(got, emulate(d.data, d.indices, d.indptr, raw))


@pytest.mark.gpu
def test_k5b_cuda_refuses_unaligned_raw(cuda):
    """At an even T K5b reads raw's rows 16 bytes at a time: the wrapper
    raises on a raw that does not start on a 16-byte boundary rather than
    copy it quietly; K5 (no vector loads) takes it."""
    from repro_torch.sparse import CSCDesign
    X = _sparse_cases()[0]
    n = X.shape[0]
    d = CSCDesign.from_scipy(X, ell=True, device=cuda)
    args = (d.data, d.indices, d.col_ids, d.indptr)
    buf = torch.as_tensor(np.random.default_rng(0).standard_normal(2 * n + 1),
                          device=cuda)
    with pytest.raises(ValueError, match="16-byte"):
        ops.csc_score_block(*args, buf[1:].view(n, 2))
    torch.testing.assert_close(ops.csc_score(*args, buf[1:n + 1]),
                               csc_score_plain(*args, buf[1:n + 1]),
                               atol=1e-12, rtol=1e-12)


@pytest.mark.gpu
@pytest.mark.parametrize("sparse", [False, True], ids=["dense", "csc"])
def test_multitask_solve_on_card_uses_block_kernels(cuda, sparse):
    """A small multitask Lasso on the card: the kernel route runs K3b
    (dense) or K5b (CSC) on every outer head and K1b inside, never the
    scalar K1/K3/K5, and agrees with the plain route to 1e-6."""
    from repro_torch.core import (BlockL1, MultitaskQuadratic, lambda_max,
                                  solve)
    from repro_torch.data import make_multitask
    from repro_torch.sparse import CSCDesign
    X, Y, _ = make_multitask(n=300, p=1200, n_tasks=8, n_nonzero=20)
    if sparse:
        import scipy.sparse as sp
        X = sp.csc_matrix(X * (np.random.default_rng(0).random(X.shape)
                               < 0.2))
        X = CSCDesign.from_scipy(X, ell=True, device=cuda)
    lam = lambda_max(X, Y, MultitaskQuadratic(), device=cuda) / 10
    ops.reset_launch_counts()
    res_k = solve(X, Y, MultitaskQuadratic(), BlockL1(lam), tol=1e-8)
    counts = ops.launch_counts()
    res_p = solve(X, Y, MultitaskQuadratic(), BlockL1(lam), tol=1e-8,
                  use_kernels=False)
    head = "csc_score_block" if sparse else "fused_ws_block"
    assert counts[head] == len(res_k.kkt_history)
    assert counts["cd_epoch_gram_block"] == res_k.n_epochs > 0
    assert counts["cd_epoch_gram"] == counts["fused_ws"] == \
        counts["csc_score"] == 0
    assert res_k.converged and res_p.converged
    assert res_k.beta.shape == (1200, 8)
    torch.testing.assert_close(res_k.beta, res_p.beta, atol=1e-6, rtol=0)


@pytest.mark.gpu
def test_multitask_estimators_on_card_default_route(cuda):
    """MultiTaskLasso and MultiTaskMCP with their default arguments fit and
    predict on the card, on a dense and on a scipy sparse X: the kernel
    route runs K3b or K5b on every head and K1b on every epoch, and each
    fit agrees with the plain route."""
    import scipy.sparse as sp
    from repro_torch.core import (MultiTaskLasso, MultiTaskMCP,
                                  MultitaskQuadratic, lambda_max)
    from repro_torch.data import make_multitask
    X, Y, _ = make_multitask(n=300, p=1200, n_tasks=8, n_nonzero=20)
    Xs = sp.csr_matrix(X * (np.random.default_rng(0).random(X.shape)
                            < 0.2))
    for Xin, head in ((X, "fused_ws_block"), (Xs, "csc_score_block")):
        lam = lambda_max(Xin, Y, MultitaskQuadratic(), device=cuda) / 10
        for make in (lambda **k: MultiTaskLasso(alpha=lam, **k),
                     lambda **k: MultiTaskMCP(alpha=lam, gamma=3.0, **k)):
            ops.reset_launch_counts()
            ek = make().fit(Xin, Y)
            counts = ops.launch_counts()
            ep = make(use_kernels=False).fit(Xin, Y)
            assert ek.converged_ and ep.converged_
            assert counts[head] == len(ek.result_.kkt_history)
            assert counts["cd_epoch_gram_block"] == ek.result_.n_epochs
            assert ek.coef_.shape == (1200, 8)
            np.testing.assert_allclose(ek.coef_, ep.coef_, atol=1e-6)
            pred = ek.predict(Xin)
            assert pred.shape == (300, 8)
            np.testing.assert_allclose(pred, ep.predict(Xin), atol=1e-5)


# ---------------------------------------------- K2 and K1b on every branch
def _xb_case(kind, weighted, K, n, dev, seed=8):
    """K2 inputs with an L1 level (a Box for svc) that moves about half of
    the coordinates in the first epoch."""
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((K, n))
    y = np.sign(rng.standard_normal(n))
    beta0 = rng.standard_normal(K) * 0.05
    w = rng.random(n) * 2.0
    w = w * (n / w.sum()) if weighted else np.ones(n)
    Xb0 = beta0 @ Xt
    if kind == "quadratic":
        L, raw = np.sum(Xt * Xt, 1) / n, w * (Xb0 - y) / n
    elif kind == "logistic":
        L = np.sum(Xt * Xt, 1) / (4 * n)
        raw = w * (-y / (1.0 + np.exp(y * Xb0))) / n
    else:
        L, raw = np.sum(Xt * Xt, 1), Xb0
    off = -np.ones(K) if kind == "svc" else np.zeros(K)
    pen = P.Box(0.9) if kind == "svc" else \
        P.L1(0.5 * float(np.median(np.abs(Xt @ raw))))
    Xt, y, beta0, Xb0, L, off, w = _on(dev, Xt, y, beta0, Xb0, L, off, w)
    return (Xt, y, beta0, Xb0, L, off, type(pen), penalty_params(pen, dev),
            kind), (w if weighted else None)


def _same(a, b):
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.gpu
@pytest.mark.parametrize("n", [7, 200, 1001, 10_000, 50_000, 160_003])
@pytest.mark.parametrize("kind,weighted", XB_CASES,
                         ids=[f"{k}-w{int(w)}" for k, w in XB_CASES])
def test_k2_plan_branch_matches_plain(cuda, kind, weighted, n):
    """K2 through the counted wrapper at the branch its plan names for n
    (fewer samples than CTAs, fewer than 32 a CTA, n not a multiple of C,
    a cluster in shared memory, a cluster in global memory): within the
    plain version's tolerance, two launches equal bit for bit, and the
    plan's branch counter moved."""
    from repro_torch.kernels.cd_epoch import xb_plan
    K = 128 if n <= 20_000 else 64 if n <= 100_003 else 32
    args, wt = _xb_case(kind, weighted, K, n, cuda)
    plan = xb_plan(n, weighted, torch.float64)
    for epochs in (1, 3):
        c0 = ops.branch_counts()["cd_epoch_xb"]
        got = ops.cd_epoch_xb(*args, w=wt, epochs=epochs)
        again = ops.cd_epoch_xb(*args, w=wt, epochs=epochs)
        c1 = ops.branch_counts()["cd_epoch_xb"]
        assert c1[plan.branch] == c0[plan.branch] + 2
        assert sum(c1.values()) == sum(c0.values()) + 2
        assert _same(got, again)
        br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=epochs)
        torch.testing.assert_close(got[0], br, atol=1e-11, rtol=1e-8)
        torch.testing.assert_close(got[1], xr, atol=1e-11, rtol=1e-8)
        assert torch.any(got[0] != args[2])


@pytest.mark.gpu
@pytest.mark.parametrize("n,C", [(7, 8), (200, 8), (1001, 2), (10_001, 8),
                                 (50_000, 1), (100_003, 8)])
@pytest.mark.parametrize("kind,weighted", XB_CASES,
                         ids=[f"{k}-w{int(w)}" for k, w in XB_CASES])
def test_k2_cluster_edges_match_plain(cuda, kind, weighted, n, C):
    """The cluster kernel at forced sizes: fewer samples than CTAs, fewer
    than C * 32, n not a multiple of C, the portable 8 CTAs, one CTA, the
    global branch at C = 8."""
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_cuda, xb_plan
    args, wt = _xb_case(kind, weighted, 32, n, cuda)
    plan = xb_plan(n, weighted, torch.float64, cluster=C)
    for epochs in (1, 3):
        got = cd_epoch_xb_cuda(*args, w=wt, epochs=epochs, plan=plan)
        assert _same(got, cd_epoch_xb_cuda(*args, w=wt, epochs=epochs,
                                           plan=plan))
        br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=epochs)
        torch.testing.assert_close(got[0], br, atol=1e-11, rtol=1e-8)
        torch.testing.assert_close(got[1], xr, atol=1e-11, rtol=1e-8)


def _gram_block_case(K, T, dev, seed=0):
    """K1b inputs made on the card (the Gram of a 3K x K Gaussian design)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    X = torch.randn(3 * K, K, **f64)
    G = (X.T @ X / (3 * K)).t().contiguous().t()
    beta0 = 0.1 * torch.randn(K, T, **f64) * (torch.rand(K, 1, **f64) < 0.5)
    c = X.T @ torch.randn(3 * K, T, **f64) / (3 * K)
    return G, c, beta0, G @ beta0, torch.diagonal(G).contiguous()


@pytest.mark.gpu
@pytest.mark.parametrize("K,T", [(K, T) for K in (64, 2049, 4096)
                                 for T in (1, 20, 50)] + [(2048, 240)])
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
def test_k1b_plan_branch_matches_plain(cuda, pen, K, T):
    """K1b through the counted wrapper at the branch its plan names (one
    CTA, a cluster with q's rows in shared memory, in global memory at
    (2048, 240)): within the plain version's tolerance, two launches equal
    bit for bit, and the plan's branch counter moved."""
    from repro_torch.kernels.cd_epoch import gram_block_plan
    G, c, beta0, q0, L = _gram_block_case(K, T, cuda)
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, cuda))
    plan = gram_block_plan(K, T, torch.float64)
    for epochs in (1, 3):
        c0 = ops.branch_counts()["cd_epoch_gram_block"]
        got = ops.cd_epoch_gram_block(*args, epochs=epochs)
        again = ops.cd_epoch_gram_block(*args, epochs=epochs)
        c1 = ops.branch_counts()["cd_epoch_gram_block"]
        assert c1[plan.branch] == c0[plan.branch] + 2
        assert _same(got, again)
        br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
        torch.testing.assert_close(got[0], br, atol=1e-12, rtol=1e-5)
        torch.testing.assert_close(got[1], qr, atol=1e-12, rtol=1e-5)
        assert torch.any(got[0] != beta0)


@pytest.mark.gpu
@pytest.mark.parametrize("K,T,C", [(5, 3, 8), (64, 50, 8), (2049, 1, 16),
                                   (1000, 20, 2), (300, 50, 16),
                                   (4096, 20, 2)])
def test_k1b_cluster_equals_single_cta(cuda, K, T, C):
    """The cluster kernel at forced sizes (fewer rows than CTAs, 8 CTAs,
    ragged rows, q's rows in global memory) gives the single-CTA kernel's
    beta and q bit for bit, or the 16-CTA cluster's where one CTA cannot
    hold q: the q update has no cross-CTA reduction."""
    from repro_torch.kernels.cd_epoch import (SMEM_DYN_MAX,
                                              cd_epoch_gram_block_cuda,
                                              gram_block_plan)
    G, c, beta0, q0, L = _gram_block_case(K, T, cuda, seed=K)
    args = (G, c, beta0, q0, L, P.BlockMCP, penalty_params(
        P.BlockMCP(0.11, 3.0), cuda))
    single = gram_block_plan(K, T, torch.float64, cluster=1)
    if single.dyn_bytes > SMEM_DYN_MAX:
        single = gram_block_plan(K, T, torch.float64, cluster=16)
    for epochs in (1, 3):
        one = cd_epoch_gram_block_cuda(*args, epochs=epochs, plan=single)
        many = cd_epoch_gram_block_cuda(*args, epochs=epochs,
                                        plan=gram_block_plan(
                                            K, T, torch.float64, cluster=C))
        assert _same(one, many)
        br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
        torch.testing.assert_close(many[0], br, atol=1e-12, rtol=1e-5)
        torch.testing.assert_close(many[1], qr, atol=1e-12, rtol=1e-5)


@pytest.mark.gpu
def test_refused_plan_raises(cuda):
    """A launch the card refuses (more shared memory than a CTA can have)
    raises; nothing retries on another layout."""
    from repro_torch.kernels.cd_epoch import (EpochPlan,
                                              cd_epoch_gram_block_cuda,
                                              cd_epoch_xb_cuda)
    too_big = 300_000
    args, wt = _xb_case("logistic", True, 16, 10_000, cuda)
    with pytest.raises(RuntimeError, match="cudaError"):
        cd_epoch_xb_cuda(*args, w=wt, plan=EpochPlan(16, True, too_big, 256,
                                                     0))
    G, c, beta0, q0, L = _gram_block_case(512, 20, cuda)
    for C in (1, 16):
        with pytest.raises(RuntimeError, match="cudaError"):
            cd_epoch_gram_block_cuda(G, c, beta0, q0, L, P.BlockL1,
                                     penalty_params(P.BlockL1(0.1), cuda),
                                     plan=EpochPlan(C, True, too_big, 256,
                                                    0))


# ------------------------------------------ K1's blocked chain on its plan
def _k1_case(K, dev, seed=0):
    """K1 inputs made on the card: the Gram of a 3K x K Gaussian design
    plus a small non-symmetric part (a transposed read of G would show),
    column-major as the engine keeps G; half of beta0 zero."""
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    X = torch.randn(3 * K, K, **f64)
    G = X.T @ X / (3 * K) + 0.01 * torch.randn(K, K, **f64)
    del X
    G = G.t().contiguous().t()
    beta0 = 0.1 * torch.randn(K, **f64) * (torch.rand(K, **f64) < 0.5)
    c = torch.randn(K, **f64) / 3
    L = torch.clamp(torch.diagonal(G), min=1e-3).contiguous()
    return G, c, beta0, G @ beta0, L


def _k1_refs(args, epochs_list):
    """The plain version's (beta, q) after each number of epochs."""
    out, state, done = {}, args[2:4], 0
    for epochs in sorted(epochs_list):
        state = cd_epoch_gram_plain(args[0], args[1], state[0], state[1],
                                    *args[4:], epochs=epochs - done)
        done = epochs
        out[epochs] = state
    return out


def _k1_check(args, refs, plan=None, fill=False):
    """Launch K1 for each number of epochs in `refs` (through the counted
    wrapper, or `cd_epoch_gram_cuda` with `plan`), twice: within the K1
    bound of the plain version and equal bit for bit. With `fill`, every
    SM's shared memory is set to NaN before each launch. Returns the
    outputs."""
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_cuda,
                                              fill_shared_memory_cuda)

    def launch(epochs):
        if fill:
            fill_shared_memory_cuda(args[0].device)
        if plan is None:
            return ops.cd_epoch_gram(*args, epochs=epochs)
        return cd_epoch_gram_cuda(*args, epochs=epochs, plan=plan)

    outs = {}
    for epochs, ref in refs.items():
        got = launch(epochs)
        again = launch(epochs)
        assert _same(got, again)
        torch.testing.assert_close(got[0], ref[0], atol=1e-12, rtol=1e-5)
        torch.testing.assert_close(got[1], ref[1], atol=1e-12, rtol=1e-5)
        outs[epochs] = got
    return outs


@pytest.mark.gpu
@pytest.mark.parametrize("K", [1, 31, 33, 1023, 1025, 2049, 4096])
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_k1_plan_matches_plain(cuda, pen, K):
    """K1 through the counted wrapper at ragged and whole blocks, one block
    and many, epochs 1 and 3 (the last block of an epoch carries into the
    first of the next), G column-major and row-major: within the plain
    version's bound, each launched twice and equal bit for bit, on the
    plan's branch."""
    from repro_torch.kernels.cd_epoch import gram_plan
    G, c, beta0, q0, L = _k1_case(K, cuda, seed=K)
    prm = penalty_params(pen, cuda)
    refs = _k1_refs((G, c, beta0, q0, L, type(pen), prm), (1, 3))
    branch = gram_plan(K, torch.float64).branch
    for layout in (G, G.contiguous()):
        c0 = ops.branch_counts()["cd_epoch_gram"]
        _k1_check((layout, c, beta0, q0, L, type(pen), prm), refs)
        c1 = ops.branch_counts()["cd_epoch_gram"]
        assert c1[branch] == c0[branch] + 4
    assert torch.any(refs[1][0] != beta0)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [33, 63, 1025, 2049])
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_k1_reads_no_unwritten_shared_memory(cuda, pen, K):
    """A ragged last block leaves part of its staged tiles unwritten (no
    coordinate there); the chain that follows it, in the next epoch, must
    not read those entries. Every SM's shared memory is filled with NaN
    before each launch; one CTA (K = 33, 63) and the cluster (1025, 2049),
    epochs 1 and 3, stay within the plain version's bound and equal bit
    for bit."""
    G, c, beta0, q0, L = _k1_case(K, cuda, seed=K + 7)
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, cuda))
    _k1_check(args, _k1_refs(args, (1, 3)), fill=True)


@pytest.mark.gpu
@pytest.mark.parametrize("K", [33, 65, 1025])
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_k1_forced_layouts_equal(cuda, pen, K):
    """One CTA and clusters of 2, 8 and 16 CTAs and other thread counts
    give the default plan's beta and q bit for bit:
    the layout leaves every row's order of additions alone (a cluster
    needs K > 64)."""
    from repro_torch.kernels.cd_epoch import cd_epoch_gram_cuda, gram_plan
    G, c, beta0, q0, L = _k1_case(K, cuda, seed=K + 1)
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, cuda))
    f64 = torch.float64
    plans = [gram_plan(K, f64, cluster=1),
             gram_plan(K, f64, cluster=1, threads=64),
             gram_plan(K, f64, cluster=1, threads=512)]
    if K > 64:
        plans += [gram_plan(K, f64, cluster=C) for C in (2, 8, 16)]
        plans += [gram_plan(K, f64, cluster=8, threads=512),
                  gram_plan(K, f64, cluster=16, threads=64)]
    for epochs in (1, 3):
        want = ops.cd_epoch_gram(*args, epochs=epochs)
        for plan in plans:
            assert _same(cd_epoch_gram_cuda(*args, epochs=epochs, plan=plan),
                         want), plan


@pytest.mark.gpu
@pytest.mark.parametrize("K", [64, 1025])
def test_k1_blocks_without_moves(cuda, K):
    """A block where no coordinate moves (L = 0 on rows 32..63: beta kept),
    and a level at which nothing moves at all (q and beta come back as
    they went in)."""
    G, c, beta0, _, L = _k1_case(K, cuda, seed=9)
    L = L.clone()
    L[32:64] = 0.0
    for pen, b0 in ((P.L1(0.11), beta0), (P.L1(1e6), torch.zeros_like(beta0))):
        args = (G, c, b0, G @ b0, L, P.L1, penalty_params(pen, cuda))
        outs = _k1_check(args, _k1_refs(args, (1, 3)))
        for beta, q in outs.values():
            assert torch.equal(beta[32:64], b0[32:64])
            if pen.lam > 1:
                assert torch.equal(beta, b0) and torch.equal(q, args[3])


@pytest.mark.gpu
def test_k1_float32_matches_plain(cuda):
    """float32 on the same schedule, against the float32 plain version."""
    G, c, beta0, q0, L = (t.float() for t in _k1_case(1025, cuda, seed=4))
    G = G.t().contiguous().t()
    args = (G, c, beta0, q0, L, P.MCP, penalty_params(P.MCP(0.11, 3.0), cuda))
    for epochs in (1, 3):
        got = ops.cd_epoch_gram(*args, epochs=epochs)
        assert _same(got, ops.cd_epoch_gram(*args, epochs=epochs))
        ref = cd_epoch_gram_plain(*args, epochs=epochs)
        torch.testing.assert_close(got[0], ref[0], atol=1e-5, rtol=1e-4)
        torch.testing.assert_close(got[1], ref[1], atol=1e-5, rtol=1e-4)


@pytest.mark.gpu
def test_k1_refused_plan_raises(cuda):
    """A thread count the kernel cannot run, a cluster on fewer than three
    blocks or of more than 16 CTAs, more shared memory than a CTA has, or
    less than the state needs (one CTA and cluster) is refused, and the
    wrapper raises."""
    from repro_torch.kernels.cd_epoch import cd_epoch_gram_cuda, gram_plan
    f64 = torch.float64
    for K in (64, 1025):
        G, c, beta0, q0, L = _k1_case(K, cuda)
        args = (G, c, beta0, q0, L, P.L1, penalty_params(P.L1(0.1), cuda))
        plan = gram_plan(K, f64)
        bad = [plan._replace(threads=32), plan._replace(threads=1024),
               plan._replace(dyn_bytes=300_000),
               plan._replace(dyn_bytes=plan.dyn_bytes - 8)]
        if K == 64:
            bad.append(plan._replace(cluster=8))
        else:
            bad.append(gram_plan(K, f64)._replace(cluster=17))
        for b in bad:
            with pytest.raises(RuntimeError, match="cudaError"):
                cd_epoch_gram_cuda(*args, plan=b)


# ------------------------------------------ the captured outer step (P1)
def _step_case(name, dev):
    """(X, y, datafit, penalty, sample_weight) of a small fit of each
    inner route: the SVC dual (K1 on a dense design), a deep weighted
    sparse logistic regression (K5 head, K2 on a cluster) and a dense
    multitask Lasso (K3b head, K1b)."""
    from repro_torch.core import (BlockL1, Box, L1, Logistic,
                                  MultitaskQuadratic, QuadraticSVC,
                                  lambda_max)
    from repro_torch.data import (make_classification, make_multitask,
                                  make_sparse_design)
    from repro_torch.sparse import CSCDesign
    if name == "svc":
        X, y, _ = make_classification(n=400, p=200, n_nonzero=20, seed=0)
        return (y[:, None] * X).T.copy(), y, QuadraticSVC(), Box(1.0), None
    if name == "sparse-logistic":
        X, y, _ = make_sparse_design(n=1000, p=4000, density=5e-3,
                                     n_nonzero=40)
        d = CSCDesign.from_scipy(X, ell=True, device=dev)
        w = np.random.default_rng(1).uniform(0.5, 1.5, 1000)
        ys = np.sign(y)
        lam = lambda_max(d, ys, Logistic(), sample_weight=w, device=dev)
        return d, ys, Logistic(), L1(lam / 30), w
    X, Y, _ = make_multitask(n=300, p=1200, n_tasks=8, n_nonzero=20)
    lam = lambda_max(X, Y, MultitaskQuadratic(), device=dev)
    return X, Y, MultitaskQuadratic(), BlockL1(lam / 10), None


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["svc", "sparse-logistic", "multitask"])
def test_captured_step_equals_eager_loop(cuda, name):
    """The captured outer step (a CUDA graph replayed once a step, the
    skip decision in an IF node and the Anderson blocks in a WHILE node)
    against the card's eager oracle, the same step with its conditions
    read on the host after every block (``capture=False``): beta bit for
    bit, the same outer steps and epochs, the kernel launches counted per
    replay equal to the eager ones, and one host read a step."""
    from repro_torch.core import make_engine, solve
    X, y, datafit, penalty, w = _step_case(name, cuda)
    out = {}
    for capture in (True, False):
        eng = make_engine(penalty, datafit, device=cuda, capture=capture)
        ops.reset_launch_counts()
        res = solve(X, y, datafit, penalty, tol=1e-8, engine=eng,
                    sample_weight=w)
        out[capture] = (res, ops.launch_counts(), ops.branch_counts())
        eng.release_graphs()
    (rc, cc, bc), (re, ce, be) = out[True], out[False]
    assert rc.converged and re.converged
    assert torch.equal(rc.beta, re.beta)
    assert (rc.n_outer, rc.n_epochs) == (re.n_outer, re.n_epochs)
    assert rc.kkt_history == re.kkt_history
    assert cc == ce and bc == be
    assert rc.n_host_syncs == len(rc.kkt_history)
    assert re.n_host_syncs > rc.n_host_syncs


@pytest.mark.gpu
def test_captured_step_warm_start_and_reuse(cuda):
    """A warm start on the card reads once more (its probe); an engine
    passed to two solves captures each step once and replays it in the
    second solve, with the same result."""
    from repro_torch.core import L1, Quadratic, lambda_max, make_engine, solve
    from repro_torch.core.engine import DenseDesign
    rng = np.random.default_rng(0)
    X = rng.standard_normal((200, 400))
    y = X[:, :5].sum(1) + 0.1 * rng.standard_normal(200)
    X = DenseDesign.from_dense(X, cuda)
    lam = lambda_max(X, y, device=cuda) / 10
    eng = make_engine(L1(lam), Quadratic(), device=cuda)
    r1 = solve(X, y, Quadratic(), L1(lam), tol=1e-8, engine=eng)
    n_graphs = len(eng.captures)
    r2 = solve(X, y, Quadratic(), L1(lam), tol=1e-8, engine=eng)
    assert len(eng.captures) == n_graphs and set(eng.captures.values()) == {1}
    assert torch.equal(r1.beta, r2.beta)
    warm = solve(X, y, Quadratic(), L1(lam), tol=1e-8, beta0=r1.beta)
    assert r1.n_host_syncs == len(r1.kkt_history)
    assert warm.n_host_syncs == len(warm.kkt_history) + 1
    eng.release_graphs()


# ------------------------------- cluster plans that step down (P2)
@pytest.mark.gpu
@pytest.mark.parametrize("C", [1, 2, 4, 8, 16])
def test_forced_cluster_sizes_match_plain(cuda, C):
    """K1 (K = 1024), K1b (K = 1024, T = 20) and K2 (K = 512, n = 10,000)
    at each cluster size a plan steps down through: K1 and K1b equal the
    plain version bit for bit (each row takes its updates in the same
    order at every C), K2 within its tolerance (it sums its partials in
    rank order, so its rounding moves with C)."""
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_block_cuda,
                                              cd_epoch_gram_cuda,
                                              cd_epoch_xb_cuda,
                                              gram_block_plan, gram_plan,
                                              xb_plan)
    f64 = torch.float64
    args = _k1_case(1024, cuda) + (P.L1, penalty_params(P.L1(0.05), cuda))
    got = cd_epoch_gram_cuda(*args, epochs=3,
                             plan=gram_plan(1024, f64, cluster=C))
    assert _same(got, cd_epoch_gram_plain(*args, epochs=3))
    bargs = _gram_block_case(1024, 20, cuda) + (
        P.BlockL1, penalty_params(P.BlockL1(0.11), cuda))
    got = cd_epoch_gram_block_cuda(*bargs, epochs=3, plan=gram_block_plan(
        1024, 20, f64, cluster=C))
    assert _same(got, cd_epoch_gram_plain(*bargs, epochs=3))
    xargs, wt = _xb_case("logistic", True, 512, 10_000, cuda)
    got = cd_epoch_xb_cuda(*xargs, w=wt, epochs=3,
                           plan=xb_plan(10_000, True, f64, cluster=C))
    br, xr = cd_epoch_xb_plain(*xargs, w=wt, epochs=3)
    torch.testing.assert_close(got[0], br, atol=1e-11, rtol=1e-8)
    torch.testing.assert_close(got[1], xr, atol=1e-11, rtol=1e-8)


@pytest.mark.gpu
def test_solves_step_down_where_16_ctas_cannot_be_placed(cuda):
    """With a placement test that refuses 16 CTAs, a dense Lasso (K1 on a
    cluster), a logistic regression (K2) and a multitask Lasso (K1b on a
    cluster) complete on 8 CTAs (``ops.cluster_counts``): the Lasso and
    the multitask fit equal the 16-CTA fits bit for bit, the logistic fit
    agrees with it to 1e-6."""
    from repro_torch.core import (BlockL1, L1, Logistic, MultitaskQuadratic,
                                  Quadratic, lambda_max, solve)
    from repro_torch.data import (make_classification,
                                  make_correlated_design, make_multitask)
    from repro_torch.kernels import cd_epoch as cd
    X, y, _ = make_correlated_design(n=600, p=2000, n_nonzero=100, rho=0.5,
                                     snr=5.0, seed=0)
    Xl, yl, _ = make_classification(n=600, p=2000, n_nonzero=50, seed=0)
    Xm, Ym, _ = make_multitask(n=400, p=1500, n_tasks=20, n_nonzero=60,
                               seed=0)
    cases = [("cd_epoch_gram", X, y, Quadratic(),
              L1(lambda_max(X, y, device=cuda) / 20)),
             ("cd_epoch_xb", Xl, yl, Logistic(),
              L1(lambda_max(Xl, yl, Logistic(), device=cuda) / 5)),
             ("cd_epoch_gram_block", Xm, Ym, MultitaskQuadratic(),
              BlockL1(lambda_max(Xm, Ym, MultitaskQuadratic(),
                                 device=cuda) / 20))]
    for kernel, Xc, yc, datafit, penalty in cases:
        runs = {}
        for refuse in (False, True):
            ops.reset_launch_counts()
            if refuse:
                with cd.placement(lambda k, plan, dt: plan.cluster <= 8):
                    res = solve(Xc, yc, datafit, penalty, tol=1e-8)
            else:
                res = solve(Xc, yc, datafit, penalty, tol=1e-8)
            runs[refuse] = (res, ops.cluster_counts()[kernel])
        (r16, c16), (r8, c8) = runs[False], runs[True]
        assert r16.converged and r8.converged
        assert c16.get(16, 0) > 0 and 8 not in c16
        assert c8.get(8, 0) > 0 and 16 not in c8
        assert sum(c8.values()) == sum(c16.values()) or kernel == \
            "cd_epoch_xb"
        if kernel == "cd_epoch_xb":
            torch.testing.assert_close(r8.beta, r16.beta, atol=1e-6, rtol=0)
        else:
            assert torch.equal(r8.beta, r16.beta)


# ------------------------------- hyper-parameters from a device buffer
def _param_case(name, dev):
    """(wrapper call taking the params vector, plain call, bounds, scalar
    or block penalty pair) of the kernel `name` at a small shape."""
    rng = np.random.default_rng(11)
    pens = (P.MCP(0.11, 3.0), P.MCP(0.05, 2.5))
    bpens = (P.BlockMCP(0.11, 3.0), P.BlockMCP(0.05, 2.5))
    if name in ("k1", "k1b"):
        K, T = (256, 1) if name == "k1" else (256, 20)
        X = rng.standard_normal((3 * K, K))
        G = X.T @ X / (3 * K)
        shape = (K,) if name == "k1" else (K, T)
        beta0 = rng.standard_normal(shape) * 0.1
        G, c, beta0, L = _on(dev, G, X.T @ rng.standard_normal(
            (3 * K,) + shape[1:]) / (3 * K), beta0, np.diag(G))
        G = G.t().contiguous().t()
        args = (G, c, beta0, G @ beta0, L)
        pair = pens if name == "k1" else bpens
        wrapper = ops.cd_epoch_gram if name == "k1" \
            else ops.cd_epoch_gram_block
        return (lambda prm: wrapper(*args, type(pair[0]), prm, epochs=2),
                lambda prm: cd_epoch_gram_plain(*args, type(pair[0]), prm,
                                                epochs=2),
                (1e-12, 1e-5), pair)
    if name == "k2":
        K, n = 128, 3000
        Xt = rng.standard_normal((K, n))
        beta0 = rng.standard_normal(K) * 0.05
        Xt, y, beta0, L, off = _on(dev, Xt, np.sign(rng.standard_normal(n)),
                                   beta0, np.sum(Xt * Xt, 1) / (4 * n),
                                   np.zeros(K))
        args = (Xt, y, beta0, beta0 @ Xt, L, off, P.MCP)
        return (lambda prm: ops.cd_epoch_xb(*args, prm, "logistic",
                                            epochs=2),
                lambda prm: cd_epoch_xb_plain(*args, prm, "logistic",
                                              epochs=2),
                (1e-11, 1e-8), pens)
    n, p = 500, 3000
    X = rng.standard_normal((n, p))
    if name == "k3b":
        T = 20
        beta = rng.standard_normal((p, T)) * (rng.random((p, 1)) < 0.3)
        Xt, R, beta, L, off = _on(dev, X.T, rng.standard_normal((n, T)),
                                  beta, np.sum(X * X, 0) / n, np.zeros(p))
        gs = bpens[0].generalized_support(beta)
        args = (Xt, R, beta, L, off, gs, P.BlockMCP)
        return (lambda prm: ops.fused_ws_block(*args, prm, 256)[:3],
                lambda prm: fused_ws_plain(*args, prm, 256)[:3],
                (1e-12, 1e-10), bpens)
    beta = rng.standard_normal(p) * (rng.random(p) < 0.3)
    Xt, r, beta, L, off = _on(dev, X.T, rng.standard_normal(n), beta,
                              np.sum(X * X, 0) / n, np.zeros(p))
    if name == "k3":
        gs = pens[0].generalized_support(beta)
        args = (Xt, r, beta, L, off, gs, P.MCP)
        return (lambda prm: ops.fused_ws(*args, prm, 256)[:4],
                lambda prm: fused_ws_plain(*args, prm, 256)[:3] + (
                    select_working_set(fused_ws_plain(*args, prm, 256)[0],
                                       gs, 256),),
                (1e-12, 1e-10), pens)
    args = (Xt, r, beta, L, off, P.MCP)
    return (lambda prm: (ops.ws_score(*args, prm),),
            lambda prm: (ws_score_plain(*args, prm),), (1e-12, 1e-11), pens)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["k1", "k1b", "k2", "k3", "k3b", "k4"])
def test_kernel_params_from_device_buffer(cuda, name):
    """K1, K1b, K2, K3, K3b and K4 read the penalty's hyper-parameters from
    a vector on the card, and refuse one on the host: with it they equal
    their plain versions as with the host vector, and a graph captured over
    a static vector at one (lam, gamma) and replayed after new values are
    written into it equals an eager launch at the new values bit for
    bit."""
    call, plain, (atol, rtol), (pen1, pen2) = _param_case(name, cuda)
    # the one contract: a vector off the kernel's device raises (no hidden
    # copy); the plain versions take the host vector
    with pytest.raises(ValueError, match="must lie on the kernel's device"):
        call(penalty_params(pen1))
    for pen in (pen1, pen2):
        got = call(penalty_params(pen, cuda))
        want = plain(penalty_params(pen))
        for g, w in zip(got, want):
            if g.dtype == torch.int64 or g.dtype == torch.int32:
                assert torch.equal(g, w)
            else:
                torch.testing.assert_close(g, w, atol=atol, rtol=rtol)
    static = penalty_params(pen1, cuda)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        call(static)                               # warm-up off the graph
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        captured = call(static)
    static.copy_(penalty_params(pen2, cuda))
    graph.replay()
    eager = call(penalty_params(pen2, cuda))
    for g, e in zip(captured, eager):
        assert torch.equal(g, e)
    static.copy_(penalty_params(pen1, cuda))
    graph.replay()
    for g, e in zip(captured, call(penalty_params(pen1, cuda))):
        assert torch.equal(g, e)


# ------------------------------------------------- regularization paths
def _path_problem(dev):
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_correlated_design
    X, y, _ = make_correlated_design(n=1000, p=2000, n_nonzero=50, rho=0.5,
                                     snr=5.0, seed=0)
    return DenseDesign.from_dense(X, dev), y


@pytest.mark.gpu
def test_one_capture_per_bucket_over_30_lambda_path(cuda):
    """The port's ``test_one_compile_per_bucket_over_30_lambda_path``
    (tests/test_engine.py): a 30-lambda Lasso path (n = 1000, p = 2000)
    captures each step key once, every key's bucket on the ladder, every
    lambda converged, one read a step."""
    from repro_torch.core import (L1, BucketPolicy, Quadratic, make_engine,
                                  reg_path)
    design, y = _path_problem(cuda)
    eng = make_engine(L1(1.0), Quadratic(), device=cuda)
    path = reg_path(design, y, L1(1.0), n_lambdas=30, lambda_min_ratio=1e-2,
                    tol=1e-6, engine=eng)
    assert np.all(path.kkts <= 1e-6)
    assert path.captures, "the engine captured nothing"
    ladder = set(BucketPolicy(p0=64).ladder(2000))
    for key, count in path.captures.items():
        assert count == 1, f"key {key} captured {count}x"
        assert key[0] in ladder
    assert len(path.captures) <= len(ladder)
    steps = path.n_outer + (path.kkts <= 1e-6)
    assert path.n_host_syncs == int(np.sum(steps)) + 29 + 2
    eng.release_graphs()


@pytest.mark.gpu
@pytest.mark.parametrize("penalty", ["L1", "MCP"])
def test_captured_path_equals_eager_path(cuda, penalty):
    """A path whose graphs, captured at its first lambdas, replay at every
    later one equals the path run with ``capture=False`` (the same step
    with its conditions read on the host) bit for bit, with the same
    epochs and launch counts."""
    from repro_torch.core import L1, MCP, Quadratic, make_engine, reg_path
    design, y = _path_problem(cuda)
    pen = L1(1.0) if penalty == "L1" else MCP(1.0, 3.0)
    out = {}
    for capture in (True, False):
        eng = make_engine(pen, Quadratic(), device=cuda, capture=capture)
        ops.reset_launch_counts()
        out[capture] = (reg_path(design, y, pen, n_lambdas=12, tol=1e-8,
                                 engine=eng), ops.launch_counts())
        eng.release_graphs()
    (pc, cc), (pe, ce) = out[True], out[False]
    assert np.all(pc.kkts <= 1e-8)
    assert np.array_equal(pc.betas, pe.betas)
    assert np.array_equal(pc.n_epochs, pe.n_epochs)
    assert np.array_equal(pc.kkts, pe.kkts)
    assert cc == ce
    assert set(pc.captures.values()) == {1} and not pe.captures


@pytest.mark.gpu
def test_screened_csc_path_reuses_its_slots(cuda):
    """A gap-safe screened path on a CSC design writes each lambda's
    survivors into a slot design of its width in place: each step key is
    captured once, fewer slot designs than screened solves, K5 on every
    screen and head, and the solutions within 1e-7 of the unscreened
    path."""
    from repro_torch.core import L1, reg_path
    from repro_torch.data import make_sparse_design
    from repro_torch.sparse import CSCDesign
    X, y, _ = make_sparse_design(n=2000, p=8000, density=5e-3, n_nonzero=40,
                                 seed=1)
    d = CSCDesign.from_scipy(X, ell=True, device=cuda)
    kw = dict(n_lambdas=8, lambda_min_ratio=0.05, tol=1e-9, device=cuda)
    ref = reg_path(d, y, L1(1.0), **kw)
    ops.reset_launch_counts()
    scr = reg_path(d, y, L1(1.0), screen="gap_safe", **kw)
    assert np.all(scr.kkts <= 1e-9)
    np.testing.assert_allclose(scr.betas, ref.betas, atol=1e-7)
    assert set(scr.captures.values()) == {1}
    designs = {key[1] for key in scr.captures}
    solved = int(np.sum(scr.screened_fracs < 1.0))
    assert 0 < len(designs) < solved
    assert ops.launch_counts()["csc_score"] >= len(scr.lambdas) + \
        int(np.sum(scr.n_outer))


@pytest.mark.gpu
def test_screened_dense_path_drops_outgrown_slots(cuda, monkeypatch):
    """A gap-safe screened dense path refills its slot designs and, as the
    survivors widen, frees the slots it outgrew with their graphs: after
    the path the engine's graphs read one slot design, and every other
    slot it made is freed (before, every narrower slot stayed alive in its
    graphs, about one more slot of memory beside X)."""
    import gc
    import weakref
    from repro_torch.core import L1, Quadratic, make_engine, reg_path
    from repro_torch.core.engine import DenseDesign
    design, y = _path_problem(cuda)
    eng = make_engine(L1(1.0), Quadratic(), device=cuda)
    kw = dict(n_lambdas=20, lambda_min_ratio=0.05, tol=1e-9, engine=eng)
    ref = reg_path(design, y, L1(1.0), **kw)
    eng.release_graphs()
    made = []
    take = DenseDesign.take_columns

    def recording(self, idx, out=None):
        sub = take(self, idx, out=out)
        if out is None:
            made.append(weakref.ref(sub))
        return sub

    monkeypatch.setattr(DenseDesign, "take_columns", recording)
    scr = reg_path(design, y, L1(1.0), screen="gap_safe", **kw)
    np.testing.assert_allclose(scr.betas, ref.betas, atol=1e-7)
    assert np.all(scr.kkts <= 1e-9)
    assert set(scr.captures.values()) == {1}
    assert scr.diagnostics["slot_refills"] > 0
    assert len(made) == scr.diagnostics["slots_made"] > 1
    slots = {id(g.design) for g in eng._graphs.values()}
    gc.collect()
    alive = [id(r()) for r in made if r() is not None]
    assert len(slots) == 1 and alive == list(slots)
    eng.release_graphs()


# ------------------------------------------------------------ lane kernels
def _lane_params(pen, S, dev, seed=0):
    """[S, arity] codec rows of `pen` on `dev`, its first hyper-parameter
    (lam, or Box's C) scaled per lane."""
    rows = penalty_params(pen).repeat(S, 1)
    rows[:, 0] *= torch.as_tensor(np.random.default_rng(seed).uniform(
        0.5, 1.5, S))
    return rows.to(dev)


def _gram_lanes(S, K, dev, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn(3 * K, K, generator=g, dtype=torch.float64).to(dev)
    G0 = X.T @ X / (3 * K)
    scale = 1.0 + 0.01 * torch.arange(S, dtype=torch.float64, device=dev)
    G = (G0[None] * scale[:, None, None]).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    c = torch.randn(S, K, generator=g, dtype=torch.float64).to(dev) * 0.1
    beta0 = (0.1 * torch.randn(S, K, generator=g,
                               dtype=torch.float64)).to(dev)
    q0 = (G @ beta0[..., None])[..., 0]
    L = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    return G, c, beta0, q0, L


@pytest.mark.gpu
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
@pytest.mark.parametrize("S,K", [(1, 31), (10, 256), (7, 1025)])
def test_k1_lanes_cuda_equals_k1_lane_by_lane(cuda, pen, S, K):
    """K1l equals K1 launched on each lane's inputs and parameter row bit
    for bit (one CTA a lane for K <= 256, a cluster a lane above); frozen
    lanes come back unchanged; within K1's bound of the plain version."""
    G, c, beta0, q0, L = _gram_lanes(S, K, cuda, seed=K)
    params = _lane_params(pen, S, cuda, seed=S)
    active = torch.arange(S, device=cuda) % 3 != 1
    n0 = ops.cd_epoch_gram_lanes.launches
    b, q = ops.cd_epoch_gram_lanes(G, c, beta0, q0, L, type(pen), params,
                                   active, epochs=2)
    assert ops.cd_epoch_gram_lanes.launches == n0 + 1
    for s in range(S):
        if not active[s]:
            assert torch.equal(b[s], beta0[s]) and torch.equal(q[s], q0[s])
            continue
        bs, qs = ops.cd_epoch_gram(G[s], c[s], beta0[s], q0[s], L[s],
                                   type(pen), params[s], epochs=2)
        assert torch.equal(b[s], bs) and torch.equal(q[s], qs), s
    s = int(torch.nonzero(active)[0])
    bp, qp = cd_epoch_gram_plain(G[s], c[s], beta0[s], q0[s], L[s],
                                 type(pen), params[s], epochs=2)
    torch.testing.assert_close(b[s], bp, atol=1e-12, rtol=1e-5)
    torch.testing.assert_close(q[s], qp, atol=1e-12, rtol=1e-5)


@pytest.mark.gpu
@pytest.mark.parametrize("pen", [P.L1(0.11), P.MCP(0.11, 3.0)],
                         ids=["L1", "MCP"])
@pytest.mark.parametrize("K", [1024, 4096])
def test_k1_lanes_cuda_every_lane_cluster_equals_k1(cuda, pen, K):
    """At S = 10, K1l on each cluster size the lane plan can choose (the
    clusters of STEP_DOWN), forced, equals K1 on each lane's inputs bit
    for bit; frozen lanes come back unchanged; and the plan K1l takes
    there is one of them."""
    from repro_torch.kernels.cd_epoch import (STEP_DOWN,
                                              cd_epoch_gram_lanes_cuda,
                                              gram_lanes_plan, gram_plan)
    S = 10
    G, c, beta0, q0, L = _gram_lanes(S, K, cuda, seed=K)
    params = _lane_params(pen, S, cuda, seed=S)
    active = torch.arange(S, device=cuda) % 3 != 1
    refs = [ops.cd_epoch_gram(G[s], c[s], beta0[s], q0[s], L[s], type(pen),
                              params[s], epochs=2) for s in range(S)]
    sizes = STEP_DOWN[:-1]
    assert gram_lanes_plan(S, K, torch.float64).cluster in sizes
    for C in sizes:
        b, q = cd_epoch_gram_lanes_cuda(
            G, c, beta0, q0, L, type(pen), params, active, epochs=2,
            plan=gram_plan(K, torch.float64, cluster=C))
        for s in range(S):
            want = refs[s] if active[s] else (beta0[s], q0[s])
            assert torch.equal(b[s], want[0]) and torch.equal(q[s], want[1]), \
                (C, s)


@pytest.mark.gpu
def test_k1_lanes_instances_use_no_local_memory(cuda):
    """K1l's float64 instances (one CTA and the cluster, every penalty)
    spill nothing: their local bytes a thread are K1's of the same
    penalty (0, but for L05, whose prox calls pow: a 40-byte call frame
    on both), within the 128 registers of 512 threads."""
    from repro_torch.kernels.cd_epoch import gram_kernel_attrs_cuda
    from repro_torch.kernels.common import (PENALTY_IDS,
                                            SCALAR_COORD_PENALTIES)
    for cls in SCALAR_COORD_PENALTIES:
        pen = PENALTY_IDS[cls]
        for cluster in (False, True):
            regs, local = gram_kernel_attrs_cuda(True, cluster, pen)
            k1_local = gram_kernel_attrs_cuda(False, cluster, pen)[1]
            assert local == k1_local and 0 < regs <= 128, \
                (cls.__name__, cluster, regs, local, k1_local)
            assert local == 0 or cls is P.L05


@pytest.mark.gpu
@pytest.mark.parametrize("wform", [None, "shared", "lanes"])
def test_k2_lanes_cuda_equals_k2_lane_by_lane(cuda, wform):
    """K2l (weighted logistic) equals K2 on each lane bit for bit and its
    plain version within K2's bound; frozen lanes come back unchanged."""
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_lanes_plain
    S, K, n = 5, 128, 3000
    g = torch.Generator(device="cpu").manual_seed(9)
    Xt = torch.randn(S, K, n, generator=g, dtype=torch.float64).to(cuda)
    y = torch.sign(torch.randn(n, generator=g, dtype=torch.float64)).to(cuda)
    beta0 = (0.05 * torch.randn(S, K, generator=g,
                                dtype=torch.float64)).to(cuda)
    Xb0 = (beta0[:, None, :] @ Xt)[:, 0]
    L = torch.sum(Xt * Xt, dim=2) / (4 * n)
    off = torch.zeros(S, K, dtype=torch.float64, device=cuda)
    w = None
    if wform == "shared":
        w = (torch.rand(n, generator=g, dtype=torch.float64) + 0.5).to(cuda)
    elif wform == "lanes":
        w = (torch.rand(S, n, generator=g, dtype=torch.float64)
             + 0.5).to(cuda)
    params = _lane_params(P.L1(0.002), S, cuda)
    active = torch.tensor([True, False, True, True, False], device=cuda)
    b, x = ops.cd_epoch_xb_lanes(Xt, y, beta0, Xb0, L, off, P.L1, params,
                                 active, "logistic", w=w, epochs=2)
    bp, xp = cd_epoch_xb_lanes_plain(Xt, y, beta0, Xb0, L, off, P.L1,
                                     params, active, "logistic", w=w,
                                     epochs=2)
    torch.testing.assert_close(b, bp, atol=1e-11, rtol=1e-8)
    torch.testing.assert_close(x, xp, atol=1e-11, rtol=1e-8)
    for s in range(S):
        if not active[s]:
            assert torch.equal(b[s], beta0[s]) and torch.equal(x[s], Xb0[s])
            continue
        ws = w if w is None or w.ndim == 1 else w[s]
        bs, xs = ops.cd_epoch_xb(Xt[s], y, beta0[s], Xb0[s], L[s], off[s],
                                 P.L1, params[s], "logistic", w=ws, epochs=2)
        assert torch.equal(b[s], bs) and torch.equal(x[s], xs), s


@pytest.mark.gpu
@pytest.mark.parametrize("ties", [False, True], ids=["random", "ties"])
@pytest.mark.parametrize("ws", [64, 1024])
@pytest.mark.parametrize("S", [6, 50])
def test_k3_lanes_cuda_matches_plain(cuda, ties, ws, S):
    """K3l against its plain version lane by lane: scores and gradient
    within K3's bounds (equal on integer data), cand_idx exact, each lane's
    working set ``select_working_set`` of its plain scores, its rows bit
    for bit; the L rows p apart or broadcast. S = 6 runs the narrow
    product, S = 50 (the (g4) grid's lanes) the wide one."""
    from repro_torch.kernels.fused_ws import fused_ws_lanes_plain
    n, p = 500, 5000
    g = torch.Generator(device="cpu").manual_seed(4)
    if ties:
        Xt = torch.randint(-2, 3, (p, n), generator=g).to(torch.float64)
        R = torch.randint(-2, 3, (n, S), generator=g).to(torch.float64)
        beta = torch.randint(-1, 2, (S, p), generator=g).to(torch.float64)
        pen = P.L1(0.5)
    else:
        Xt = torch.randn(p, n, generator=g, dtype=torch.float64)
        R = torch.randn(n, S, generator=g, dtype=torch.float64)
        beta = torch.randn(S, p, generator=g, dtype=torch.float64) * \
            (torch.rand(S, p, generator=g) < 0.3)
        pen = P.MCP(0.11, 3.0)
    Xt, R, beta = Xt.to(cuda), R.to(cuda), beta.to(cuda)
    L = torch.clamp(torch.sum(Xt * Xt, dim=1) / n, min=1e-12)
    off = torch.zeros(p, dtype=torch.float64, device=cuda)
    params = _lane_params(pen, S, cuda)
    gs = torch.stack([type(pen)(*params[s].tolist()).generalized_support(
        beta[s]) for s in range(S)])
    for Ls in (L.expand(S, p), L[None] * (1 + 0.1 * torch.rand(
            S, p, generator=g).to(cuda))):
        Ls = Ls if Ls.stride(0) == 0 else Ls.contiguous()
        n0 = ops.fused_ws_lanes.launches
        sk, gk, ik, wk, xk = ops.fused_ws_lanes(Xt, R, beta, Ls, off, gs,
                                                type(pen), params, ws)
        assert ops.fused_ws_lanes.launches == n0 + 1
        sr, gr, ir, cr = fused_ws_lanes_plain(Xt, R, beta, Ls, off, gs,
                                              type(pen), params, ws)
        if ties:
            assert torch.equal(sk, sr) and torch.equal(gk, gr)
        torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
        torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
        assert torch.equal(ik, ir)
        for s in range(S):
            assert torch.equal(wk[s], select_working_set(sr[s], gs[s], ws))
            assert torch.equal(xk[s], Xt[wk[s]])


@pytest.mark.gpu
@pytest.mark.parametrize("S,T,n,p", [(5, 5, 500, 5000), (10, 20, 1000, 3000),
                                     (10, 50, 305, 7498)])
def test_k3b_lanes_cuda_repeats_bit_for_bit(cuda, S, T, n, p):
    """K3bl launched twice on the same inputs (every SM's shared memory
    NaN-filled before each) gives the same bits in all five outputs: the
    captured graphs' equality with ``capture=False`` rests on it. The
    plan's one wide launch covers all S*T columns."""
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    from repro_torch.kernels.fused_ws import card_product_plan
    g = torch.Generator(device="cpu").manual_seed(S + T)
    Xt = torch.randn(p, n, generator=g, dtype=torch.float64).to(cuda)
    R = (torch.randn(n, S * T, generator=g, dtype=torch.float64)
         / n ** 0.5).to(cuda)
    beta = (0.2 * torch.randn(S, p, T, generator=g, dtype=torch.float64)
            * (torch.rand(S, p, 1, generator=g) < 0.3)).to(cuda)
    L = (torch.sum(Xt * Xt, dim=1) / n).expand(S, p)
    off = torch.zeros(p, dtype=torch.float64, device=cuda)
    gs = torch.linalg.vector_norm(beta, dim=2) != 0
    args = (Xt, R, beta, L, off, gs, P.BlockL1,
            _lane_params(P.BlockL1(0.11), S, cuda), 256)
    fill_shared_memory_cuda(cuda)
    first = ops.fused_ws_block_lanes(*args)
    fill_shared_memory_cuda(cuda)
    assert _same(ops.fused_ws_block_lanes(*args), first)
    plan = card_product_plan(Xt, S * T)
    assert plan.ld == S * T and plan.col_tiles * plan.bn >= S * T


@pytest.mark.gpu
@pytest.mark.parametrize("N", [1, 8, 24, 25, 91, 200, 500])
@pytest.mark.parametrize("n,p", [(500, 3000), (301, 777)])
def test_product_configurations_match_mm(cuda, N, n, p):
    """The float64 product the plan picks (the narrow kernel to N = 24, the
    wide one above) on R [n, N] with the plan's spans: the spans' partials
    summed equal Xt @ R within 1e-12 + 1e-10 |ref| and a second launch
    gives the same bits (the narrow scratch's columns past N, which no
    launch writes, left out); the card's shared memory fits a CTA and its
    occupancy is the one ``tests/test_torch_k3bl_plan.py`` assumes."""
    from repro_torch.kernels._build import BUILD
    from repro_torch.kernels.fused_ws import card_product_plan, product_cuda
    g = torch.Generator(device="cpu").manual_seed(N)
    Xt = torch.randn(p, n, generator=g, dtype=torch.float64).to(cuda)
    R = torch.randn(n, N, generator=g, dtype=torch.float64).to(cuda)
    ref = Xt @ R
    lib = BUILD.lib("fused_ws")
    for wide, per_sm in ((0, 4), (1, 2)):
        assert 0 < lib.fused_ws_product_info(wide, 0) <= 232_448
        assert lib.fused_ws_product_info(wide, 1) == per_sm
    plan = card_product_plan(Xt, N)
    assert plan.wide == (N > 24)
    part = product_cuda(Xt, R, plan)[..., :N]
    torch.testing.assert_close(part.sum(0), ref, atol=1e-12, rtol=1e-10)
    assert torch.equal(part, product_cuda(Xt, R, plan)[..., :N])


# ------------------------------------------------------- lanes and grids
@pytest.mark.gpu
def test_captured_chunked_path_equals_eager(cuda):
    """reg_path(vmap_chunk=4) on the kernel route: one captured graph a
    (bucket, lane count) key, each captured once, one read a dispatch,
    equal bit for bit to ``capture=False`` and within 1e-6 of the
    sequential path."""
    from repro_torch.core import L1, Quadratic, make_engine, reg_path
    design, y = _path_problem(cuda)
    kw = dict(n_lambdas=12, lambda_min_ratio=1e-2, tol=1e-8, vmap_chunk=4)
    eng = make_engine(L1(1.0), Quadratic(), device=cuda)
    a = reg_path(design, y, L1(1.0), engine=eng, **kw)
    b = reg_path(design, y, L1(1.0),
                 engine=make_engine(L1(1.0), Quadratic(), device=cuda,
                                    capture=False), **kw)
    seq = reg_path(design, y, L1(1.0), n_lambdas=12, lambda_min_ratio=1e-2,
                   tol=1e-8, device=cuda)
    assert np.all(a.kkts <= 1e-8)
    assert a.captures and set(a.captures.values()) == {1}
    assert {k[3] for k in a.captures} == {4}
    assert np.array_equal(a.betas, b.betas) and \
        np.array_equal(a.n_epochs, b.n_epochs)
    assert np.max(np.abs(a.betas - seq.betas)) < 1e-6
    assert eng.n_chunk_reads == eng.n_dispatches


@pytest.mark.gpu
def test_cv_grid_budget_5x30_on_card(cuda):
    """``test_cv_grid.py:161`` on the card's kernel route: each key
    captured once with one lane count (50), one read a dispatch, no more
    dispatches than outer steps, an interior minimum, equal bit for bit to
    ``capture=False``; a second grid on the same engine and design
    captures nothing."""
    from repro_torch.core import L1, Quadratic, cross_val_path, make_engine
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_correlated_design
    X, y, _ = make_correlated_design(n=200, p=400, n_nonzero=15, seed=1)
    # one design for both grids: a captured step reads its design in place
    X = DenseDesign.from_dense(X, cuda)
    eng = make_engine(L1(1.0), Quadratic(), device=cuda)
    kw = dict(n_lambdas=30, cv=5, tol=1e-8, vmap_chunk=10)
    g = cross_val_path(X, y, Quadratic(), L1(1.0), engine=eng, **kw)
    assert np.max(g.kkts) <= 1e-8
    assert g.captures and set(g.captures.values()) == {1}
    assert {k[3] for k in g.captures} == {50}
    assert 0 < g.n_dispatches <= g.n_outer
    assert g.n_host_syncs == g.n_dispatches
    assert 0 < g.best_index < 29
    o = cross_val_path(X, y, Quadratic(), L1(1.0),
                       engine=make_engine(L1(1.0), Quadratic(), device=cuda,
                                          capture=False), **kw)
    assert np.array_equal(g.betas, o.betas)
    assert np.array_equal(g.cv_loss, o.cv_loss)
    assert np.array_equal(g.kkts, o.kkts)
    before = dict(eng.captures)
    g2 = cross_val_path(X, y, Quadratic(), L1(1.0), engine=eng, seed=7,
                        **kw)
    assert dict(eng.captures) == before and g2.n_dispatches > 0


@pytest.mark.gpu
def test_sparse_grid_on_card_runs_k5b_and_k5s(cuda):
    """A CSC grid on the kernel route: K5b at T = lanes on the heads, K5s
    once a fold, K1l inside, within 1e-8 of the plain route."""
    import scipy.sparse as sp
    from repro_torch.core import L1, Quadratic, cross_val_path
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(2)
    Xs = sp.random(600, 3000, density=0.02, random_state=2, format="csc")
    beta = np.zeros(3000)
    beta[:20] = rng.standard_normal(20)
    y = np.asarray(Xs @ beta) + 0.1 * rng.standard_normal(600)
    d = CSCDesign.from_scipy(Xs, ell=True, device=cuda)
    kw = dict(n_lambdas=5, cv=3, tol=1e-10, vmap_chunk=2,
              lambda_min_ratio=0.1)
    ops.reset_launch_counts()
    g = cross_val_path(d, y, Quadratic(), L1(1.0), device=cuda, **kw)
    counts = ops.launch_counts()
    assert counts["csc_score_block"] > 0 and counts["cd_epoch_gram_lanes"] > 0
    assert counts["csc_weighted_col_sq"] == 3
    assert counts["csc_score"] == 0 and counts["cd_epoch_gram"] == 0
    plain = cross_val_path(d, y, Quadratic(), L1(1.0), device=cuda,
                           use_kernels=False, **kw)
    assert np.max(g.kkts) <= 1e-10
    assert np.max(np.abs(g.betas - plain.betas)) < 1e-8


# ------------------------------------------------------ multitask lanes
def _gram_block_lanes(S, K, T, dev, seed=0):
    """K1bl inputs: lane s's G the Gram of one 3K x K design scaled by
    1 + 0.01 s (column-major), its own c and beta0 (half its rows zero),
    q0 = G beta0, L = diag(G)."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.randn(3 * K, K, generator=g, dtype=torch.float64).to(dev)
    G0 = X.T @ X / (3 * K)
    scale = 1.0 + 0.01 * torch.arange(S, dtype=torch.float64, device=dev)
    G = (G0[None] * scale[:, None, None]).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    c = (0.1 * torch.randn(S, K, T, generator=g, dtype=torch.float64)).to(dev)
    beta0 = (0.1 * torch.randn(S, K, T, generator=g, dtype=torch.float64)
             * (torch.rand(S, K, 1, generator=g) < 0.5)).to(dev)
    q0 = G @ beta0
    L = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    return G, c, beta0, q0, L


@pytest.mark.gpu
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
@pytest.mark.parametrize("S,K,T", [(5, 64, 50), (4, 256, 20), (3, 1024, 20),
                                   (2, 2048, 240)])
def test_k1b_lanes_cuda_equals_k1b_lane_by_lane(cuda, pen, S, K, T):
    """K1bl equals K1b launched on each lane's inputs and parameter row bit
    for bit on K1b's one-CTA branch (K * T within its threshold) and its cluster
    branches (q's rows in shared and in global memory), every SM's shared
    memory NaN-filled first; frozen lanes come back unchanged; within K1's
    bound of the plain version."""
    from repro_torch.kernels.cd_epoch import (fill_shared_memory_cuda,
                                              gram_block_plan)
    G, c, beta0, q0, L = _gram_block_lanes(S, K, T, cuda, seed=K + T)
    params = _lane_params(pen, S, cuda, seed=S)
    active = torch.arange(S, device=cuda) % 3 != 1
    branch = gram_block_plan(K, T, torch.float64).branch
    n0 = ops.cd_epoch_gram_block_lanes.launches
    b0 = ops.cd_epoch_gram_block_lanes.branch_launches[branch]
    fill_shared_memory_cuda(cuda)
    b, q = ops.cd_epoch_gram_block_lanes(G, c, beta0, q0, L, type(pen),
                                         params, active, epochs=2)
    assert ops.cd_epoch_gram_block_lanes.launches == n0 + 1
    assert ops.cd_epoch_gram_block_lanes.branch_launches[branch] == b0 + 1
    for s in range(S):
        if not active[s]:
            assert torch.equal(b[s], beta0[s]) and torch.equal(q[s], q0[s])
            continue
        bs, qs = ops.cd_epoch_gram_block(G[s], c[s], beta0[s], q0[s], L[s],
                                         type(pen), params[s], epochs=2)
        assert torch.equal(b[s], bs) and torch.equal(q[s], qs), s
    assert torch.any(b[0] != beta0[0])
    bp, qp = cd_epoch_gram_plain(G[0], c[0], beta0[0], q0[0], L[0],
                                 type(pen), params[0], epochs=2)
    torch.testing.assert_close(b[0], bp, atol=1e-12, rtol=1e-5)
    torch.testing.assert_close(q[0], qp, atol=1e-12, rtol=1e-5)


# the one-CTA block epoch at the grids' shapes (the leadfield's K = 64, T =
# 50; (m4)'s K = 512, T = 5), T past a warp (33) and at the chain's 64, one
# row, K = 2 and 3 (the next rows wrap), G whole and through its ring
ONECTA = [(3, 64, 50), (4, 512, 5), (2, 256, 20), (3, 128, 20), (2, 64, 33),
          (2, 20, 64), (3, 1, 7), (2, 2, 5), (2, 3, 1), (2, 2049, 1)]


@pytest.mark.gpu
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
@pytest.mark.parametrize("S,K,T", ONECTA)
def test_k1b_onecta_equals_emulation(cuda, pen, S, K, T):
    """K1bl and K1b on the one-CTA kernel equal ``emulate_block_epoch``
    bit for bit (beta and q, 1 and 3 epochs), every SM's shared memory
    NaN-filled first, every third lane frozen and unchanged, row 1's L = 0;
    K1bl equals K1b lane by lane."""
    from repro_torch.kernels.cd_epoch import (emulate_block_epoch,
                                              fill_shared_memory_cuda,
                                              gram_block_plan)
    assert gram_block_plan(K, T, torch.float64).cluster == 1
    G, c, beta0, q0, L = _gram_block_lanes(S, K, T, cuda, seed=K + 3 * T)
    if K > 1:
        L[:, 1] = 0.0
    params = _lane_params(pen, S, cuda, seed=S + T)
    active = torch.arange(S, device=cuda) % 3 != 1
    for epochs in (1, 3):
        fill_shared_memory_cuda(cuda)
        got = ops.cd_epoch_gram_block_lanes(G, c, beta0, q0, L, type(pen),
                                            params, active, epochs=epochs)
        want = emulate_block_epoch(G, c, beta0, q0, L, type(pen), params,
                                   epochs=epochs, active=active)
        assert _same(got, want)
        for s in range(S):
            if not active[s]:
                assert torch.equal(got[0][s], beta0[s])
                assert torch.equal(got[1][s], q0[s])
                continue
            fill_shared_memory_cuda(cuda)
            one = ops.cd_epoch_gram_block(G[s], c[s], beta0[s], q0[s], L[s],
                                          type(pen), params[s],
                                          epochs=epochs)
            assert _same(one, (got[0][s], got[1][s])), s
    assert torch.any(got[0][0] != beta0[0])


@pytest.mark.gpu
@pytest.mark.parametrize("K,T", [(64, 50), (512, 5), (256, 20), (1024, 20),
                                 (300, 50)])
@pytest.mark.parametrize("threads", [None, 64, 512, 1024])
def test_k1b_onecta_layouts_equal_emulation(cuda, K, T, threads):
    """Every layout of the one-CTA kernel equals the emulation bit for bit:
    the plan's and forced thread counts (owners a multiple of T or not),
    q in registers or in shared memory (64 threads, and K * T past the
    registers' reach), beta and c in shared or global memory (K = 1024,
    T = 20: the step-down's last resort), in float64 and float32."""
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_block_cuda,
                                              emulate_block_epoch,
                                              fill_shared_memory_cuda,
                                              gram_block_plan)
    G, c, beta0, q0, L = (a[0] for a in _gram_block_lanes(1, K, T, cuda,
                                                          seed=K))
    for dtype in (torch.float64, torch.float32):
        args = tuple(a.to(dtype) for a in (G, c, beta0, q0, L)) + (
            P.BlockMCP, penalty_params(P.BlockMCP(0.11, 3.0), cuda))
        plan = gram_block_plan(K, T, dtype, cluster=1, threads=threads)
        fill_shared_memory_cuda(cuda)
        got = cd_epoch_gram_block_cuda(*args, epochs=2, plan=plan)
        assert _same(got, emulate_block_epoch(*args, epochs=2)), plan


@pytest.mark.gpu
@pytest.mark.parametrize("pen", BLOCK_PENALTIES, ids=BLOCK_IDS)
@pytest.mark.parametrize("S,T,n,p", [(4, 5, 500, 5000), (6, 20, 500, 5000),
                                     (3, 7, 301, 777), (5, 5, 500, 5000),
                                     (10, 50, 305, 2000)])
@pytest.mark.parametrize("ws", [64, 512])
def test_k3b_lanes_cuda_matches_plain(cuda, pen, S, T, n, p, ws):
    """K3bl against its plain version lane by lane (S*T of 20, 120, an odd
    21 with an odd n and a ragged tile, 25 (one column past a 24-wide
    tile) and the leadfield's 500 at n = 305, four column tiles): scores
    and gradient within K3's bounds, cand_idx exact, each lane's working
    set ``select_working_set`` of its plain scores and its rows bit for
    bit; L rows p apart or broadcast; shared memory NaN-filled before the
    launch."""
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    from repro_torch.kernels.fused_ws import fused_ws_block_lanes_plain
    g = torch.Generator(device="cpu").manual_seed(S * T)
    Xt = torch.randn(p, n, generator=g, dtype=torch.float64).to(cuda)
    R = (torch.randn(n, S * T, generator=g, dtype=torch.float64)
         / n ** 0.5).to(cuda)
    beta = (0.2 * torch.randn(S, p, T, generator=g, dtype=torch.float64)
            * (torch.rand(S, p, 1, generator=g) < 0.3)).to(cuda)
    L = torch.sum(Xt * Xt, dim=1) / n
    off = 0.01 * torch.randn(p, generator=g, dtype=torch.float64).to(cuda)
    params = _lane_params(pen, S, cuda)
    gs = torch.linalg.vector_norm(beta, dim=2) != 0
    ws = min(ws, p)
    for Ls in (L.expand(S, p), (L[None] * (1 + 0.1 * torch.rand(
            S, p, generator=g).to(cuda))).contiguous()):
        n0 = ops.fused_ws_block_lanes.launches
        fill_shared_memory_cuda(cuda)
        sk, gk, ik, wk, xk = ops.fused_ws_block_lanes(
            Xt, R, beta, Ls, off, gs, type(pen), params, ws)
        assert ops.fused_ws_block_lanes.launches == n0 + 1
        sr, gr, ir, _ = fused_ws_block_lanes_plain(Xt, R, beta, Ls, off, gs,
                                                   type(pen), params, ws)
        torch.testing.assert_close(sk, sr, atol=1e-12, rtol=1e-11)
        torch.testing.assert_close(gk, gr, atol=1e-12, rtol=1e-10)
        assert torch.equal(ik, ir)
        for s in range(S):
            assert torch.equal(wk[s], select_working_set(sr[s], gs[s], ws))
            assert torch.equal(xk[s], Xt[wk[s]])


@pytest.mark.gpu
@pytest.mark.parametrize("pen_name", ["BlockL1", "BlockMCP"])
def test_captured_multitask_lanes_equal_eager(cuda, pen_name):
    """reg_path(Y [n, T], vmap_chunk=3) and a multitask cross_val_path on
    the kernel route: K3bl on every dense head and K1bl in the Gram
    epochs, no scalar lane kernel, each key captured once, one read a
    dispatch, equal bit for bit to ``capture=False``; the path within
    1e-8 of the sequential one."""
    from repro_torch.core import (BlockL1, BlockMCP, MultitaskQuadratic,
                                  cross_val_path, make_engine, reg_path)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_multitask
    X, Y, _ = make_multitask(n=300, p=1200, n_tasks=8, n_nonzero=20, seed=0)
    design = DenseDesign.from_dense(X, cuda)
    pen = BlockL1(1.0) if pen_name == "BlockL1" else BlockMCP(1.0, 3.0)
    df = MultitaskQuadratic()
    eng = make_engine(pen, df, device=cuda)
    eager = make_engine(pen, df, device=cuda, capture=False)
    kw = dict(n_lambdas=8, lambda_min_ratio=0.05, tol=1e-10, vmap_chunk=3)
    ops.reset_launch_counts()
    a = reg_path(design, Y, pen, df, engine=eng, **kw)
    counts = ops.launch_counts()
    assert counts["fused_ws_block_lanes"] > 0
    assert counts["cd_epoch_gram_block_lanes"] > 0
    assert counts["fused_ws_lanes"] == counts["cd_epoch_gram_lanes"] == 0
    b = reg_path(design, Y, pen, df, engine=eager, **kw)
    seq = reg_path(design, Y, pen, df, n_lambdas=8, lambda_min_ratio=0.05,
                   tol=1e-10, device=cuda)
    assert a.betas.shape == (8, 1200, 8) and np.all(a.kkts <= 1e-10)
    assert set(a.captures.values()) == {1}
    assert np.array_equal(a.betas, b.betas)
    assert np.array_equal(a.n_epochs, b.n_epochs)
    assert np.max(np.abs(a.betas - seq.betas)) < 1e-8
    assert eng.n_chunk_reads == eng.n_dispatches
    g = cross_val_path(design, Y, df, pen, engine=eng, cv=3, n_lambdas=5,
                       lambda_min_ratio=0.1, tol=1e-10, vmap_chunk=2)
    o = cross_val_path(design, Y, df, pen, engine=eager, cv=3, n_lambdas=5,
                       lambda_min_ratio=0.1, tol=1e-10, vmap_chunk=2)
    assert g.betas.shape == (3, 5, 1200, 8) and np.max(g.kkts) <= 1e-10
    assert np.array_equal(g.betas, o.betas)
    assert np.array_equal(g.cv_loss, o.cv_loss)
    assert g.n_host_syncs == g.n_dispatches


@pytest.mark.gpu
def test_sparse_multitask_grid_on_card_runs_k5b_and_k1bl(cuda):
    """A weighted multitask CSC grid on the kernel route: K5b at S*T
    columns on the heads, K5s once a fold, K1bl inside, within 1e-8 of
    the plain route."""
    import scipy.sparse as sp
    from repro_torch.core import BlockL1, MultitaskQuadratic, cross_val_path
    from repro_torch.sparse import CSCDesign
    rng = np.random.default_rng(2)
    Xs = sp.random(600, 3000, density=0.02, random_state=2, format="csc")
    W = np.zeros((3000, 5))
    W[:20] = rng.standard_normal((20, 5))
    Y = np.asarray(Xs @ W) + 0.1 * rng.standard_normal((600, 5))
    w = rng.uniform(0.5, 1.5, 600)
    d = CSCDesign.from_scipy(Xs, ell=True, device=cuda)
    kw = dict(n_lambdas=5, cv=3, tol=1e-10, vmap_chunk=2,
              lambda_min_ratio=0.1, sample_weight=w)
    ops.reset_launch_counts()
    g = cross_val_path(d, Y, MultitaskQuadratic(), BlockL1(1.0), device=cuda,
                       **kw)
    counts = ops.launch_counts()
    assert counts["csc_score_block"] > 0
    assert counts["cd_epoch_gram_block_lanes"] > 0
    assert counts["csc_weighted_col_sq"] == 3
    assert counts["cd_epoch_gram_lanes"] == counts["csc_score"] == 0
    plain = cross_val_path(d, Y, MultitaskQuadratic(), BlockL1(1.0),
                           device=cuda, use_kernels=False, **kw)
    assert np.max(g.kkts) <= 1e-10
    assert np.max(np.abs(g.betas - plain.betas)) < 1e-8
