"""The port's lane machinery on the CPU: the fold weights, the lane
scheduler, the lane kernels' plain versions, the lane-batched Anderson
step and the chunked regularization path.

Held against the JAX package (``repro.data.folds``, ``repro.core.lanes``
and ``repro.core.reg_path(vmap_chunk > 1)`` on its jax backend) and, for
the lane kernels, against the single-lane plain versions lane by lane.
Bounds: the weights, the scheduler's state and reports, and the lane
kernels' plain versions bit for bit; the chunked path within 1e-6 of the
reference's and of the port's sequential path at tol 1e-9
(``tests/test_engine.py:61``, ``:224``); the lane Anderson step within
1e-12 of the single-lane one.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as jc
from repro.core.lanes import LaneScheduler as JLaneScheduler
from repro.data import folds as jfolds
from repro.data.synth import make_classification, make_correlated_design
import repro_torch.core as tc
from repro_torch.core import penalties as P
from repro_torch.core.anderson import (anderson_extrapolate,
                                       anderson_extrapolate_lanes)
from repro_torch.core.engine import lane_params
from repro_torch.core.lanes import LaneScheduler
from repro_torch.data import folds as tfolds
from repro_torch.kernels import ops
from repro_torch.kernels.cd_epoch import (cd_epoch_gram_lanes_plain,
                                          cd_epoch_gram_plain,
                                          cd_epoch_xb_lanes_plain,
                                          cd_epoch_xb_plain)
from repro_torch.kernels.common import penalty_params

PENALTIES = [P.L1(0.05), P.L1L2(0.05, 0.5), P.MCP(0.05, 3.0),
             P.SCAD(0.05, 3.7), P.L05(0.02), P.L23(0.02), P.Box(0.3)]
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernels"])


# ------------------------------------------------------------ fold weights
@pytest.mark.parametrize("n,k,seed,shuffle", [(23, 5, 0, True),
                                              (200, 3, 4, True),
                                              (17, 4, 1, False)])
def test_kfold_weights_match_reference(n, k, seed, shuffle):
    a = tfolds.kfold_weights(n, k, seed=seed, shuffle=shuffle)
    b = jfolds.kfold_weights(n, k, seed=seed, shuffle=shuffle)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("n,r,seed", [(50, 8, 1), (200, 4, 0)])
def test_bootstrap_weights_match_reference(n, r, seed):
    a = tfolds.bootstrap_weights(n, r, seed=seed)
    b = jfolds.bootstrap_weights(n, r, seed=seed)
    assert a.dtype == b.dtype and np.array_equal(a, b)


@pytest.mark.parametrize("call", [
    lambda m: m.kfold_weights(10, 1), lambda m: m.kfold_weights(3, 4),
    lambda m: m.bootstrap_weights(10, 0)], ids=["folds-1", "folds>n",
                                               "replicates-0"])
def test_fold_weight_errors_match_reference(call):
    with pytest.raises(ValueError) as a:
        call(tfolds)
    with pytest.raises(ValueError) as b:
        call(jfolds)
    assert str(a.value) == str(b.value)


# ----------------------------------------------------------- lane scheduler
def _report(rep):
    return (rep.active.tolist(), rep.rec_before.tolist(),
            [dataclasses.astuple(r) for r in rep.retired],
            rep.continuing.tolist(), rep.bank_updates)


def _state(sched):
    return {k: np.asarray(v).tolist() for k, v in sched.state_dict().items()}


@pytest.mark.parametrize("F,nlam,S,max_outer,seed", [
    (5, 30, 50, 50, 0), (3, 8, 12, 4, 1), (4, 7, 4, 3, 2), (2, 5, 10, 6, 3)])
def test_lane_scheduler_matches_reference(F, nlam, S, max_outer, seed):
    """The same random observe / fill sequence through both schedulers
    gives the same reports, assignments and state at every round."""
    rng = np.random.default_rng(seed)
    a = LaneScheduler(F, nlam, S, max_outer)
    b = JLaneScheduler(F, nlam, S, max_outer)
    assert a.fill() == b.fill()
    tol = 1e-6
    rounds = 0
    while not a.done:
        assert a.dispatch_budget(4) == b.dispatch_budget(4)
        assert a.occupancy == b.occupancy
        kkts = np.where(rng.random(S) < 0.4, 1e-8, 1e-3)
        gcounts = rng.integers(0, 40, S)
        n_eps = rng.integers(0, 30, S)
        it = int(rng.integers(1, 4))
        assert _report(a.observe(kkts, gcounts, n_eps, it, tol)) == \
            _report(b.observe(kkts, gcounts, n_eps, it, tol))
        assert a.fill() == b.fill()
        assert _state(a) == _state(b)
        rounds += 1
    assert b.done and rounds > 1


def test_lane_scheduler_state_round_trip_and_errors():
    a = LaneScheduler(3, 6, 6, 5)
    a.fill()
    a.observe(np.full(6, 1e-9), np.arange(6), np.ones(6), 2, 1e-6)
    b = LaneScheduler(3, 6, 6, 5)
    b.load_state(a.state_dict())
    assert _state(a) == _state(b)
    for call in (lambda m: m(3, 6, 0, 5), lambda m: m(3, 6, 19, 5)):
        with pytest.raises(ValueError) as ea:
            call(LaneScheduler)
        with pytest.raises(ValueError) as eb:
            call(JLaneScheduler)
        assert str(ea.value) == str(eb.value)
    bad = dict(a.state_dict(), lane_fold=np.zeros(4, np.int64))
    with pytest.raises(ValueError) as ea:
        b.load_state(bad)
    jb = JLaneScheduler(3, 6, 6, 5)
    with pytest.raises(ValueError) as eb:
        jb.load_state(bad)
    assert str(ea.value) == str(eb.value)
    with pytest.raises(RuntimeError, match="no active lanes"):
        LaneScheduler(2, 2, 2, 3).dispatch_budget(4)


# -------------------------------------------------- lane kernels, plain
def _lane_rows(pen, S, seed):
    """[S, arity] codec rows of `pen`, lam scaled per lane."""
    lams = pen.lam * np.random.default_rng(seed).uniform(0.5, 1.5, S) \
        if hasattr(pen, "lam") else None
    if lams is None:
        return penalty_params(pen).repeat(S, 1)
    return lane_params(pen, lams)


def _gram_lanes(S, K, seed):
    g = torch.Generator().manual_seed(seed)
    X = torch.randn(S, 3 * K, K, generator=g, dtype=torch.float64)
    y = torch.randn(S, 3 * K, generator=g, dtype=torch.float64)
    G = (X.transpose(1, 2) @ X / (3 * K)).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    c = (X.transpose(1, 2) @ y[..., None])[..., 0] / (3 * K)
    beta0 = 0.1 * torch.randn(S, K, generator=g, dtype=torch.float64)
    q0 = (G @ beta0[..., None])[..., 0]
    L = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    return G, c, beta0, q0, L


@pytest.mark.parametrize("pen", PENALTIES, ids=lambda p: type(p).__name__)
def test_gram_lanes_plain_equals_k1_lane_by_lane(pen):
    """K1l's plain version (and the wrapper's CPU route) equals K1's plain
    epoch on each lane's own inputs and parameter row bit for bit; frozen
    lanes come back unchanged."""
    S, K = 5, 31
    G, c, beta0, q0, L = _gram_lanes(S, K, seed=3)
    params = _lane_rows(pen, S, seed=4)
    active = torch.tensor([True, False, True, True, False])
    for epochs in (1, 3):
        b, q = ops.cd_epoch_gram_lanes(G, c, beta0, q0, L, type(pen), params,
                                       active, epochs=epochs)
        bp, qp = cd_epoch_gram_lanes_plain(G, c, beta0, q0, L, type(pen),
                                           params, active, epochs=epochs)
        assert torch.equal(b, bp) and torch.equal(q, qp)
        for s in range(S):
            if active[s]:
                bs, qs = cd_epoch_gram_plain(G[s], c[s], beta0[s], q0[s],
                                             L[s], type(pen), params[s],
                                             epochs=epochs)
            else:
                bs, qs = beta0[s], q0[s]
            assert torch.equal(b[s], bs) and torch.equal(q[s], qs), s


@pytest.mark.parametrize("kind,wform", [("quadratic", None),
                                        ("logistic", "shared"),
                                        ("logistic", "lanes"),
                                        ("svc", None)])
def test_xb_lanes_plain_equals_k2_lane_by_lane(kind, wform):
    S, K, n = 4, 12, 40
    g = torch.Generator().manual_seed(7)
    Xt = torch.randn(S, K, n, generator=g, dtype=torch.float64)
    y = torch.sign(torch.randn(n, generator=g, dtype=torch.float64))
    beta0 = 0.1 * torch.randn(S, K, generator=g, dtype=torch.float64)
    Xb0 = (beta0[:, None, :] @ Xt)[:, 0]
    L = torch.sum(Xt * Xt, dim=2) / n
    off = -torch.ones(S, K, dtype=torch.float64) if kind == "svc" \
        else torch.zeros(S, K, dtype=torch.float64)
    w = None
    if wform == "shared":
        w = torch.rand(n, generator=g, dtype=torch.float64) + 0.5
    elif wform == "lanes":
        w = torch.rand(S, n, generator=g, dtype=torch.float64) + 0.5
    pen = P.Box(0.5) if kind == "svc" else P.L1(0.02)
    params = _lane_rows(pen, S, seed=8)
    active = torch.tensor([True, True, False, True])
    b, x = ops.cd_epoch_xb_lanes(Xt, y, beta0, Xb0, L, off, type(pen), params,
                                 active, kind, w=w, epochs=2)
    bp, xp = cd_epoch_xb_lanes_plain(Xt, y, beta0, Xb0, L, off, type(pen),
                                     params, active, kind, w=w, epochs=2)
    assert torch.equal(b, bp) and torch.equal(x, xp)
    for s in range(S):
        if not active[s]:
            assert torch.equal(b[s], beta0[s]) and torch.equal(x[s], Xb0[s])
            continue
        ws = w if w is None or w.ndim == 1 else w[s]
        bs, xs = cd_epoch_xb_plain(Xt[s], y, beta0[s], Xb0[s], L[s], off[s],
                                   type(pen), params[s], kind, w=ws,
                                   epochs=2)
        assert torch.equal(b[s], bs) and torch.equal(x[s], xs), s


@pytest.mark.parametrize("ws_size,shared_L", [(16, False), (64, True)])
def test_fused_ws_lanes_head_equals_k3_lane_by_lane(ws_size, shared_L):
    """K3l's CPU route equals K3's on each lane: scores, gradient,
    candidates, working set and its rows bit for bit."""
    S, n, p = 4, 30, 150
    g = torch.Generator().manual_seed(11)
    Xt = torch.randn(p, n, generator=g, dtype=torch.float64)
    R = torch.randn(n, S, generator=g, dtype=torch.float64)
    beta = torch.randn(S, p, generator=g, dtype=torch.float64)
    beta[beta.abs() < 1.0] = 0.0
    L = torch.sum(Xt * Xt, dim=1) / n
    L = L.expand(S, p) if shared_L else \
        L * (1 + torch.rand(S, p, generator=g, dtype=torch.float64))
    off = torch.zeros(p, dtype=torch.float64)
    pen = P.MCP(0.1, 3.0)
    params = _lane_rows(pen, S, seed=12)
    gs = torch.stack([P.MCP(*params[s].tolist()).generalized_support(beta[s])
                      for s in range(S)])
    out = ops.fused_ws_lanes(Xt, R, beta, L, off, gs, P.MCP, params, ws_size,
                             bp=64)
    for s in range(S):
        one = ops.fused_ws(Xt, R[:, s].contiguous(), beta[s].contiguous(),
                           L[s].contiguous(), off, gs[s], P.MCP, params[s],
                           ws_size, bp=64)
        for a, b in zip(out, one):
            assert torch.equal(a[s], b), s


def test_lane_wrappers_check_the_mask():
    G, c, beta0, q0, L = _gram_lanes(3, 8, seed=0)
    params = lane_params(P.L1(0.1), [0.1, 0.2, 0.3])
    for bad in (torch.ones(2, dtype=torch.bool), torch.ones(3)):
        with pytest.raises(TypeError, match="active"):
            ops.cd_epoch_gram_lanes(G, c, beta0, q0, L, P.L1, params, bad)


def test_lane_params_rows():
    rows = lane_params(P.MCP(1.0, 3.0), np.array([0.5, 0.25]))
    assert rows.dtype == torch.float64
    assert rows.tolist() == [[0.5, 3.0], [0.25, 3.0]]
    with pytest.raises(ValueError, match="lam"):
        lane_params(P.Box(1.0), [0.1])


# ----------------------------------------------------------- lane Anderson
def test_anderson_lanes_equals_single_lane():
    g = torch.Generator().manual_seed(5)
    hist = torch.cumsum(torch.randn(6, 6, 20, generator=g,
                                    dtype=torch.float64), dim=1)
    hist[2] = hist[2, :1].expand(6, 20)        # a lane that stands still
    hist[4, 3] = torch.nan                     # a lane whose solve fails
    out = anderson_extrapolate_lanes(hist)
    for s in range(6):
        one = anderson_extrapolate(hist[s])
        assert torch.allclose(out[s], one, rtol=1e-12, atol=1e-12,
                              equal_nan=True), s
    assert torch.equal(out[4], hist[4, -1])


# ---------------------------------------------------------- chunked path
def _dense(n=200, p=400, n_nonzero=15, seed=0):
    X, y, _ = make_correlated_design(n=n, p=p, n_nonzero=n_nonzero, rho=0.5,
                                     snr=5.0, seed=seed)
    return X, y


@ROUTES
def test_chunked_path_matches_reference_and_sequential(use_kernels):
    """``tests/test_engine.py:61`` on the port: reg_path(vmap_chunk=4)
    within 1e-6 of the reference's chunked path and of the port's
    sequential path, every lambda at kkt <= tol 1e-9."""
    X, y = _dense()
    kw = dict(n_lambdas=8, lambda_min_ratio=0.02, tol=1e-9)
    ref = jc.reg_path(jnp.asarray(X), jnp.asarray(y), jc.L1(1.0),
                      engine=jc.make_engine(jc.L1(1.0), jc.Quadratic(),
                                            shared=False),
                      vmap_chunk=4, **kw)
    seq = tc.reg_path(X, y, tc.L1(1.0), device="cpu", **kw)
    chk = tc.reg_path(X, y, tc.L1(1.0), device="cpu", vmap_chunk=4,
                      use_kernels=use_kernels, **kw)
    assert np.all(chk.kkts <= 1e-9)
    np.testing.assert_array_equal(chk.lambdas, ref.lambdas)
    np.testing.assert_allclose(chk.betas, ref.betas, atol=1e-6)
    np.testing.assert_allclose(chk.betas, seq.betas, atol=1e-6)
    # one read a dispatch and one for the betas
    assert chk.n_host_syncs >= 3


def test_chunked_path_weighted_logistic_matches_reference():
    X, y, _ = make_classification(n=120, p=200, n_nonzero=10, seed=0)
    w = np.random.default_rng(5).uniform(0.5, 1.5, X.shape[0])
    kw = dict(n_lambdas=5, lambda_min_ratio=0.3, tol=1e-9)
    ref = jc.reg_path(jnp.asarray(X), jnp.asarray(y), jc.L1(1.0),
                      jc.Logistic(), sample_weight=w, vmap_chunk=3, **kw)
    chk = tc.reg_path(X, y, tc.L1(1.0), tc.Logistic(), sample_weight=w,
                      device="cpu", vmap_chunk=3, **kw)
    assert np.all(chk.kkts <= 1e-9)
    np.testing.assert_allclose(chk.betas, ref.betas, atol=1e-6)


def test_chunked_path_converges_on_dense_solutions():
    """``tests/test_engine.py:224``: support > p / 2, the chunk loop keeps
    iterating at bucket == p."""
    X, y = _dense(n=200, p=64, n_nonzero=40)
    kw = dict(n_lambdas=6, lambda_min_ratio=1e-3, tol=1e-8)
    seq = tc.reg_path(X, y, tc.L1(1.0), device="cpu", **kw)
    chk = tc.reg_path(X, y, tc.L1(1.0), device="cpu", vmap_chunk=3, **kw)
    ref = jc.reg_path(jnp.asarray(X), jnp.asarray(y), jc.L1(1.0),
                      vmap_chunk=3, **kw)
    assert np.all(chk.kkts <= 1e-8)
    np.testing.assert_allclose(chk.betas, seq.betas, atol=1e-6)
    np.testing.assert_allclose(chk.betas, ref.betas, atol=1e-6)


def test_chunked_path_rejects_unsupported_solve_kwargs():
    """``tests/test_engine.py:238``, with the reference's message."""
    X, y = _dense(n=40, p=30)
    with pytest.raises(ValueError) as a:
        tc.reg_path(X, y, tc.L1(1.0), n_lambdas=4, vmap_chunk=2,
                    use_ws=False, device="cpu")
    with pytest.raises(ValueError) as b:
        jc.reg_path(jnp.asarray(X), jnp.asarray(y), jc.L1(1.0),
                    n_lambdas=4, vmap_chunk=2, use_ws=False)
    assert str(a.value) == str(b.value)


def test_chunked_path_sorts_an_increasing_grid():
    X, y = _dense(n=100, p=120)
    lams = tc.lambda_max(X, y, device="cpu") * np.geomspace(0.05, 1.0, 6)
    down = tc.reg_path(X, y, tc.L1(1.0), lambdas=lams[::-1].copy(),
                       tol=1e-10, device="cpu")
    chk = tc.reg_path(X, y, tc.L1(1.0), lambdas=lams, tol=1e-10,
                      vmap_chunk=3, device="cpu")
    np.testing.assert_array_equal(chk.lambdas, down.lambdas)
    assert np.max(np.abs(chk.betas - down.betas)) < 1e-8


def test_chunk_dispatch_reads_once_and_keeps_frozen_lanes():
    """A dispatch on the CPU is one read; a lane already at tol takes the
    skip path and keeps its state bit for bit while the others run."""
    X, y = _dense(n=80, p=100)
    eng = tc.make_engine(tc.L1(1.0), tc.Quadratic(), device="cpu")
    prob = tc.solver.prepare_problem(eng, X, y, tc.Quadratic(), tc.L1(1.0))
    lmax = tc.lambda_max(X, y, device="cpu")
    lams = np.array([lmax * 0.5, lmax * 0.1, lmax * 1.5])
    S, p = 3, prob.design.shape[1]
    betas = torch.zeros(S, p, dtype=torch.float64)
    Xbs = torch.zeros(S, X.shape[0], dtype=torch.float64)
    out = eng.chunk(64, prob.design, prob.y, lams, betas, Xbs, prob.L,
                    prob.offset, tc.Quadratic(), tc.L1(1.0), 1e-9, 0.3, 20)
    assert eng.n_chunk_reads == 1 and eng.n_dispatches == 1
    assert out.n_outer >= 2 and out.n_eps[2] == 0
    assert torch.equal(out.betas[2], betas[2])
    assert out.kkts[2] <= 1e-9 and np.all(out.kkts <= 1e-9)
    for s in range(2):
        res = tc.solve(X, y, tc.Quadratic(), tc.L1(float(lams[s])),
                       tol=1e-9, device="cpu")
        assert torch.max(torch.abs(out.betas[s] - res.beta)) < 1e-6
