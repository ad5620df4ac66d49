"""The port's multitask lanes on the CPU against the JAX package.

``reg_path(X, Y [n, T], BlockL1 | BlockMCP, MultitaskQuadratic(),
vmap_chunk > 1)`` and ``cross_val_path`` on a multitask target run the lane
step on betas ``[S, p, T]``. The same seeded numpy/scipy inputs go through
``repro.core`` (its jax backend: its Pallas dense kernels crash on this JAX
version) and through the port on ``device="cpu"``, on dense, scipy-sparse
and ``CSCDesign`` inputs, unweighted and with ``sample_weight``, in the
Gram and the Xb form, on the plain route and on the kernel route (on CPU
tensors the kernel route runs K3bl's, K5b's and K1bl's plain versions).

Bounds: beta within 1e-8 at tol 1e-10 (the multitask bound of
``tests/test_sparse.py``, which ``ROADMAP.md`` takes for every multitask
part); cv_loss within 1e-8 (the held-out loss of betas that agree to
1e-8: ``tests/test_torch_grid.py`` holds it to 1e-10 at tol 1e-12, and at
tol 1e-10 two solvers' losses differ by a few 1e-10); the lambdas and best
index equal; the lane
kernels' plain versions equal their single-lane plain versions lane by lane
bit for bit; the lane Anderson step on ``[S, M+1, K, T]`` equal to the
per-lane reshape bit for bit. The reference's grids reuse one engine a
penalty, so each bucket compiles once for the file.
"""
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as jc
from repro.data.synth import make_multitask as j_make_multitask
import repro_torch.core as tc
from repro_torch.core import penalties as P
from repro_torch.core.anderson import anderson_extrapolate_lanes
from repro_torch.core.engine import EngineConfig, SolveEngine, lane_params
from repro_torch.kernels import ops
from repro_torch.kernels.cd_epoch import (cd_epoch_gram_block_lanes_plain,
                                          cd_epoch_gram_plain)
from repro_torch.kernels.fused_ws import (fused_ws_block_lanes_plain,
                                          fused_ws_plain)
from repro_torch.sparse import CSCDesign

CPU = "cpu"
TOL = 1e-10
BETA_ATOL = 1e-8
PENS = {"BlockL1": (jc.BlockL1(1.0), P.BlockL1(1.0)),
        "BlockMCP": (jc.BlockMCP(1.0, 3.0), P.BlockMCP(1.0, 3.0))}
ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernels"])


@functools.lru_cache(maxsize=None)
def _problem():
    """A dense multitask design, its scipy CSC copy with 30% of the
    entries kept, the targets of the sparse design, the weights."""
    X, _, W = j_make_multitask(n=60, p=120, n_tasks=4, n_nonzero=6, seed=0)
    rng = np.random.default_rng(1)
    Xs = sp.csc_matrix(X * (rng.random(X.shape) < 0.3))
    Y = Xs @ W + 0.1 * rng.standard_normal((60, 4))
    w = rng.uniform(0.5, 2.0, 60)
    return Xs, np.asarray(Y), w


def _input(kind, use_kernels=False):
    Xs = _problem()[0]
    if kind == "dense":
        return Xs.toarray()
    if kind == "scipy":
        return Xs
    return CSCDesign.from_scipy(Xs, ell=use_kernels, device=CPU)


@functools.lru_cache(maxsize=None)
def _engine(pen_name):
    """One reference engine a penalty, shared by its cases."""
    jp = PENS[pen_name][0]
    return jc.make_engine(jp, jc.MultitaskQuadratic(), shared=False)


@functools.lru_cache(maxsize=None)
def _lambdas(weighted, n=5, ratio=0.1):
    """The grid from the reference's lambda_max (the port's matches it to
    rounding: ``test_grid_lambda_grid_follows_reference``)."""
    Xs, Y, w = _problem()
    lmax = float(jc.lambda_max(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                               jc.MultitaskQuadratic(),
                               sample_weight=w if weighted else None))
    return tuple(lmax * np.geomspace(1.0, ratio, n))


@functools.lru_cache(maxsize=None)
def _ref_path(pen_name, weighted):
    Xs, Y, w = _problem()
    jp = PENS[pen_name][0]
    res = jc.reg_path(jnp.asarray(Xs.toarray()), jnp.asarray(Y), jp,
                      jc.MultitaskQuadratic(), lambdas=np.array(
                          _lambdas(weighted, 6)), tol=TOL, vmap_chunk=3,
                      sample_weight=w if weighted else None,
                      engine=_engine(pen_name))
    return np.asarray(res.betas)


@functools.lru_cache(maxsize=None)
def _ref_grid(pen_name, weighted):
    Xs, Y, w = _problem()
    jp = PENS[pen_name][0]
    g = jc.cross_val_path(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                          jc.MultitaskQuadratic(), jp, cv=3,
                          lambdas=np.array(_lambdas(weighted)), tol=TOL,
                          vmap_chunk=2, sample_weight=w if weighted else None,
                          engine=_engine(pen_name))
    return g


def _count_calls(monkeypatch):
    """Calls of the lane and block kernel wrappers during a run."""
    calls = {}
    for name in ("fused_ws_block_lanes", "cd_epoch_gram_block_lanes",
                 "csc_score_block", "fused_ws_lanes", "cd_epoch_gram_lanes",
                 "cd_epoch_xb_lanes", "fused_ws_block", "cd_epoch_gram_block"):
        calls[name] = 0
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return calls


# ------------------------------------------------------------ lane kernels
def _block_lane_rows(pen, S, seed):
    rows = lane_params(pen, np.random.default_rng(seed).uniform(0.05, 0.2, S))
    return rows


@pytest.mark.parametrize("pen", [P.BlockL1(0.1), P.BlockMCP(0.1, 3.0)],
                         ids=["BlockL1", "BlockMCP"])
def test_k1bl_plain_equals_k1b_lane_by_lane(pen):
    """K1bl's plain version (and the wrapper's CPU route) equals K1b's
    plain epoch on each lane's own inputs and parameter row bit for bit;
    frozen lanes come back unchanged."""
    S, K, T = 4, 12, 3
    g = torch.Generator().manual_seed(3)
    X = torch.randn(S, 3 * K, K, generator=g, dtype=torch.float64)
    G = (X.transpose(1, 2) @ X / (3 * K)).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    c = 0.1 * torch.randn(S, K, T, generator=g, dtype=torch.float64)
    beta0 = 0.1 * torch.randn(S, K, T, generator=g, dtype=torch.float64)
    q0 = G @ beta0
    L = torch.diagonal(G, dim1=1, dim2=2).contiguous()
    params = _block_lane_rows(pen, S, seed=4)
    active = torch.tensor([True, False, True, True])
    for epochs in (1, 3):
        b, q = ops.cd_epoch_gram_block_lanes(G, c, beta0, q0, L, type(pen),
                                             params, active, epochs=epochs)
        bp, qp = cd_epoch_gram_block_lanes_plain(G, c, beta0, q0, L,
                                                 type(pen), params, active,
                                                 epochs=epochs)
        assert torch.equal(b, bp) and torch.equal(q, qp)
        for s in range(S):
            if active[s]:
                bs, qs = cd_epoch_gram_plain(G[s], c[s], beta0[s], q0[s],
                                             L[s], type(pen), params[s],
                                             epochs=epochs)
                ks = ops.cd_epoch_gram_block(G[s], c[s].contiguous(),
                                             beta0[s].contiguous(),
                                             q0[s].contiguous(), L[s],
                                             type(pen), params[s],
                                             epochs=epochs)
                assert torch.equal(ks[0], bs) and torch.equal(ks[1], qs)
            else:
                bs, qs = beta0[s], q0[s]
            assert torch.equal(b[s], bs) and torch.equal(q[s], qs), s


def test_k1bl_wrapper_checks():
    S, K, T = 2, 4, 3
    G = torch.eye(K, dtype=torch.float64).expand(S, K, K)
    z = torch.zeros(S, K, T, dtype=torch.float64)
    L = torch.ones(S, K, dtype=torch.float64)
    params = lane_params(P.BlockL1(0.1), [0.1, 0.2])
    on = torch.ones(S, dtype=torch.bool)
    with pytest.raises(ValueError, match=r"beta0 must be \[2, 4, T\]"):
        ops.cd_epoch_gram_block_lanes(G, z[..., 0], z[..., 0], z[..., 0], L,
                                      P.BlockL1, params, on)
    with pytest.raises(ValueError, match="q0 must be a contiguous"):
        ops.cd_epoch_gram_block_lanes(G, z, z, z.transpose(1, 2)
                                      .contiguous().transpose(1, 2), L,
                                      P.BlockL1, params, on)
    with pytest.raises(TypeError, match="active"):
        ops.cd_epoch_gram_block_lanes(G, z, z, z, L, P.BlockL1, params,
                                      torch.ones(3, dtype=torch.bool))
    with pytest.raises(Exception, match="block"):
        ops.cd_epoch_gram_block_lanes(G, z, z, z, L, P.L1, params, on)


@pytest.mark.parametrize("pen,use_fp,shared_L", [
    (P.BlockL1(0.3), False, True), (P.BlockMCP(0.3, 3.0), False, False),
    (P.BlockMCP(0.3, 3.0), True, True)],
    ids=["BlockL1", "BlockMCP", "BlockMCP-fp"])
def test_k3bl_head_equals_k3b_lane_by_lane(pen, use_fp, shared_L):
    """K3bl's plain version equals K3b's on each lane (raw columns
    R[:, s*T:(s+1)*T]) bit for bit, and its CPU route gives each lane
    K3b's scores, gradient, candidates, working set and rows bit for
    bit."""
    S, n, p, T, ws_size = 3, 30, 150, 4, 16
    g = torch.Generator().manual_seed(11)
    Xt = torch.randn(p, n, generator=g, dtype=torch.float64)
    R = torch.randn(n, S * T, generator=g, dtype=torch.float64)
    beta = torch.randn(S, p, T, generator=g, dtype=torch.float64)
    beta[torch.linalg.vector_norm(beta, dim=2) < 2.0] = 0.0
    L = torch.sum(Xt * Xt, dim=1) / n
    L = L.expand(S, p) if shared_L else \
        L * (1 + torch.rand(S, p, generator=g, dtype=torch.float64))
    off = torch.zeros(p, dtype=torch.float64)
    params = _block_lane_rows(pen, S, seed=12)
    gs = torch.linalg.vector_norm(beta, dim=2) != 0
    plain = fused_ws_block_lanes_plain(Xt, R, beta, L, off, gs, type(pen),
                                       params, ws_size, use_fp=use_fp, bp=64)
    out = ops.fused_ws_block_lanes(Xt, R, beta, L, off, gs, type(pen),
                                   params, ws_size, use_fp=use_fp, bp=64)
    for s in range(S):
        r = R[:, s * T:(s + 1) * T].contiguous()
        one_plain = fused_ws_plain(Xt, r, beta[s], L[s], off, gs[s],
                                   type(pen), params[s], ws_size,
                                   use_fp=use_fp, bp=64)
        for a, b in zip(plain, one_plain):
            assert torch.equal(a[s], b), s
        one = ops.fused_ws_block(Xt, r, beta[s].contiguous(),
                                 L[s].contiguous(), off, gs[s], type(pen),
                                 params[s], ws_size, use_fp=use_fp, bp=64)
        for a, b in zip(out, one):
            assert torch.equal(a[s], b), s


def test_k3bl_wrapper_checks():
    S, n, p, T = 2, 10, 20, 3
    Xt = torch.ones(p, n, dtype=torch.float64)
    beta = torch.zeros(S, p, T, dtype=torch.float64)
    L = torch.ones(p, dtype=torch.float64).expand(S, p)
    off = torch.zeros(p, dtype=torch.float64)
    gs = torch.zeros(S, p, dtype=torch.bool)
    params = lane_params(P.BlockL1(0.1), [0.1, 0.2])
    R = torch.zeros(n, S * T, dtype=torch.float64)
    with pytest.raises(ValueError, match="R must be a contiguous"):
        ops.fused_ws_block_lanes(Xt, R[:, :T], beta, L, off, gs, P.BlockL1,
                                 params, 4)
    with pytest.raises(ValueError, match="beta must be"):
        ops.fused_ws_block_lanes(Xt, R, beta[..., 0], L, off, gs, P.BlockL1,
                                 params, 4)
    with pytest.raises(ValueError, match="ws_size"):
        ops.fused_ws_block_lanes(Xt, R, beta, L, off, gs, P.BlockL1, params,
                                 p + 1)


def test_anderson_lanes_on_blocks_equals_reshape():
    """The lane Anderson step on [S, M+1, K, T] is the flat [S, M+1, K*T]
    step reshaped, bit for bit, as the reference flattens a block
    history."""
    g = torch.Generator().manual_seed(5)
    hist = torch.cumsum(torch.randn(4, 6, 7, 3, generator=g,
                                    dtype=torch.float64), dim=1)
    hist[1] = hist[1, :1].expand(6, 7, 3)      # a lane that stands still
    hist[3, 2, 0, 0] = torch.nan               # a lane whose solve fails
    out = anderson_extrapolate_lanes(hist)
    flat = anderson_extrapolate_lanes(hist.reshape(4, 6, 21))
    assert out.shape == (4, 7, 3)
    assert torch.equal(out.reshape(4, 21), flat)
    assert torch.equal(out[3], hist[3, -1])


def test_chunk_keys_tell_the_task_count():
    """A multitask dispatch's graph key differs from a scalar one's and
    from one of another task count."""
    eng = SolveEngine(EngineConfig(), CPU)
    design = tc.DenseDesign.from_dense(np.ones((6, 5)), CPU)
    keys = set()
    for shape, yshape in (((2, 5), (6,)), ((2, 5, 3), (6, 3)),
                          ((2, 5, 4), (6, 4))):
        betas = torch.zeros(shape, dtype=torch.float64)
        y = torch.zeros(yshape, dtype=torch.float64)
        keys.add(eng._chunk_key(8, design, y, None, betas, None,
                                torch.zeros(5), None, tc.MultitaskQuadratic(),
                                P.BlockL1, None, 1e-6, 0.3, None, 2))
    assert len(keys) == 3


# --------------------------------------------------------- chunked path
@ROUTES
@pytest.mark.parametrize("kind,pen_name,weighted,gram", [
    ("dense", "BlockL1", False, True), ("dense", "BlockMCP", False, True),
    ("scipy", "BlockL1", True, True), ("csc", "BlockMCP", False, True),
    ("dense", "BlockL1", True, False)],
    ids=["dense-BlockL1", "dense-BlockMCP", "scipy-weighted",
         "csc-BlockMCP", "dense-weighted-xb"])
def test_chunked_multitask_path_matches_reference_and_sequential(
        kind, pen_name, weighted, gram, use_kernels, monkeypatch):
    """reg_path(Y, vmap_chunk=3) within 1e-8 of the reference's chunked
    path and of the port's sequential path at tol 1e-10, every lambda at
    kkt <= tol; on the kernel route K3bl (dense) or K5b (sparse) runs every
    head and K1bl every Gram epoch, and no scalar lane kernel runs."""
    Xs, Y, w = _problem()
    tp = PENS[pen_name][1]
    kw = dict(lambdas=np.array(_lambdas(weighted, 6)), tol=TOL, device=CPU,
              sample_weight=w if weighted else None, use_gram=gram)
    X = _input(kind, use_kernels)
    calls = _count_calls(monkeypatch)
    chk = tc.reg_path(X, Y, tp, tc.MultitaskQuadratic(), vmap_chunk=3,
                      use_kernels=use_kernels, **kw)
    assert chk.betas.shape == (6, 120, 4)
    assert np.all(chk.kkts <= TOL)
    np.testing.assert_allclose(chk.betas, _ref_path(pen_name, weighted),
                               atol=BETA_ATOL)
    lane_calls = dict(calls)
    seq = tc.reg_path(X, Y, tp, tc.MultitaskQuadratic(), **kw)
    np.testing.assert_allclose(chk.betas, seq.betas, atol=BETA_ATOL)
    scalar = ("fused_ws_lanes", "cd_epoch_gram_lanes", "cd_epoch_xb_lanes")
    assert all(lane_calls[k] == 0 for k in scalar)
    head = "fused_ws_block_lanes" if kind == "dense" else "csc_score_block"
    if use_kernels:
        assert lane_calls[head] > 0
        assert (lane_calls["cd_epoch_gram_block_lanes"] > 0) == gram
    else:
        assert lane_calls["fused_ws_block_lanes"] == 0
        assert lane_calls["cd_epoch_gram_block_lanes"] == 0


# ------------------------------------------------------------ the grid
@ROUTES
@pytest.mark.parametrize("kind,pen_name,weighted,gram", [
    ("dense", "BlockL1", False, True), ("dense", "BlockMCP", False, True),
    ("scipy", "BlockL1", False, True), ("csc", "BlockMCP", False, True),
    ("dense", "BlockL1", True, True), ("csc", "BlockL1", True, False)],
    ids=["dense-BlockL1", "dense-BlockMCP", "scipy-BlockL1", "csc-BlockMCP",
         "dense-weighted", "csc-weighted-xb"])
def test_multitask_grid_matches_reference(kind, pen_name, weighted, gram,
                                          use_kernels):
    """cross_val_path(X, Y, MultitaskQuadratic(), block penalty, cv=3,
    vmap_chunk=2) against the reference's: betas [F, nlam, p, T] within
    1e-8, cv_loss within 1e-8, the lambdas and best index equal, every
    item at kkt <= tol, one read a dispatch."""
    Xs, Y, w = _problem()
    tp = PENS[pen_name][1]
    ref = _ref_grid(pen_name, weighted)
    g = tc.cross_val_path(_input(kind, use_kernels), Y,
                          tc.MultitaskQuadratic(), tp, cv=3,
                          lambdas=np.array(_lambdas(weighted)), tol=TOL,
                          vmap_chunk=2, sample_weight=w if weighted else None,
                          device=CPU, use_kernels=use_kernels, use_gram=gram)
    assert g.betas.shape == (3, 5, 120, 4)
    assert np.array_equal(g.lambdas, np.asarray(ref.lambdas))
    assert np.all(g.kkts <= TOL)
    np.testing.assert_allclose(g.betas, np.asarray(ref.betas),
                               atol=BETA_ATOL)
    np.testing.assert_allclose(g.cv_loss, np.asarray(ref.cv_loss), rtol=0,
                               atol=BETA_ATOL)
    assert g.best_index == int(ref.best_index)
    assert g.n_host_syncs == g.n_dispatches


def test_grid_lambda_grid_follows_reference():
    """Without a grid, the port's lambdas (from its block lambda_max)
    equal the reference's to rounding, and so does the grid's choice."""
    Xs, Y, _ = _problem()
    kw = dict(cv=3, n_lambdas=5, lambda_min_ratio=0.1, tol=TOL,
              vmap_chunk=2)
    ref = _ref_grid("BlockL1", False)
    g = tc.cross_val_path(Xs.toarray(), Y, tc.MultitaskQuadratic(),
                          P.BlockL1(1.0), device=CPU, **kw)
    np.testing.assert_allclose(g.lambdas, np.asarray(ref.lambdas), rtol=1e-12,
                               atol=0)
    np.testing.assert_allclose(g.betas, np.asarray(ref.betas),
                               atol=BETA_ATOL)
    assert g.best_index == int(ref.best_index)


@pytest.mark.parametrize("call", [
    lambda m, X, Y: m.reg_path(X, Y, m.L1(1.0), m.MultitaskQuadratic(),
                               n_lambdas=3, vmap_chunk=2, **_cpu(m)),
    lambda m, X, Y: m.cross_val_path(X, Y, m.MultitaskQuadratic(),
                                     m.L1(1.0), cv=3, n_lambdas=3,
                                     **_cpu(m))], ids=["chunked", "grid"])
def test_scalar_penalty_on_multitask_target_raises(call):
    """A scalar penalty on Y [n, T] raises "block penalty" at entry, with
    the reference's text."""
    Xs, Y, _ = _problem()
    X = Xs.toarray()
    with pytest.raises(NotImplementedError, match="block penalty") as a:
        call(tc, X, Y)
    with pytest.raises(NotImplementedError) as b:
        call(jc, jnp.asarray(X), jnp.asarray(Y))
    assert str(a.value) == str(b.value)


def _cpu(m):
    return {"device": CPU} if m is tc else {}
