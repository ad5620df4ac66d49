"""The port's multitask block path on the CPU against the JAX package.

Same seeded numpy/scipy inputs through ``repro`` and ``repro_torch``:

* ``BlockL1`` / ``BlockMCP`` (value, prox, subdifferential distance,
  generalized support) and ``MultitaskQuadratic`` (value, raw gradient,
  Lipschitz constants, Gram) against the reference at 1e-12, with rows that
  are exactly zero and BlockMCP rows on both sides of gamma * lam;
* the codec (the block penalties round-trip, the scalar CD kernels refuse
  them), the block branches of ``working_set`` and Anderson on [M+1, K, T];
* the plain versions of the block kernels: K3b against the reference's
  two-pass head (``_two_pass`` of ``tests/test_fused_ws.py``: scores within
  1e-12 + 1e-11 relative, identical working sets, bit-exact columns), K5b
  against ``csc_score_pallas`` in interpret mode within 1e-10, K1b against
  the reference's jax block epoch ``repro.core.cd.cd_epoch_gram`` within
  1e-12;
* multitask ``solve`` on dense, scipy-sparse and ``CSCDesign`` input, Gram
  and Xb form, plain and kernel route (on CPU tensors the kernel route runs
  the kernels' plain versions), BlockL1 and BlockMCP, weighted and warm
  started, against the reference's jax backend at tol 1e-10 within 1e-8 on
  beta (the bound of ``tests/test_sparse.py``), with the block kernels'
  call counts;
* ``lambda_max``, the named solvers, ``MultiTaskLasso`` / ``MultiTaskMCP``
  and ``convert.py``; the entry error for a scalar penalty, whose text
  must equal the reference's.

The reference's own Pallas dense path does not run on this JAX version
(its CD kernels crash), so its jax backend is the oracle.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch

import repro.core as jc
import repro.core.penalties as jpen
from repro.core.anderson import anderson_extrapolate as j_anderson
from repro.core.cd import cd_epoch_gram as j_cd_epoch_gram
from repro.core.working_set import (fixed_point_score as j_fixed_point_score,
                                    ws_occupancy as j_ws_occupancy)
from repro.data.synth import make_leadfield as j_make_leadfield
from repro.data.synth import make_multitask as j_make_multitask
from repro.sparse import CSCDesign as JCSCDesign
from repro.sparse.ops import csc_score_pallas
import repro_torch.core as tc
from repro_torch.convert import from_reference, load_fitted, warm_start
from repro_torch.core.anderson import anderson_extrapolate
from repro_torch.core.working_set import (candidate_columns,
                                          fixed_point_score,
                                          select_working_set, ws_occupancy)
from repro_torch.data import make_leadfield, make_multitask
from repro_torch.kernels import ops
from repro_torch.kernels.fused_ws import fused_ws_plain
from repro_torch.kernels.common import (BLOCK_PENALTIES, PENALTY_IDS,
                                        UnsupportedPenaltyError,
                                        check_block_kernel_penalty,
                                        check_kernel_penalty,
                                        check_score_kernel_penalty,
                                        make_penalty, penalty_params)
from repro_torch.sparse import CSCDesign
from test_fused_ws import _two_pass

CPU = "cpu"
J_BLOCK = [jpen.BlockL1(0.3), jpen.BlockMCP(0.3, 3.0)]
BLOCK_IDS = [type(p).__name__ for p in J_BLOCK]


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, atol=1e-12, rtol=1e-12):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


def _rows(p=40, T=5, seed=0):
    """Rows of every kind: exactly zero, norms below, at and above
    gamma * lam = 0.9 (BlockMCP's kink), large."""
    rng = np.random.default_rng(seed)
    W = rng.standard_normal((p, T))
    W /= np.linalg.norm(W, axis=1, keepdims=True)
    W *= rng.choice([0.0, 0.2, 0.6, 0.9, 1.3, 4.0], size=(p, 1))
    return W


# ------------------------------------------------- generators and penalties
def test_multitask_generators_bit_for_bit():
    for a, b in zip(j_make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12),
                    make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    ja = j_make_leadfield(n=36, p_per_hemi=40, T=5, seed=3)
    ta = make_leadfield(n=36, p_per_hemi=40, T=5, seed=3)
    for a, b in zip(ja[:3], ta[:3]):
        np.testing.assert_array_equal(a, b)
    assert ja[3] == ta[3]


@pytest.mark.parametrize("jp", J_BLOCK, ids=BLOCK_IDS)
def test_block_penalties_match_reference(jp):
    tp = from_reference(jp)
    W = _rows()
    G = np.random.default_rng(1).standard_normal(W.shape)
    _close(tp.value(_t(W)), jp.value(jnp.asarray(W)))
    for step in (0.5, 1.7):
        _close(tp.prox(_t(W), step), jp.prox(jnp.asarray(W), step))
    step = _t(np.random.default_rng(2).random((W.shape[0], 1)) + 0.2)
    _close(tp.prox(_t(W), step), jp.prox(jnp.asarray(W), jnp.asarray(step)))
    # one block (a [T] row) with a 0-d step, as the CD epoch calls it
    _close(tp.prox(_t(W[4]), _t(0.8)), jp.prox(jnp.asarray(W[4]), 0.8))
    _close(tp.subdiff_dist(_t(G), _t(W)),
           jp.subdiff_dist(jnp.asarray(G), jnp.asarray(W)))
    np.testing.assert_array_equal(
        tp.generalized_support(_t(W)).numpy(),
        np.asarray(jp.generalized_support(jnp.asarray(W))))
    assert tp.HAS_SUBDIFF == jp.HAS_SUBDIFF


@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
def test_multitask_quadratic_matches_reference(weighted):
    rng = np.random.default_rng(3)
    n, p, T = 30, 12, 4
    X, Y, Xb = (rng.standard_normal(s) for s in ((n, p), (n, T), (n, T)))
    w = rng.random(n) * 2.0 if weighted else None
    jd, td = jc.MultitaskQuadratic(), tc.MultitaskQuadratic()
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    _close(td.value(_t(Xb), _t(Y), tw),
           jd.value(jnp.asarray(Xb), jnp.asarray(Y), jw))
    _close(td.raw_grad(_t(Xb), _t(Y), tw),
           jd.raw_grad(jnp.asarray(Xb), jnp.asarray(Y), jw))
    _close(td.lipschitz(_t(X), tw), jd.lipschitz(jnp.asarray(X), jw))
    _close(td.lipschitz_cols(_t(np.sum(X * X, 0)), n),
           jd.lipschitz_cols(jnp.asarray(np.sum(X * X, 0)), n))
    for a, b in zip(td.make_gram(_t(X), _t(Y), tw),
                    jd.make_gram(jnp.asarray(X), jnp.asarray(Y), jw)):
        _close(a, b)
    _close(td.grad_offset(p, torch.float64, CPU),
           jd.grad_offset(p, jnp.float64))
    assert (td.HAS_GRAM, td.SAMPLE_MEAN, td.SUPPORTS_WEIGHTS) == \
        (jd.HAS_GRAM, jd.SAMPLE_MEAN, jd.SUPPORTS_WEIGHTS)


@pytest.mark.parametrize("jp", J_BLOCK, ids=BLOCK_IDS)
def test_block_codec(jp):
    tp = from_reference(jp)
    cls = type(tp)
    assert PENALTY_IDS[cls] == {"BlockL1": 7, "BlockMCP": 8}[cls.__name__]
    assert make_penalty(cls, penalty_params(tp)) == tp
    check_score_kernel_penalty(cls)
    check_block_kernel_penalty(cls)
    assert cls in BLOCK_PENALTIES
    with pytest.raises(UnsupportedPenaltyError, match="block"):
        check_kernel_penalty(cls)
    with pytest.raises(UnsupportedPenaltyError, match="scalar"):
        check_block_kernel_penalty(tc.L1)


@pytest.mark.parametrize("jp", J_BLOCK, ids=BLOCK_IDS)
def test_block_working_set_and_anderson(jp):
    rng = np.random.default_rng(4)
    W = _rows(seed=4)
    G = rng.standard_normal(W.shape)
    L = rng.random(W.shape[0]) + 0.1
    _close(fixed_point_score(from_reference(jp), _t(W), _t(G), _t(L)),
           j_fixed_point_score(jp, jnp.asarray(W), jnp.asarray(G),
                               jnp.asarray(L)))
    _close(ws_occupancy(_t(W)), j_ws_occupancy(jnp.asarray(W)))
    hist = rng.standard_normal((6, 9, 3)).cumsum(axis=0)
    _close(anderson_extrapolate(_t(hist)), j_anderson(jnp.asarray(hist)),
           atol=1e-10, rtol=1e-10)


# ------------------------------------------------------ block kernel twins
def _block_inputs(n, p, T, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    R = rng.standard_normal((n, T))
    beta = rng.standard_normal((p, T)) * (rng.random((p, 1)) < 0.3)
    L = np.sum(X * X, axis=0) / n
    offset = rng.standard_normal(p) * 0.01
    return X, R, beta, L, offset


@pytest.mark.parametrize("use_fp", [False, True], ids=["sd", "fp"])
@pytest.mark.parametrize("jp", J_BLOCK, ids=BLOCK_IDS)
@pytest.mark.parametrize("n,p,T,ws,bp", [
    (40, 80, 6, 12, None),      # one tile
    (64, 256, 5, 32, 64),       # several even tiles
    (48, 100, 3, 16, 32),       # bp does not divide p: padded tail tile
])
def test_k3b_plain_matches_two_pass(jp, use_fp, n, p, T, ws, bp):
    X, R, beta, L, offset = _block_inputs(n, p, T, seed=p + ws)
    gsupp = np.asarray(jp.generalized_support(jnp.asarray(beta)))
    # the reference's two-pass head, with the [p] offset broadcast over T
    sc_ref, gr_ref, ws_ref, Xws_ref = _two_pass(
        *map(jnp.asarray, (X, R, beta, L, offset[:, None])), jp,
        jnp.asarray(gsupp), ws, use_fp)
    tp = from_reference(jp)
    gs = torch.as_tensor(gsupp.copy())
    sc, gr, _, ws_idx, Xt_ws = ops.fused_ws_block(
        _t(X.T).contiguous(), _t(R), _t(beta), _t(L), _t(offset), gs,
        type(tp), penalty_params(tp), ws, use_fp=use_fp, bp=bp)
    assert sc.shape == (p,) and gr.shape == (p, T)
    _close(sc, sc_ref, atol=1e-12, rtol=1e-11)
    _close(gr, gr_ref, atol=1e-12, rtol=1e-10)
    np.testing.assert_array_equal(ws_idx.numpy(), np.asarray(ws_ref))
    np.testing.assert_array_equal(Xt_ws.T.numpy(), np.asarray(Xws_ref))


@pytest.mark.parametrize("n,p,T,ws,bp", [
    (40, 80, 6, 12, None),      # one tile
    (64, 256, 5, 32, 64),       # several even tiles
    (48, 100, 3, 16, 32),       # bp does not divide p: padded tail tile
    (30, 90, 2, 90, 32),        # ws >= bp: every row a candidate
])
def test_k3b_head_rows_equal_candidate_columns(n, p, T, ws, bp):
    """The K3b head hands back the working set and its K rows of X (no
    candidate buffer on the card): those rows equal, bit for bit,
    ``candidate_columns`` of the plain version's four outputs, which stay
    the oracle; ``cand_idx`` is each tile's top-kc in ``lax.top_k`` order
    (the reference's own primitive, on the same priorities), padding slots
    index p."""
    X, R, beta, L, offset = _block_inputs(n, p, T, seed=3 * p + ws)
    jp = jc.BlockL1(0.05)
    gsupp = np.asarray(jp.generalized_support(jnp.asarray(beta)))
    tp = from_reference(jp)
    args = (_t(X.T).contiguous(), _t(R), _t(beta), _t(L), _t(offset),
            torch.as_tensor(gsupp.copy()), type(tp), penalty_params(tp), ws)
    sc, gr, ci, ws_idx, Xt_ws = ops.fused_ws_block(*args, bp=bp)
    sr, grr, cir, ccr = fused_ws_plain(*args, bp=bp)
    assert torch.equal(sc, sr) and torch.equal(gr, grr)
    assert torch.equal(ws_idx, select_working_set(sr, args[5], ws))
    assert torch.equal(Xt_ws, candidate_columns(cir, ccr, ws_idx, p).T)
    assert torch.equal(Xt_ws, args[0][ws_idx])
    # cand_idx: lax.top_k per tile of the priorities, padded with -inf
    bp_ = p if bp is None else bp
    tiles = -(-p // bp_)
    kc = min(bp_, ws)
    pri = np.full(tiles * bp_, -np.inf)
    pri[:p] = np.where(gsupp, np.inf, sr.numpy()) + 0.0
    top = np.asarray(jax.lax.top_k(jnp.asarray(pri.reshape(tiles, bp_)),
                                   kc)[1]) + bp_ * np.arange(tiles)[:, None]
    want = np.where(top < p, top, p).reshape(-1)
    np.testing.assert_array_equal(ci.numpy(), want)
    np.testing.assert_array_equal(cir.numpy(), want)


@pytest.mark.parametrize("T", [1, 4, 20])
@pytest.mark.parametrize("src", ["random", "edges"])
def test_k5b_plain_matches_pallas_interpret(src, T):
    rng = np.random.default_rng(5)
    X = sp.random(300, 600, density=0.02, random_state=2, format="csc",
                  data_rvs=rng.standard_normal)
    if src == "edges":
        X = X.tolil()
        X[:, :7] = 0.0                           # empty columns
        X[:, 11] = rng.standard_normal((300, 1))  # one dense column
        X = X.tocsc()
        X.eliminate_zeros()
    jd = JCSCDesign.from_scipy(X, ell=True)
    td = CSCDesign.from_scipy(X, ell=True, device=CPU)
    raw = rng.standard_normal((X.shape[0], T))
    ops.reset_launch_counts()
    got = ops.csc_score_block(td.data, td.indices, td.col_ids, td.indptr,
                              _t(raw))
    want = csc_score_pallas(jd.ell_rows, jd.ell_vals, jnp.asarray(raw),
                            interpret=True)
    _close(got, want, atol=1e-10, rtol=1e-10)
    _close(got, X.T @ raw, atol=1e-10, rtol=1e-10)
    assert ops.csc_score_block.launches == 0      # CPU: the plain version
    # the design routes a 2-D raw gradient to K5b
    _close(td.score(_t(raw), use_kernels=True), got, atol=0, rtol=0)


@pytest.mark.parametrize("jp", J_BLOCK, ids=BLOCK_IDS)
@pytest.mark.parametrize("K,T", [(8, 3), (64, 6), (120, 20)])
def test_k1b_plain_matches_reference_epoch(jp, K, T):
    rng = np.random.default_rng(K + T)
    X = rng.standard_normal((3 * K, K))
    G = X.T @ X / (3 * K)
    c = X.T @ rng.standard_normal((3 * K, T)) / (3 * K)
    beta0 = rng.standard_normal((K, T)) * 0.1 * (rng.random((K, 1)) < 0.5)
    L = np.diag(G).copy()
    L[1] = 0.0                                   # L_j = 0: row stays put
    tp = from_reference(jp)
    for epochs in (1, 3):
        b, q = jnp.asarray(beta0), jnp.asarray(G @ beta0)
        for _ in range(epochs):
            b, q = j_cd_epoch_gram(jnp.asarray(G), jnp.asarray(c), b, q,
                                   jnp.asarray(L), jp)
        Gc = _t(G).t().contiguous().t()
        bk, qk = ops.cd_epoch_gram_block(Gc, _t(c), _t(beta0),
                                         _t(G @ beta0), _t(L), type(tp),
                                         penalty_params(tp), epochs=epochs)
        _close(bk, b)
        _close(qk, q)
        np.testing.assert_array_equal(bk.numpy()[1], beta0[1])


def test_block_wrappers_reject_bad_input():
    K, T = 8, 3
    G = torch.zeros(K, K, dtype=torch.float64)
    B = torch.zeros(K, T, dtype=torch.float64)
    v = torch.zeros(K, dtype=torch.float64)
    prm = penalty_params(tc.BlockL1(0.1))
    with pytest.raises(UnsupportedPenaltyError):
        ops.cd_epoch_gram_block(G, B, B, B, v, tc.L1, penalty_params(
            tc.L1(0.1)))
    with pytest.raises(ValueError):
        ops.cd_epoch_gram_block(G, B[:, :2], B, B, v, tc.BlockL1, prm)
    with pytest.raises(ValueError):
        ops.cd_epoch_gram_block(G, v, v, v, v, tc.BlockL1, prm)
    with pytest.raises(ValueError):
        ops.fused_ws_block(G, B.t(), B, v, v, v > 0, tc.BlockL1, prm, 4)
    with pytest.raises(UnsupportedPenaltyError):
        ops.fused_ws(G, v, v, v, v, v > 0, tc.BlockL1, prm, 4)
    d = CSCDesign.from_scipy(sp.random(K, 5, density=0.5, random_state=0),
                             device=CPU)
    args = (d.data, d.indices, d.col_ids, d.indptr)
    with pytest.raises(ValueError):
        ops.csc_score_block(*args, torch.zeros(K, dtype=torch.float64))
    with pytest.raises(ValueError):
        ops.csc_score(*args, torch.zeros(K, T, dtype=torch.float64))


# -------------------------------------------------------------- solve parity
KW = dict(tol=1e-10, max_outer=80)
INPUTS = ["dense", "scipy", "csc"]


@functools.lru_cache(maxsize=None)
def _problem():
    """A sparse multitask design (20% density) on make_multitask's
    fixture widths, its targets and lambda_max."""
    X, Y, W = make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12, seed=0)
    Xs = sp.csc_matrix(X * (np.random.default_rng(0).random(X.shape) < 0.2))
    Y = Xs @ W + 0.3 * np.random.default_rng(1).standard_normal(Y.shape)
    lmax = jc.lambda_max(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                         jc.MultitaskQuadratic())
    return Xs, Y, lmax


def _weights():
    w = np.random.default_rng(6).random(150) * 2.0
    w[:10] = 0.0
    return w


@functools.lru_cache(maxsize=None)
def _reference(pen_name, weighted, warm):
    """The JAX beta of a case (jax backend, dense input)."""
    Xs, Y, lmax = _problem()
    w = _weights() if weighted else None
    lam = lmax / 8
    jp = jpen.BlockL1(lam) if pen_name == "BlockL1" \
        else jpen.BlockMCP(lam, 3.0)
    beta0 = None
    if warm:
        beta0 = np.asarray(jc.solve(
            jnp.asarray(Xs.toarray()), jnp.asarray(Y),
            jc.MultitaskQuadratic(), dataclasses.replace(jp, lam=2 * lam),
            sample_weight=w, use_kernels=False, **KW).beta)
    res = jc.solve(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                   jc.MultitaskQuadratic(), jp, sample_weight=w,
                   beta0=None if beta0 is None else jnp.asarray(beta0),
                   use_kernels=False, **KW)
    assert res.converged
    return jp, w, beta0, np.asarray(res.beta)


def _count_calls(monkeypatch):
    calls = {}
    for name in ("fused_ws_block", "csc_score_block", "cd_epoch_gram_block",
                 "fused_ws", "csc_score", "cd_epoch_gram", "cd_epoch_xb"):
        calls[name] = 0
        fn = getattr(ops, name)

        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(ops, name, counted)
    return calls


def _input(kind, use_kernels):
    Xs = _problem()[0]
    if kind == "dense":
        return Xs.toarray()
    if kind == "scipy":
        return Xs
    return CSCDesign.from_scipy(Xs, ell=use_kernels, device=CPU)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("gram", [True, False], ids=["gram", "xb"])
@pytest.mark.parametrize("kind", INPUTS)
@pytest.mark.parametrize("pen_name", ["BlockL1", "BlockMCP"])
def test_multitask_solve_matches_jax(pen_name, kind, gram, use_kernels,
                                     monkeypatch):
    jp, _, _, beta_j = _reference(pen_name, False, False)
    Y = _problem()[1]
    X = _input(kind, use_kernels)
    calls = _count_calls(monkeypatch)
    res = tc.solve(X, Y, tc.MultitaskQuadratic(), from_reference(jp),
                   device=CPU, use_gram=gram, use_kernels=use_kernels, **KW)
    assert res.converged and res.beta.shape == (300, 6)
    np.testing.assert_allclose(res.beta.numpy(), beta_j, atol=1e-8)
    heads = len(res.kkt_history)
    dense = kind == "dense"
    want = dict.fromkeys(calls, 0)
    if use_kernels:
        # K3b (dense) or K5b (sparse) on every head, K1b on every Gram
        # epoch; the Xb form runs the plain block epoch
        want["fused_ws_block" if dense else "csc_score_block"] = heads
        want["cd_epoch_gram_block"] = res.n_epochs if gram else 0
    assert calls == want
    assert res.n_host_syncs == heads


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kind", ["dense", "csc"])
@pytest.mark.parametrize("case", ["weighted", "warm"])
@pytest.mark.parametrize("pen_name", ["BlockL1", "BlockMCP"])
def test_multitask_weighted_and_warm_match_jax(pen_name, case, kind,
                                               use_kernels):
    jp, w, beta0, beta_j = _reference(pen_name, case == "weighted",
                                      case == "warm")
    res = tc.solve(_input(kind, use_kernels), _problem()[1],
                   tc.MultitaskQuadratic(), from_reference(jp),
                   sample_weight=w, device=CPU, use_kernels=use_kernels,
                   beta0=None if beta0 is None else warm_start(beta0,
                                                               device=CPU),
                   **KW)
    assert res.converged
    np.testing.assert_allclose(res.beta.numpy(), beta_j, atol=1e-8)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_leadfield_fits_match_jax(use_kernels):
    """The Figure 4 workload at a small size: BlockL1 and BlockMCP."""
    X, Y, _, _ = make_leadfield(n=36, p_per_hemi=40, T=5, seed=0)
    lmax = jc.lambda_max(jnp.asarray(X), jnp.asarray(Y),
                         jc.MultitaskQuadratic())
    assert tc.lambda_max(X, Y, tc.MultitaskQuadratic(), device=CPU) == \
        pytest.approx(lmax, rel=1e-12)
    for j_solver, t_solver, extra in (
            (jc.multitask_lasso, tc.multitask_lasso, {}),
            (jc.multitask_mcp, tc.multitask_mcp, {"gamma": 3.0})):
        rj = j_solver(jnp.asarray(X), jnp.asarray(Y), lmax / 5, **extra,
                      use_kernels=False, **KW)
        rt = t_solver(X, Y, lmax / 5, **extra, device=CPU,
                      use_kernels=use_kernels, **KW)
        assert rj.converged and rt.converged
        np.testing.assert_allclose(rt.beta.numpy(), np.asarray(rj.beta),
                                   atol=1e-8)


# -------------------------------------------------- entry points, estimators
@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
def test_multitask_lambda_max(weighted):
    Xs, Y, _ = _problem()
    w = _weights() if weighted else None
    want = jc.lambda_max(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                         jc.MultitaskQuadratic(), sample_weight=w)
    for X in (Xs.toarray(), Xs, CSCDesign.from_scipy(Xs, device=CPU)):
        got = tc.lambda_max(X, Y, tc.MultitaskQuadratic(), sample_weight=w,
                            device=CPU)
        assert got == pytest.approx(want, rel=1e-12)


@pytest.mark.parametrize("name,hyper", [
    ("MultiTaskLasso", dict(alpha=0.05)),
    ("MultiTaskMCP", dict(alpha=0.08, gamma=3.0))], ids=["Lasso", "MCP"])
@pytest.mark.parametrize("weighted", [False, True], ids=["w0", "w1"])
def test_multitask_estimators_match_jax(name, hyper, weighted):
    X, Y, _ = make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12, seed=0)
    Y = Y + 2.0                                      # a nonzero intercept
    w = _weights() if weighted else None
    kw = dict(tol=1e-10, fit_intercept=True)
    ej = getattr(jc, name)(**hyper, **kw).fit(jnp.asarray(X), jnp.asarray(Y),
                                              sample_weight=w)
    et = getattr(tc, name)(**hyper, **kw).fit(X, Y, sample_weight=w,
                                              device=CPU)
    assert et.converged_ and et.coef_.shape == (300, 6)
    assert np.shape(et.intercept_) == (6,)
    np.testing.assert_allclose(et.coef_, np.asarray(ej.coef_), atol=1e-8)
    np.testing.assert_allclose(et.intercept_, np.asarray(ej.intercept_),
                               atol=1e-8)
    pred = et.predict(X)
    assert pred.shape == (150, 6)
    np.testing.assert_allclose(pred, np.asarray(ej.predict(jnp.asarray(X))),
                               atol=1e-7)
    assert et.score(X, Y) == pytest.approx(
        float(ej.score(jnp.asarray(X), jnp.asarray(Y))), abs=1e-8)


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
def test_multitask_estimator_sparse_input(use_kernels):
    Xs, Y, lmax = _problem()
    ej = jc.MultiTaskLasso(alpha=lmax / 8, tol=1e-10).fit(Xs, Y)
    design = CSCDesign.from_scipy(Xs, ell=True, device=CPU)
    for Xin in (Xs, design):
        et = tc.MultiTaskLasso(alpha=lmax / 8, tol=1e-10,
                               use_kernels=use_kernels).fit(Xin, Y,
                                                            device=CPU)
        np.testing.assert_allclose(et.coef_, np.asarray(ej.coef_),
                                   atol=1e-8)
        for Xp in (Xs, design, Xs.toarray()):
            np.testing.assert_allclose(et.predict(Xp), ej.predict(Xs),
                                       atol=1e-8)
    # fit_intercept would densify a sparse design, as in the reference
    with pytest.raises(NotImplementedError) as e_ref:
        jc.MultiTaskLasso(alpha=0.1, fit_intercept=True).fit(Xs, Y)
    with pytest.raises(NotImplementedError) as e_port:
        tc.MultiTaskLasso(alpha=0.1, fit_intercept=True).fit(Xs, Y,
                                                             device=CPU)
    assert str(e_port.value) == str(e_ref.value)


def test_multitask_conversions():
    X, Y, _ = make_multitask(n=150, p=300, n_tasks=6, n_nonzero=12, seed=0)
    for jobj in (jpen.BlockL1(0.2), jpen.BlockMCP(0.2, 2.5),
                 jc.MultitaskQuadratic()):
        tobj = from_reference(jobj)
        assert type(tobj).__name__ == type(jobj).__name__
        assert dataclasses.asdict(tobj) == dataclasses.asdict(jobj)
    ej = jc.MultiTaskMCP(alpha=0.1, fit_intercept=True, tol=1e-8).fit(
        jnp.asarray(X), jnp.asarray(Y + 1.0))
    et = load_fitted(tc.MultiTaskMCP(alpha=0.1), ej.coef_, ej.intercept_)
    assert et.coef_.shape == (300, 6) and et.intercept_.shape == (6,)
    np.testing.assert_allclose(et.predict(X),
                               np.asarray(ej.predict(jnp.asarray(X))),
                               atol=1e-12, rtol=1e-12)
    # a converged reference fit as a warm start passes at the first head
    jp = jpen.BlockMCP(0.1, 3.0)
    rj = jc.solve(jnp.asarray(X), jnp.asarray(Y), jc.MultitaskQuadratic(),
                  jp, tol=1e-10, use_kernels=False)
    rt = tc.solve(X, Y, tc.MultitaskQuadratic(), from_reference(jp),
                  device=CPU, tol=1e-8,
                  beta0=warm_start(np.asarray(rj.beta), device=CPU))
    assert rt.converged and rt.n_outer == 0 and rt.n_host_syncs == 2
    np.testing.assert_array_equal(rt.beta.numpy(), np.asarray(rj.beta))


@pytest.mark.parametrize("use_kernels", [False, True],
                         ids=["plain", "kernels"])
@pytest.mark.parametrize("kind", INPUTS)
def test_multitask_scalar_penalty_raises_reference_text(kind, use_kernels):
    Xs, Y, _ = _problem()
    with pytest.raises(NotImplementedError) as e_ref:
        jc.solve(jnp.asarray(Xs.toarray()), jnp.asarray(Y),
                 jc.MultitaskQuadratic(), jc.L1(0.1))
    with pytest.raises(NotImplementedError) as e_port:
        tc.solve(_input(kind, use_kernels), Y, tc.MultitaskQuadratic(),
                 tc.L1(0.1), device=CPU, use_kernels=use_kernels)
    assert "block penalty" in str(e_ref.value)
    assert str(e_port.value) == str(e_ref.value)
