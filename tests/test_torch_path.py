"""The port's regularization paths, gap-safe screening and column subsets
on the CPU, against the JAX package's jax backend.

The same seeded numpy data go through ``repro.core.reg_path`` (the
reference's jax backend, as its own green tests run it) and
``repro_torch.core.reg_path(device="cpu")`` on both routes (plain torch,
and the kernel route's engine logic with the kernels' plain versions).
Bounds: 1e-6 on the betas of dense paths (``tests/test_engine.py``), 1e-7
on CSC paths and on a screened path against the unscreened one
(``tests/test_sparse.py``). Also: the penalties with 0-d tensor fields
(what the kernel route's captured step runs on) held bit for bit to the
float penalties, the gap-safe mask, ``take_columns`` and its refill in
place, ``support_metrics`` and the rejections.
"""
import dataclasses
import functools

import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse as sp
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import repro.core as jc
from repro.core.engine import DenseDesign as JDenseDesign
from repro.core.screening import gap_safe_mask_design as j_mask_design
from repro.core.screening import lasso_gap_safe_mask as j_lasso_mask
from repro.data.synth import (make_classification, make_correlated_design,
                              make_multitask, make_sparse_design)
from repro.sparse import CSCDesign as JCSCDesign
import repro_torch.core as tc
from repro_torch.convert import from_reference
from repro_torch.core import penalties as P
from repro_torch.core.engine import DenseDesign
from repro_torch.core.path import _check_grid, _slot
from repro_torch.core.working_set import violation_scores
from repro_torch.kernels.common import (PENALTY_FIELDS, bind_penalty,
                                        penalty_params)
from repro_torch.sparse import CSCDesign

ROUTES = pytest.mark.parametrize("use_kernels", [False, True],
                                 ids=["plain", "kernels"])


def _sparse():
    """The reference's ``sparse_data`` (tests/test_sparse.py)."""
    return make_sparse_design(n=400, p=1200, density=5e-3, n_nonzero=30,
                              seed=0)


def _dense():
    return make_correlated_design(n=120, p=240, n_nonzero=10, seed=0)


# name -> (data, datafit, penalty template, path keywords, bound)
PATH_CASES = {
    "dense-L1": ("dense", jc.Quadratic(), jc.L1(1.0), {}, 1e-6),
    "dense-L1L2": ("dense", jc.Quadratic(), jc.L1L2(1.0, 0.5), {}, 1e-6),
    "dense-MCP": ("dense", jc.Quadratic(), jc.MCP(1.0, 3.0), {}, 1e-6),
    "dense-SCAD": ("dense", jc.Quadratic(), jc.SCAD(1.0, 3.7), {}, 1e-6),
    "csc-L1": ("sparse", jc.Quadratic(), jc.L1(1.0),
               dict(lambda_min_ratio=0.05), 1e-7),
    "weighted-logistic-L1": ("logistic", jc.Logistic(), jc.L1(1.0),
                             dict(lambda_min_ratio=0.3), 1e-6),
    "multitask-BlockL1": ("multitask", jc.MultitaskQuadratic(),
                          jc.BlockL1(1.0), dict(lambda_min_ratio=0.1), 1e-6),
}
PATH_KW = dict(n_lambdas=5, tol=1e-9)


def _case_data(kind):
    """(X, y, sample_weight) of a path case, numpy / scipy."""
    if kind == "dense":
        return _dense()[:2] + (None,)
    if kind == "sparse":
        return _sparse()[:2] + (None,)
    if kind == "logistic":
        X, y, _ = make_classification(n=120, p=240, n_nonzero=10, seed=0)
        w = np.random.default_rng(5).uniform(0.5, 1.5, X.shape[0])
        return X, y, w
    X, Y, _ = make_multitask(n=80, p=160, n_tasks=4, n_nonzero=8, seed=0)
    return X, Y, None


def _jax_X(X):
    return X if sp.issparse(X) else jnp.asarray(X)


@functools.lru_cache(maxsize=None)
def _reference_path(name):
    kind, datafit, penalty, kw, _ = PATH_CASES[name]
    X, y, w = _case_data(kind)
    res = jc.reg_path(_jax_X(X), jnp.asarray(y), penalty, datafit,
                      engine=jc.make_engine(penalty, datafit),
                      sample_weight=w, **PATH_KW, **kw)
    assert np.all(res.kkts <= PATH_KW["tol"])
    return res


@ROUTES
@pytest.mark.parametrize("name", list(PATH_CASES))
def test_path_matches_jax(name, use_kernels):
    kind, datafit, penalty, kw, bound = PATH_CASES[name]
    X, y, w = _case_data(kind)
    ref = _reference_path(name)
    res = tc.reg_path(X, y, from_reference(penalty), from_reference(datafit),
                      sample_weight=w, device="cpu", use_kernels=use_kernels,
                      **PATH_KW, **kw)
    np.testing.assert_allclose(res.lambdas, ref.lambdas, rtol=1e-12)
    assert np.all(res.kkts <= PATH_KW["tol"])
    assert res.betas.shape == ref.betas.shape
    np.testing.assert_allclose(res.betas, np.asarray(ref.betas), atol=bound)
    np.testing.assert_array_equal(res.nnzs, ref.nnzs)
    # reads: one a step, one probe a warm start, lambda_max, the betas
    steps = res.n_outer + (res.kkts <= PATH_KW["tol"])
    assert res.n_host_syncs == int(np.sum(steps)) + (len(res.lambdas) - 1) \
        + 2
    assert res.captures == {}                # nothing is captured on the CPU
    assert set(res.diagnostics) == {"kkt", "epochs", "time_s", "capture_s"}


@ROUTES
@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_screened_path_matches_unscreened(kind, use_kernels):
    """screen='gap_safe' is safe: the same solutions within 1e-7, the rule
    fires (tests/test_sparse.py), and the reference's screened path
    agrees."""
    X, y, _ = _sparse()
    Xin = X if kind == "sparse" else X.toarray()
    kw = dict(n_lambdas=6, lambda_min_ratio=0.05, tol=1e-9, device="cpu",
              use_kernels=use_kernels)
    ref = tc.reg_path(Xin, y, tc.L1(1.0), **kw)
    scr = tc.reg_path(Xin, y, tc.L1(1.0), screen="gap_safe", **kw)
    np.testing.assert_allclose(scr.betas, ref.betas, atol=1e-7)
    assert scr.screened_fracs.shape == (6,)
    assert np.max(scr.screened_fracs) > 0.1
    assert np.all(scr.kkts <= 1e-9)
    jscr = jc.reg_path(_jax_X(Xin), jnp.asarray(y), jc.L1(1.0),
                       n_lambdas=6, lambda_min_ratio=0.05, tol=1e-9,
                       engine=jc.make_engine(jc.L1(1.0), jc.Quadratic()),
                       screen="gap_safe")
    np.testing.assert_allclose(scr.betas, np.asarray(jscr.betas), atol=1e-7)
    # one read a lambda for the survivors, besides the solves' own
    assert scr.n_host_syncs > 6


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_screened_path_refills_its_slots(kind):
    """On a finer grid the survivors keep their power-of-two width from one
    lambda to the next: those solves refill the width's slot design in
    place, and the path stays within 1e-7 of the unscreened one."""
    X, y, _ = _sparse()
    Xin = X if kind == "sparse" else X.toarray()
    kw = dict(n_lambdas=20, lambda_min_ratio=0.05, tol=1e-9, device="cpu")
    ref = tc.reg_path(Xin, y, tc.L1(1.0), **kw)
    scr = tc.reg_path(Xin, y, tc.L1(1.0), screen="gap_safe", **kw)
    np.testing.assert_allclose(scr.betas, ref.betas, atol=1e-7)
    solved = int(np.sum(scr.screened_fracs < 1.0))
    refills, made = (scr.diagnostics["slot_refills"],
                     scr.diagnostics["slots_made"])
    assert refills > 0 and made > 0
    assert refills + made == solved


@pytest.mark.parametrize("kind", ["dense", "sparse"])
def test_new_slot_replaces_the_slots_no_wider_than_it(kind):
    """A slot of the same width is refilled; a new slot (wider, or a CSC
    slot without room) replaces every slot no wider than it, and the
    engine drops their captured steps; a wider slot is kept."""
    X, _, _ = _sparse()
    csc = kind == "sparse"
    design = CSCDesign.from_scipy(X, device="cpu") if csc \
        else DenseDesign.from_dense(X.toarray(), "cpu")
    nnz = np.diff(X.indptr)

    class Engine:
        dropped = []

        def drop_graphs(self, d):
            self.dropped.append(d)

    eng, slots = Engine(), {}

    def take(cols, width):
        idx = np.full(width, -1)
        idx[:len(cols)] = cols
        return _slot(slots, eng, design, torch.as_tensor(idx), width,
                     int(nnz[cols].sum()), csc)

    def columns(d, width):
        return torch.stack([d.matvec(v) for v in torch.eye(
            width, dtype=torch.float64)], dim=1)

    order = np.argsort(nnz, kind="stable")
    wide, refilled = take(order[:40], 64)
    assert not refilled and slots == {64: wide}
    a, refilled = take(order[:10], 16)
    assert not refilled and set(slots) == {16, 64}
    b, refilled = take(order[1:11], 16)
    assert refilled and b is a
    want = np.zeros((X.shape[0], 16))
    want[:, :10] = X.toarray()[:, order[1:11]]
    np.testing.assert_array_equal(columns(b, 16).numpy(), want)
    if csc:
        # the 16 busiest columns need more room than a's capacity
        busy = order[-16:]
        assert int(nnz[busy].sum()) + design.max_col_nnz > a.capacity
        c, refilled = take(busy, 16)
    else:
        c, refilled = take(order[:20], 32)
    assert not refilled and c is not a
    assert Engine.dropped == [a]
    assert slots == {64: wide, (16 if csc else 32): c}


def test_warm_path_equals_cold_solves():
    X, y, _ = _dense()
    engine = tc.make_engine(tc.L1(1.0), tc.Quadratic(), device="cpu")
    path = tc.reg_path(X, y, tc.L1(1.0), n_lambdas=6, lambda_min_ratio=0.03,
                       tol=1e-9, engine=engine)
    for lam, beta_warm in zip(path.lambdas, path.betas):
        cold = tc.solve(X, y, tc.Quadratic(), tc.L1(float(lam)), tol=1e-9,
                        device="cpu")
        np.testing.assert_allclose(beta_warm, cold.beta.numpy(), atol=1e-6)


def test_reg_path_warm_start_monotone_nnz():
    X, y, _ = make_correlated_design(n=250, p=500, n_nonzero=20, seed=0)
    res = tc.reg_path(X, y, tc.L1(1.0), n_lambdas=8, lambda_min_ratio=0.05,
                      tol=1e-7, device="cpu")
    assert res.betas.shape == (8, 500)
    assert res.nnzs[0] <= res.nnzs[-1]
    assert res.nnzs[0] == 0                      # at lambda_max beta = 0
    assert np.all(res.kkts <= 1e-6)


# ------------------------------------------------------------- screening
def _mask_inputs():
    X, y, _ = _sparse()
    lam = jc.lambda_max(X, jnp.asarray(y)) / 5
    res = jc.solve(X, jnp.asarray(y), jc.Quadratic(), jc.L1(lam), tol=1e-6)
    return X, y, np.asarray(res.beta), lam


def test_gap_safe_mask_matches_reference():
    """On dense input the mask equals the reference's; on CSC input it may
    differ only where the test statistic sits at the boundary (the segment
    sums' order moves the last bits; tests/test_sparse.py)."""
    X, y, beta, lam = _mask_inputs()
    Xd = X.toarray()
    ref = np.asarray(j_lasso_mask(jnp.asarray(Xd), jnp.asarray(y),
                                  jnp.asarray(beta), lam))
    assert np.array_equal(
        np.asarray(j_mask_design(JDenseDesign(jnp.asarray(Xd)),
                                 jnp.asarray(y), jnp.asarray(beta), lam)),
        ref)
    got_dense = tc.lasso_gap_safe_mask(Xd, y, beta, lam,
                                       device="cpu").numpy()
    np.testing.assert_array_equal(got_dense, ref)
    csc = CSCDesign.from_scipy(X, device="cpu")
    got_sparse = tc.gap_safe_mask_design(csc, y, beta, lam).numpy()
    resid = y - Xd @ beta
    n = X.shape[0]
    theta = resid / (lam * n)
    theta *= min(1.0, 1.0 / max(np.max(np.abs(Xd.T @ theta)), 1e-30))
    primal = resid @ resid / (2 * n) + lam * np.abs(beta).sum()
    dual = lam * (y @ theta) - 0.5 * lam ** 2 * n * (theta @ theta)
    r = np.sqrt(2.0 * max(primal - dual, 0.0) / n) / lam
    stat = np.abs(Xd.T @ theta) + r * np.sqrt((Xd * Xd).sum(0))
    disagree = got_sparse != ref
    assert np.all(np.abs(stat[disagree] - 1.0) < 1e-6)
    assert 0.1 < tc.screened_fraction(torch.as_tensor(ref)) < 1.0


# ---------------------------------------------------------- take_columns
IDX = np.array([5, -1, 0, 1199, 37, -1, 600, 601], np.int64)


@pytest.mark.parametrize("kind", ["dense", "csc"])
def test_take_columns_matches_reference(kind):
    """A column subset with -1 pads equals the reference's, and a refill in
    place of a design of the same width (and room) equals a fresh one."""
    X, _, _ = _sparse()
    if kind == "dense":
        Xd = X.toarray()
        got = DenseDesign.from_dense(Xd, "cpu").take_columns(IDX)
        ref = np.asarray(JDenseDesign(jnp.asarray(Xd)).take_columns(IDX).X)
        np.testing.assert_array_equal(got.X.numpy(), ref)
        np.testing.assert_array_equal(got.col_sq_norms().numpy(),
                                      (ref * ref).sum(0))
    else:
        jd = JCSCDesign.from_scipy(X.astype(np.float64), ell=True)
        jsub = jd.take_columns(IDX)
        d = CSCDesign.from_scipy(X, ell=True, device="cpu")
        got = d.take_columns(IDX)
        for f in ("data", "indices", "col_ids", "indptr", "col_sq"):
            np.testing.assert_array_equal(getattr(got, f).numpy(),
                                          np.asarray(getattr(jsub, f)), f)
        assert got.max_col_nnz == jsub.max_col_nnz == d.max_col_nnz
        assert got.shape == jsub.shape and got.has_ell
        np.testing.assert_array_equal(got.todense(), jsub.todense())
    # refill in place: another subset of the same width into `got`
    other = np.array([7, 8, 9, -1, -1, 1100, 2, 3], np.int64)
    src = DenseDesign.from_dense(X.toarray(), "cpu") if kind == "dense" \
        else CSCDesign.from_scipy(X, ell=True, device="cpu")
    fresh = src.take_columns(other)
    ptrs = [t.data_ptr() for t in
            ((got.Xt,) if kind == "dense" else (got.data, got.indptr))]
    kw = {} if kind == "dense" else {"nnz": int(fresh.indptr[-1])}
    out = src.take_columns(other, out=got, **kw)
    assert out is got
    assert ptrs == [t.data_ptr() for t in
                    ((got.Xt,) if kind == "dense" else (got.data,
                                                        got.indptr))]
    np.testing.assert_array_equal(
        got.X.numpy() if kind == "dense" else got.todense(),
        fresh.X.numpy() if kind == "dense" else fresh.todense())
    if kind == "csc":
        nnz = int(got.indptr[-1])
        assert torch.all(got.data[nnz:] == 0)
        assert torch.all(got.col_ids[nnz:] == len(other) - 1)
        np.testing.assert_array_equal(got.col_sq.numpy(),
                                      fresh.col_sq.numpy())
    with pytest.raises(ValueError, match="take_columns"):
        src.take_columns(other[:4], out=got)       # another width


def test_csc_refill_refuses_a_slot_without_room():
    X, _, _ = _sparse()
    d = CSCDesign.from_scipy(X, device="cpu")
    nnz = np.diff(X.indptr)
    small = np.argsort(nnz)[:8]
    big = np.argsort(nnz)[-8:]
    slot = d.take_columns(small)
    need = int(nnz[big].sum()) + d.max_col_nnz
    if need <= slot.capacity:
        pytest.skip("the design's columns are too even to overflow a slot")
    with pytest.raises(ValueError, match="room"):
        d.take_columns(big, out=slot)


# ------------------------------------------------------- support_metrics
def test_support_metrics_matches_reference():
    X, y, bt = _dense()
    rng = np.random.default_rng(0)
    beta = np.where(rng.uniform(size=bt.shape) < 0.05,
                    rng.standard_normal(bt.shape), 0.0)
    beta[np.flatnonzero(bt)[:4]] = 1.0
    for args in ((beta, bt), (beta, bt, X, y), (bt, bt)):
        ref = jc.support_metrics(*args)
        got = tc.support_metrics(*(torch.as_tensor(a) for a in args))
        assert got.keys() == ref.keys()
        for k in ref:
            assert got[k] == pytest.approx(ref[k], rel=1e-12), k


# -------------------------------------------------------------- rejections
@pytest.mark.parametrize("grid,match", [
    (np.ones((2, 2)), "1-D"), (np.array([]), "non-empty"),
    (np.array([1.0, np.inf]), "finite"), (np.array([1.0, -1.0]),
                                           "non-negative")])
def test_check_grid_errors(grid, match):
    with pytest.raises(ValueError, match=match):
        _check_grid(grid)
    with pytest.raises(ValueError, match=match):
        jc.path._check_grid(grid)


def test_check_grid_sorts_decreasing():
    grid = np.array([0.1, 1.0, 0.5])
    np.testing.assert_array_equal(_check_grid(grid),
                                  jc.path._check_grid(grid))
    np.testing.assert_array_equal(_check_grid(grid), [1.0, 0.5, 0.1])


def _raised(fn):
    with pytest.raises(Exception) as info:
        fn()
    return type(info.value), str(info.value)


@pytest.mark.parametrize("penalty,kw", [
    ("L1", dict(screen="unknown_rule")),
    ("MCP", dict(screen="gap_safe")),
    ("L1", dict(screen="gap_safe", vmap_chunk=2)),
    ("L1", dict(screen="gap_safe", sample_weight=np.ones(400))),
])
def test_screening_rejections_match_reference(penalty, kw):
    """The reference's rejections (tests/test_sparse.py), type and text."""
    X, y, _ = _sparse()
    jp = jc.L1(1.0) if penalty == "L1" else jc.MCP(1.0, 3.0)
    ref = _raised(lambda: jc.reg_path(X, jnp.asarray(y), jp, n_lambdas=4,
                                      **kw))
    got = _raised(lambda: tc.reg_path(X, y, from_reference(jp), n_lambdas=4,
                                      device="cpu", **kw))
    assert got == ref


@pytest.mark.parametrize("kw,match", [
    (dict(obs=object()), "obs"), (dict(mesh=object()), "mesh")])
def test_unported_options_raise(kw, match):
    """What reg_path does not run yet raises: obs= and mesh=."""
    X, y, _ = _dense()
    with pytest.raises(NotImplementedError, match=match):
        tc.reg_path(X, y, tc.L1(1.0), n_lambdas=3, device="cpu", **kw)


# ---------------------------------------------------- bound penalties
ALL_PENALTIES = [P.L1(0.3), P.L1L2(0.3, 0.6), P.MCP(0.3, 3.0),
                 P.SCAD(0.3, 3.7), P.L05(0.1), P.L23(0.1), P.Box(0.8),
                 P.BlockL1(0.3), P.BlockMCP(0.3, 3.0)]


class _Ops(TorchDispatchMode):
    """Records the aten ops that run inside it."""

    def __init__(self):
        super().__init__()
        self.ops = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops.add(str(func))
        return func(*args, **(kwargs or {}))


def _calls(pen, beta, grad, L):
    step = 1.0 / L if beta.ndim == 1 else (1.0 / L)[:, None]
    return [pen.value(beta), pen.prox(beta, 0.7), pen.prox(beta, step),
            pen.prox(beta, 0.0), pen.subdiff_dist(grad, beta),
            pen.generalized_support(beta),
            violation_scores(pen, beta, grad, L, use_fixed_point=False),
            violation_scores(pen, beta, grad, L, use_fixed_point=True)]


@pytest.mark.parametrize("pen", ALL_PENALTIES,
                         ids=lambda p: type(p).__name__)
def test_bound_penalty_equals_float_penalty_bit_for_bit(pen):
    """A penalty whose fields are 0-d views of its codec vector (the kernel
    route's step) gives the float penalty's results bit for bit, and its
    methods never read a value back to the host (no item())."""
    g = torch.Generator().manual_seed(0)
    shape = (60, 3) if type(pen).__name__.startswith("Block") else (60,)
    beta = torch.randn(shape, generator=g, dtype=torch.float64)
    beta[::4] = 0.0
    beta[1::7] = 0.8                              # Box's upper bound
    beta[2::9] = 3.0 * 0.3                        # the MCP / SCAD kinks
    grad = torch.randn(shape, generator=g, dtype=torch.float64)
    L = torch.rand(60, generator=g, dtype=torch.float64) + 0.1
    L[5] = 0.0
    prm = penalty_params(pen)
    bound = bind_penalty(type(pen), prm)
    assert [f.name for f in dataclasses.fields(bound)] == \
        list(PENALTY_FIELDS[type(pen)])
    with _Ops() as rec:
        got = _calls(bound, beta, grad, L)
    want = _calls(pen, beta, grad, L)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert not any("_local_scalar_dense" in op for op in rec.ops)
    # new values written into the vector change the penalty in place
    prm.mul_(2.0)
    moved = dataclasses.replace(pen, **{f: 2.0 * getattr(pen, f)
                                        for f in PENALTY_FIELDS[type(pen)]})
    assert torch.equal(bound.value(beta), moved.value(beta))
