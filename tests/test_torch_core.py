"""Parity of the port's core pieces with the JAX package, on the CPU.

The same seeded numpy inputs go through ``repro.core`` (JAX, float64) and
``repro_torch.core`` (torch, float64): the seven scalar penalties, the three
datafits, the penalty codec, working-set selection and Anderson
extrapolation. Tolerance: 1e-12 absolute plus 1e-12 relative unless a test
says otherwise (the arithmetic is the same op sequence; only library
rounding of pow/acos/cbrt differs).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.datafits as jdf
import repro.core.penalties as jpen
from repro.core.anderson import anderson_extrapolate as j_anderson
from repro.core.working_set import select_working_set as j_select
from repro_torch.convert import from_reference
from repro_torch.core.anderson import anderson_extrapolate
from repro_torch.core.working_set import (BucketPolicy, grow_ws_size,
                                          select_working_set)
from repro_torch.kernels.common import (UnsupportedPenaltyError,
                                        make_penalty, penalty_params)

ATOL = RTOL = 1e-12
J_PENALTIES = [jpen.L1(0.7), jpen.L1L2(0.7, 0.5), jpen.MCP(0.7, 3.0),
               jpen.SCAD(0.7, 3.7), jpen.L05(0.3), jpen.L23(0.3),
               jpen.Box(1.5)]
IDS = [type(p).__name__ for p in J_PENALTIES]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _close(a, b, atol=ATOL, rtol=RTOL):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), atol=atol,
                               rtol=rtol)


def _edges(pen, step):
    """Points at and around each penalty's thresholds for `step`."""
    lam = getattr(pen, "lam", getattr(pen, "C", 1.0))
    g = getattr(pen, "gamma", 3.0)
    t = step * lam
    pts = [0.0, t, g * lam, lam * (1 + step), lam, 1.5 * t ** (2 / 3),
           getattr(pen, "C", 1.0)]
    pts = np.asarray(pts)
    pts = np.concatenate([pts, pts * (1 + 1e-9), pts * (1 - 1e-9)])
    return np.concatenate([pts, -pts])


@pytest.mark.parametrize("jp", J_PENALTIES, ids=IDS)
def test_penalty_parity(jp):
    """value / prox / subdiff_dist / generalized_support against JAX, on
    random points, the zero region and every threshold edge."""
    tp = from_reference(jp)
    rng = np.random.default_rng(0)
    for step in (0.5, 1.0, 0.25):
        x = np.concatenate([rng.standard_normal(64) * 3.0,
                            _edges(jp, step)])
        steps = np.full_like(x, step)
        _close(tp.prox(_t(x), _t(steps)),
               jp.prox(jnp.asarray(x), jnp.asarray(steps)))
        # scalar step too (the Anderson candidate uses prox(., 0.0))
        _close(tp.prox(_t(x), step), jp.prox(jnp.asarray(x), step))
    _close(tp.prox(_t(x), 0.0), jp.prox(jnp.asarray(x), 0.0))
    beta = np.concatenate([rng.standard_normal(40) * (rng.random(40) < 0.5),
                           _edges(jp, 1.0)])
    grad = rng.standard_normal(beta.shape[0])
    _close(tp.subdiff_dist(_t(grad), _t(beta)),
           jp.subdiff_dist(jnp.asarray(grad), jnp.asarray(beta)))
    np.testing.assert_array_equal(
        tp.generalized_support(_t(beta)).numpy(),
        np.asarray(jp.generalized_support(jnp.asarray(beta))))
    _close(tp.value(_t(beta)), jp.value(jnp.asarray(beta)))
    assert tp.HAS_SUBDIFF == jp.HAS_SUBDIFF


# (datafit, weighted): QuadraticSVC has no weighted form
DATAFIT_CASES = [(jdf.Quadratic(), False), (jdf.Quadratic(), True),
                 (jdf.Logistic(), False), (jdf.Logistic(), True),
                 (jdf.QuadraticSVC(), False)]


@pytest.mark.parametrize("jd,weighted", DATAFIT_CASES,
                         ids=[f"{type(d).__name__}-w{int(w)}"
                              for d, w in DATAFIT_CASES])
def test_datafit_parity(jd, weighted):
    """value / raw_grad / lipschitz / grad_offset / make_gram against JAX,
    with and without the sample-weight leaf."""
    td = from_reference(jd)
    rng = np.random.default_rng(1)
    n, p = 40, 25
    X = rng.standard_normal((n, p))
    y = np.sign(rng.standard_normal(n))
    Xb = rng.standard_normal(n) * 2.0
    w = rng.random(n) * 2.0 if weighted else None
    jw = None if w is None else jnp.asarray(w)
    tw = None if w is None else _t(w)
    jargs, targs = (jnp.asarray(Xb), jnp.asarray(y)), (_t(Xb), _t(y))
    _close(td.value(*targs, tw), jd.value(*jargs, jw))
    _close(td.raw_grad(*targs, tw), jd.raw_grad(*jargs, jw))
    _close(td.lipschitz(_t(X), tw), jd.lipschitz(jnp.asarray(X), jw))
    _close(td.grad_offset(p, torch.float64, "cpu"),
           jd.grad_offset(p, jnp.float64))
    if jd.HAS_GRAM:
        G_t, c_t = td.make_gram(_t(X), _t(y), tw)
        G_j, c_j = jd.make_gram(jnp.asarray(X), jnp.asarray(y), jw)
        _close(G_t, G_j)
        _close(c_t, c_j)
    for flag in ("HAS_GRAM", "SAMPLE_MEAN", "SUPPORTS_WEIGHTS"):
        assert getattr(td, flag) == getattr(jd, flag)


@pytest.mark.parametrize("jp", J_PENALTIES, ids=IDS)
def test_codec_roundtrip(jp):
    """Every ported penalty round-trips exactly through the codec, with the
    reference's arity."""
    from repro.kernels.common import PENALTY_FIELDS as J_FIELDS
    tp = from_reference(jp)
    params = penalty_params(tp)
    assert params.shape == (len(J_FIELDS[type(jp)]),)
    assert make_penalty(type(tp), params) == tp


def test_codec_rejects_array_lambda_and_unregistered():
    import dataclasses
    from repro_torch.core.penalties import L1

    with pytest.raises(UnsupportedPenaltyError):
        penalty_params(L1(torch.ones(7)))
    with pytest.raises(UnsupportedPenaltyError):
        penalty_params(L1(np.ones(7)))

    @dataclasses.dataclass(frozen=True)
    class ThreeParam:
        lam: float
        gamma: float
        tau: float

    with pytest.raises(UnsupportedPenaltyError):
        penalty_params(ThreeParam(0.1, 3.0, 0.5))


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("ws_size", [1, 7, 32, 100])
def test_select_working_set_matches_top_k_on_ties(seed, ws_size):
    """Integer-valued scores tie everywhere: the port's stable sort must
    give lax.top_k's order exactly (priority descending, lowest index first
    on ties, generalized support pinned to +inf)."""
    rng = np.random.default_rng(seed)
    p = 100
    scores = rng.integers(0, 4, p).astype(np.float64)
    gsupp = rng.random(p) < 0.05
    ref = j_select(jnp.asarray(scores), jnp.asarray(gsupp), ws_size)
    out = select_working_set(_t(scores), torch.as_tensor(gsupp), ws_size)
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_anderson_matches_reference():
    rng = np.random.default_rng(3)
    base = rng.standard_normal(30)
    hist = np.stack([base * 0.8 ** k + 0.01 * rng.standard_normal(30)
                     for k in range(6)])
    _close(anderson_extrapolate(_t(hist)), j_anderson(jnp.asarray(hist)),
           atol=1e-10, rtol=1e-9)
    # a flat history falls back to the last iterate on both sides
    flat = np.tile(base, (6, 1))
    _close(anderson_extrapolate(_t(flat)), j_anderson(jnp.asarray(flat)))


def test_bucket_policy_matches_reference():
    from repro.bucketing import pow2_bucket as j_pow2_bucket
    from repro.core.working_set import BucketPolicy as JPolicy
    from repro.core.working_set import grow_ws_size as j_grow
    from repro_torch.bucketing import pow2_bucket
    for p in (64, 240, 2000, 5000):
        assert BucketPolicy(p0=64).ladder(p) == JPolicy(p0=64).ladder(p)
        assert BucketPolicy().escalate(100, p) == JPolicy().escalate(100, p)
        for prev, g in ((0, 0), (64, 100), (512, 3), (1024, 700)):
            assert grow_ws_size(prev, g, p) == j_grow(prev, g, p)
            assert pow2_bucket(g, prev, p) == j_pow2_bucket(g, prev, p)


def test_ws_occupancy_and_scatter_match_reference():
    from repro.core.working_set import scatter_ws as j_scatter
    from repro.core.working_set import ws_occupancy as j_occ
    from repro_torch.core.working_set import scatter_ws, ws_occupancy
    rng = np.random.default_rng(5)
    beta_ws = rng.standard_normal(16) * (rng.random(16) < 0.4)
    _close(ws_occupancy(_t(beta_ws)), j_occ(jnp.asarray(beta_ws)))
    vec, ws = rng.standard_normal(40), rng.permutation(40)[:16]
    ref = j_scatter(jnp.asarray(vec), None, jnp.asarray(ws),
                    jnp.asarray(beta_ws))
    out = scatter_ws(_t(vec), torch.as_tensor(ws), _t(beta_ws))
    np.testing.assert_array_equal(out.numpy(), np.asarray(ref))


def test_jax_runs_in_x64():
    """The parity tests compare float64 on both sides."""
    assert jax.config.jax_enable_x64


@pytest.mark.parametrize("src", ["numpy", "tensor", "f32", "view"])
@pytest.mark.parametrize("chunk", [32 * 2**20, 3 * 8 * 23])
def test_dense_design_from_dense_equals_transposed_copy(monkeypatch, src,
                                                        chunk):
    """``DenseDesign.from_dense`` moves X in row chunks (at 3 rows a chunk
    here, a ragged last one included) and equals the one-shot
    construction ``X.t().contiguous()`` bit for bit, dtype kept; a tensor
    whose transpose is contiguous is taken as it is, without a copy."""
    from repro_torch.core import engine
    monkeypatch.setattr(engine, "X_CHUNK_BYTES", chunk)
    X = np.random.default_rng(0).standard_normal((40, 23))
    if src == "f32":
        X = X.astype(np.float32)
    if src in ("tensor", "view"):
        X = torch.as_tensor(X)
    if src == "view":
        X = X.t().contiguous().t()
    d = engine.DenseDesign.from_dense(X, "cpu")
    want = torch.as_tensor(X).t().contiguous()
    assert d.Xt.is_contiguous() and d.Xt.dtype == want.dtype
    assert torch.equal(d.Xt, want) and d.shape == (40, 23)
    if src == "view":
        assert d.Xt.data_ptr() == X.data_ptr()
