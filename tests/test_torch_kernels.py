"""The port's kernels K1-K3: plain versions against the JAX oracles on the
CPU, CUDA kernels against their plain versions on a card.

K1's plain version is held against ``repro.kernels.ref.cd_epoch_gram_ref``
and K2's against ``cd_epoch_xb_ref`` (or the reference epoch with weights),
at the tolerances of the reference's kernel tests (``tests/test_kernels.py``:
1e-12 absolute + 1e-5 relative for the Gram epoch; 1e-11 + 1e-8 for the Xb
epoch). K3's head (the plain version with the working set taken from its scores
and its rows recovered from its candidate buffer) is held against
``_two_pass`` of ``tests/test_fused_ws.py`` on its shapes: identical working
sets, bit-exact gathered rows, scores within 1e-12 + 1e-11 relative and
gradients within 1e-12 + 1e-10 relative. The reference Pallas kernels themselves are not the
oracle: they do not run on this JAX version.

The CUDA kernels themselves are held against these plain versions on the
card by ``tests/test_torch_gpu.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.datafits as jdf
import repro.core.penalties as jpen
from repro.core.cd import cd_epoch_xb as j_cd_epoch_xb
from repro.kernels import ref as jref
from repro_torch.convert import from_reference
from repro_torch.core.working_set import candidate_columns, select_working_set
from repro_torch.kernels import ops
from repro_torch.kernels.common import penalty_params
from repro_torch.kernels.fused_ws import fused_ws_plain, pick_bp
from test_fused_ws import _two_pass

J_PENALTIES = [jpen.L1(0.11), jpen.L1L2(0.11, 0.6), jpen.MCP(0.11, 3.0),
               jpen.SCAD(0.11, 3.7), jpen.Box(0.8), jpen.L05(0.05),
               jpen.L23(0.05)]
IDS = [type(p).__name__ for p in J_PENALTIES]


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _gram_inputs(K, seed=0):
    rng = np.random.default_rng(seed)
    n = 3 * K
    X = rng.standard_normal((n, K))
    y = rng.standard_normal(n)
    G = X.T @ X / n
    beta0 = rng.standard_normal(K) * 0.1
    return G, X.T @ y / n, beta0, G @ beta0, np.diag(G).copy()


@pytest.mark.parametrize("jp", J_PENALTIES, ids=IDS)
@pytest.mark.parametrize("K", [8, 64, 200])
def test_k1_plain_matches_gram_ref(jp, K):
    G, c, beta0, q0, L = _gram_inputs(K)
    tp = from_reference(jp)
    for epochs in (1, 3):
        br, qr = jref.cd_epoch_gram_ref(*map(jnp.asarray, (G, c, beta0, q0, L)),
                                        jp, epochs=epochs)
        # column-major G, as the engine hands it to the kernel
        Gc = _t(G).t().contiguous().t()
        bk, qk = ops.cd_epoch_gram(Gc, _t(c), _t(beta0), _t(q0), _t(L),
                                   type(tp), penalty_params(tp), epochs=epochs)
        np.testing.assert_allclose(bk.numpy(), np.asarray(br), atol=1e-12,
                                   rtol=1e-5)
        np.testing.assert_allclose(qk.numpy(), np.asarray(qr), atol=1e-12,
                                   rtol=1e-5)


def _xb_inputs(K, n, kind, seed=1):
    rng = np.random.default_rng(seed)
    Xt = rng.standard_normal((K, n))
    y = np.sign(rng.standard_normal(n))
    beta0 = rng.standard_normal(K) * 0.05
    L = np.sum(Xt * Xt, axis=1)
    L = L / n if kind == "quadratic" else L / (4 * n) if kind == "logistic" \
        else L
    w = rng.random(n) * 2.0
    return Xt, y, beta0, beta0 @ Xt, L, w * (n / w.sum())


XB_KINDS = [(jdf.Quadratic(), "quadratic"), (jdf.Logistic(), "logistic"),
            (jdf.QuadraticSVC(), "svc")]


@pytest.mark.parametrize("jp", [jpen.L1(0.07), jpen.MCP(0.07, 3.0),
                                jpen.Box(0.9)], ids=["L1", "MCP", "Box"])
@pytest.mark.parametrize("jd,kind", XB_KINDS, ids=[k for _, k in XB_KINDS])
@pytest.mark.parametrize("K,n", [(16, 48), (96, 128)])
def test_k2_plain_matches_xb_ref(jp, jd, kind, K, n):
    Xt, y, beta0, Xb0, L, _ = _xb_inputs(K, n, kind)
    offset = np.asarray(jd.grad_offset(K, jnp.float64))
    br, xr = jref.cd_epoch_xb_ref(*map(jnp.asarray, (Xt, y, beta0, Xb0, L,
                                                     offset)),
                                  jd, jp, epochs=2)
    tp = from_reference(jp)
    bk, xk = ops.cd_epoch_xb(_t(Xt), _t(y), _t(beta0), _t(Xb0), _t(L),
                             _t(offset), type(tp), penalty_params(tp), kind,
                             epochs=2)
    np.testing.assert_allclose(bk.numpy(), np.asarray(br), atol=1e-11,
                               rtol=1e-8)
    np.testing.assert_allclose(xk.numpy(), np.asarray(xr), atol=1e-11,
                               rtol=1e-8)


@pytest.mark.parametrize("jd,kind", XB_KINDS[:2], ids=["quadratic",
                                                        "logistic"])
def test_k2_plain_matches_weighted_reference_epoch(jd, kind):
    """The weighted raw gradient: two reference epochs with w."""
    K, n = 24, 64
    Xt, y, beta0, Xb0, L, w = _xb_inputs(K, n, kind, seed=5)
    offset = np.zeros(K)
    jp = jpen.L1(0.05)
    b, x = map(jnp.asarray, (beta0, Xb0))
    for _ in range(2):
        b, x = j_cd_epoch_xb(jnp.asarray(Xt), jnp.asarray(y), b, x,
                             jnp.asarray(L), jnp.asarray(offset), jd, jp,
                             w=jnp.asarray(w))
    tp = from_reference(jp)
    bk, xk = ops.cd_epoch_xb(_t(Xt), _t(y), _t(beta0), _t(Xb0), _t(L),
                             _t(offset), type(tp), penalty_params(tp), kind,
                             w=_t(w), epochs=2)
    np.testing.assert_allclose(bk.numpy(), np.asarray(b), atol=1e-11,
                               rtol=1e-8)
    np.testing.assert_allclose(xk.numpy(), np.asarray(x), atol=1e-11,
                               rtol=1e-8)


def _dense_inputs(n, p, seed=0, sparsity=0.3):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((n, p))
    r = rng.standard_normal(n)
    beta = rng.standard_normal(p) * (rng.random(p) < sparsity)
    return X, r, beta, np.sum(X * X, axis=0) / n, np.zeros(p)


def _check_fused(X, r, beta, L, offset, jp, ws, bp, use_fp, exact=False):
    gsupp = np.asarray(jp.generalized_support(jnp.asarray(beta)))
    sc_ref, gr_ref, ws_ref, Xws_ref = _two_pass(
        *map(jnp.asarray, (X, r, beta, L, offset)), jp, jnp.asarray(gsupp),
        ws, use_fp)
    tp = from_reference(jp)
    Xt = _t(X.T).contiguous()
    gs = torch.as_tensor(gsupp)
    sc, gr, _, ws_idx, Xt_ws = ops.fused_ws(
        Xt, _t(r), _t(beta), _t(L), _t(offset), gs, type(tp),
        penalty_params(tp), ws, use_fp=use_fp, bp=bp)
    if exact:
        np.testing.assert_array_equal(sc.numpy(), np.asarray(sc_ref))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_ref), atol=1e-12,
                               rtol=1e-11)
    np.testing.assert_allclose(gr.numpy(), np.asarray(gr_ref), atol=1e-12,
                               rtol=1e-10)
    np.testing.assert_array_equal(ws_idx.numpy(), np.asarray(ws_ref))
    np.testing.assert_array_equal(Xt_ws.T.numpy(), np.asarray(Xws_ref))


@pytest.mark.parametrize("jp", J_PENALTIES, ids=IDS)
@pytest.mark.parametrize("n,p,ws,bp", [
    (64, 256, 32, None),      # multiple even tiles
    (48, 100, 16, 32),        # bp does not divide p: padded tail tile
    (32, 40, 8, 8),           # tiny tiles, ws == kc
    (128, 1024, 64, None),    # one tile
])
def test_k3_plain_matches_two_pass(jp, n, p, ws, bp):
    X, r, beta, L, offset = _dense_inputs(n, p, seed=p + ws)
    _check_fused(X, r, beta, L, offset, jp, ws, bp,
                 use_fp=not jp.HAS_SUBDIFF)


def test_k3_plain_exact_ties():
    """Integer design with duplicated columns: scores tie exactly; the
    candidate buffer still covers lax.top_k's lowest-index choice and the
    columns are bit-identical."""
    rng = np.random.default_rng(7)
    n, p, ws = 32, 96, 16
    base = rng.integers(-3, 4, size=(n, p // 2)).astype(np.float64)
    X = np.concatenate([base, base], axis=1)
    r = rng.integers(-2, 3, size=n).astype(np.float64)
    L = np.maximum(np.sum(X * X, axis=0) / n, 1e-12)
    for beta, bp in ((np.zeros(p), None), (np.where(rng.random(p) < 0.1,
                                                    1.0, 0.0), 24)):
        _check_fused(X, r, beta, L, np.zeros(p), jpen.L1(0.5), ws, bp,
                     use_fp=False, exact=True)


@pytest.mark.parametrize("n,p,ws,bp", [
    (64, 256, 32, None),      # one tile
    (48, 100, 16, 32),        # bp does not divide p: ragged last tile
    (40, 90, 90, 32),         # ws >= bp: every row a candidate
    (30, 70, 24, 32),         # ragged last tile of 6 rows: exhausted slots
    (33, 1500, 600, None),    # several tiles (pick_bp), kc = ws
])
def test_k3_head_rows_equal_candidate_columns(n, p, ws, bp):
    """The K3 head hands back the working set and its K rows of X (no
    candidate buffer on the card): the working set is
    ``select_working_set`` of the plain scores, its rows equal, bit for
    bit, ``candidate_columns`` of the plain version's four outputs, which
    stay the oracle, and ``cand_idx`` is each tile's top-kc in
    ``lax.top_k`` order (the reference's own primitive, on the same
    priorities), exhausted slots indexing p."""
    import jax
    X, r, beta, L, offset = _dense_inputs(n, p, seed=3 * p + ws)
    jp = jpen.MCP(0.11, 3.0)
    gsupp = np.asarray(jp.generalized_support(jnp.asarray(beta)))
    tp = from_reference(jp)
    args = (_t(X.T).contiguous(), _t(r), _t(beta), _t(L), _t(offset),
            torch.as_tensor(gsupp.copy()), type(tp), penalty_params(tp), ws)
    sc, gr, ci, ws_idx, Xt_ws = ops.fused_ws(*args, bp=bp)
    sr, grr, cir, ccr = fused_ws_plain(*args, bp=bp)
    assert torch.equal(sc, sr) and torch.equal(gr, grr)
    assert torch.equal(ws_idx, select_working_set(sr, args[5], ws))
    assert torch.equal(Xt_ws, candidate_columns(cir, ccr, ws_idx, p).T)
    assert torch.equal(Xt_ws, args[0][ws_idx])
    assert Xt_ws.shape == (ws, n) and Xt_ws.is_contiguous()
    bp_ = pick_bp(p) if bp is None else min(bp, p)
    tiles = -(-p // bp_)
    kc = min(bp_, ws)
    pri = np.full(tiles * bp_, -np.inf)
    pri[:p] = np.where(gsupp, np.inf, sr.numpy()) + 0.0
    top = np.asarray(jax.lax.top_k(jnp.asarray(pri.reshape(tiles, bp_)),
                                   kc)[1]) + bp_ * np.arange(tiles)[:, None]
    want = np.where(top < p, top, p).reshape(-1)
    np.testing.assert_array_equal(ci.numpy(), want)
    np.testing.assert_array_equal(cir.numpy(), want)
    if p % bp_ and kc > p % bp_:
        assert int(torch.sum(ci == p)) == kc - p % bp_


def test_wrappers_reject_bad_input():
    K = 8
    G = torch.zeros(K, K, dtype=torch.float64)
    v = torch.zeros(K, dtype=torch.float64)
    prm = torch.tensor([0.1], dtype=torch.float64)
    from repro_torch.core.penalties import L1
    with pytest.raises(TypeError):
        ops.cd_epoch_gram(G.float(), v, v, v, v, L1, prm)
    with pytest.raises(ValueError):
        ops.cd_epoch_gram(G, v[:4], v, v, v, L1, prm)
    with pytest.raises(ValueError):
        ops.cd_epoch_xb(G.t(), v, v, v, v, v, L1, prm, "svc",
                        w=v)
    with pytest.raises(ValueError):
        ops.fused_ws(G, v, v, v, v, v > 0, L1, prm, 0)


def test_cpu_route_launches_nothing():
    """On CPU tensors the wrappers run the plain versions and count no
    launch."""
    ops.reset_launch_counts()
    G, c, beta0, q0, L = map(_t, _gram_inputs(8))
    from repro_torch.core.penalties import L1
    ops.cd_epoch_gram(G, c, beta0, q0, L, L1, penalty_params(L1(0.1)))
    from repro_torch.core.penalties import BlockL1
    B = torch.stack([beta0, beta0], 1)
    ops.cd_epoch_gram_block(G, B, B, B, L, BlockL1,
                            penalty_params(BlockL1(0.1)))
    ops.cd_epoch_gram_lanes(G[None], c[None], beta0[None], q0[None],
                            L[None], L1, penalty_params(L1(0.1))[None],
                            torch.ones(1, dtype=torch.bool))
    ops.cd_epoch_gram_block_lanes(G[None], B[None], B[None], B[None],
                                  L[None], BlockL1,
                                  penalty_params(BlockL1(0.1))[None],
                                  torch.ones(1, dtype=torch.bool))
    assert ops.launch_counts() == {"cd_epoch_gram": 0, "cd_epoch_xb": 0,
                                   "fused_ws": 0, "ws_score": 0,
                                   "csc_score": 0, "csc_weighted_col_sq": 0,
                                   "cd_epoch_gram_block": 0,
                                   "fused_ws_block": 0,
                                   "csc_score_block": 0,
                                   "cd_epoch_gram_lanes": 0,
                                   "cd_epoch_xb_lanes": 0,
                                   "fused_ws_lanes": 0,
                                   "cd_epoch_gram_block_lanes": 0,
                                   "fused_ws_block_lanes": 0}
