"""K3g, K3l's gather of its lanes' working-set rows, on the CPU: the slot
map and the gather's plain version (``kernels/fused_ws.py: slot_map``,
``ws_gather_plain``, the kernel's copy through the map) against
``index_select`` of the S K rows, bit for bit (duplicate rows across
lanes, a lane that selects all of p, one lane); the byte count of its new
bound; the launch statistics by working-set bucket; and K3l's CPU route,
whose rows the gather now gives, against the reference's jax head under
``vmap`` (``repro.core.working_set``: the scores and ``lax.top_k``
selection): scores within 1e-12 + 1e-11 relative, gradient within 1e-12 +
1e-10 relative (``tests/test_kernels.py``'s bounds), an identical working
set and its rows bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.penalties as JP
from repro.core.working_set import select_working_set as jselect
from repro.core.working_set import violation_scores as jscores
from repro_torch.core import penalties as P
from repro_torch.kernels import ops
from repro_torch.kernels.common import penalty_params
from repro_torch.kernels.fused_ws import (gather_bytes, slot_map,
                                          ws_gather_plain)


def _ws(case, p, S, K, rng):
    if case == "random":
        return np.stack([rng.choice(p, K, replace=False) for _ in range(S)])
    if case == "shared":
        # every lane a subset of one pool of K + K / 4 features (at most p)
        pool = rng.choice(p, min(p, K + K // 4), replace=False)
        return np.stack([rng.permutation(pool)[:K] for _ in range(S)])
    if case == "identical":
        one = rng.choice(p, K, replace=False)
        return np.stack([one] * S)
    if case == "all_of_p":
        # lane 0 selects every feature (K = p), the others the same p in
        # other orders
        return np.stack([rng.permutation(p) for _ in range(S)])
    raise ValueError(case)


CASES = [("random", 40, 3, 16), ("shared", 40, 4, 16),
         ("identical", 30, 5, 8), ("all_of_p", 25, 3, 25),
         ("random", 40, 1, 16), ("shared", 64, 1, 64)]


@pytest.mark.parametrize("case,p,S,K", CASES,
                         ids=[f"{c}-p{p}-S{S}-K{K}" for c, p, S, K in CASES])
def test_gather_plain_equals_index_select(case, p, S, K):
    """The kernel's copy through the slot map equals ``index_select`` of
    the S K rows bit for bit and reads each distinct row once (U); the
    slot map holds every (lane, slot) once and -1 elsewhere."""
    rng = np.random.default_rng(p * S + K)
    Xt = torch.as_tensor(rng.standard_normal((p, 7)))
    ws = torch.as_tensor(_ws(case, p, S, K, rng))
    pos = slot_map(ws, p)
    assert pos.shape == (p, S) and pos.dtype == torch.int32
    for s in range(S):
        for k in range(K):
            assert int(pos[ws[s, k], s]) == k
    assert int(torch.sum(pos >= 0)) == S * K
    out, U = ws_gather_plain(Xt, ws)
    assert torch.equal(out, Xt.index_select(0, ws.reshape(-1)).view(S, K, 7))
    assert U == len(np.unique(ws.numpy()))
    assert torch.equal(ops.ws_gather(Xt, ws), out)
    if case == "all_of_p":
        assert U == p
    if case == "identical":
        assert U == K


@pytest.mark.parametrize("S,K,n,U", [(10, 1024, 10_000, 10_240),
                                     (10, 1024, 10_000, 1_100),
                                     (10, 16_384, 10_000, 18_000),
                                     (1, 64, 305, 64)])
def test_gather_bound_counts_distinct_rows(S, K, n, U):
    """The new bound's bytes: U rows read and S K written (8 bytes a
    value); with no row shared (U = S K) it is ``index_select``'s 2 S K n
    values, and a shared gather saves (S K - U) n values."""
    got = gather_bytes(S, K, n, U)
    assert got == (U + S * K) * n * 8
    assert gather_bytes(S, K, n, S * K) == 2 * S * K * n * 8
    assert gather_bytes(S, K, n, S * K) - got == (S * K - U) * n * 8


def test_lane_heads_count_by_bucket_and_lanes():
    """K3l and K3bl count their launches by (ws rounded up to a power of
    two, lanes), and K3g its rows by bucket, directly and per replay of a
    captured graph; the reset clears them; the CPU route counts none."""
    ops.reset_launch_counts()
    ops._count(ops.fused_ws_lanes, K=1000, lanes=10)
    ops._count(ops.ws_gather, K=1000, rows=10 * 1000)
    with ops.deferred_launches() as records:
        ops._count(ops.fused_ws_lanes, K=1000, lanes=10)
        ops._count(ops.ws_gather, K=1000, rows=10 * 1000)
        ops._count(ops.fused_ws_block_lanes, K=64, lanes=5)
    ops.add_launches(records, 2)
    assert ops.shape_counts()["fused_ws_lanes"] == {"K=1024 S=10": 3}
    assert ops.shape_counts()["fused_ws_block_lanes"] == {"K=64 S=5": 2}
    assert ops.gather_counts() == {"K=1024": dict(launches=3, rows=30_000,
                                                  distinct=0)}
    ops.reset_launch_counts()
    assert ops.gather_counts() == {}
    Xt = torch.randn(20, 5, dtype=torch.float64)
    ops.ws_gather(Xt, torch.tensor([[1, 2], [2, 3]]))
    assert ops.launch_counts()["ws_gather"] == 0


def _jax_pen(pen):
    return {P.L1: JP.L1, P.MCP: JP.MCP}[type(pen)](
        *[float(v) for v in penalty_params(pen)])


@pytest.mark.parametrize("pen", [P.L1(0.1), P.MCP(0.1, 3.0)],
                         ids=["L1", "MCP"])
@pytest.mark.parametrize("ws_size,shared", [(16, False), (64, True)])
def test_fused_ws_lanes_cpu_equals_the_jax_vmapped_head(pen, ws_size,
                                                        shared):
    """K3l's CPU route (its rows from the gather's route) against the
    reference's head under ``jax.vmap``: grad = Xt R[:, s] + offset, its
    violation scores and ``select_working_set`` (``lax.top_k``) per
    lane."""
    S, n, p = 4, 30, 150
    rng = np.random.default_rng(ws_size)
    Xt = rng.standard_normal((p, n))
    R = rng.standard_normal((n, S))
    if shared:
        R = R[:, :1] + 1e-3 * R
    beta = rng.standard_normal((S, p)) * (rng.random((S, p)) < 0.1)
    L = np.sum(Xt * Xt, axis=1) / n
    off = 0.01 * rng.standard_normal(p)
    gs = beta != 0
    prm = penalty_params(pen).repeat(S, 1)
    out = ops.fused_ws_lanes(*(torch.as_tensor(a) for a in (
        Xt, np.ascontiguousarray(R), beta)), torch.as_tensor(L).expand(S, p),
        torch.as_tensor(off), torch.as_tensor(gs), type(pen), prm, ws_size)
    scores, grad, _, ws, Xt_ws = out
    jpen = _jax_pen(pen)

    def head(r, b, g):
        gr = jnp.asarray(Xt) @ r + jnp.asarray(off)
        sc = jscores(jpen, b, gr, jnp.asarray(L))
        return sc, gr, jselect(sc, g, ws_size)

    js, jg, jw = (np.asarray(a) for a in jax.vmap(head)(
        jnp.asarray(R.T), jnp.asarray(beta), jnp.asarray(gs)))
    np.testing.assert_allclose(scores.numpy(), js, atol=1e-12, rtol=1e-11)
    np.testing.assert_allclose(grad.numpy(), jg, atol=1e-12, rtol=1e-10)
    np.testing.assert_array_equal(ws.numpy(), jw)
    assert torch.equal(Xt_ws, torch.as_tensor(Xt)[ws.reshape(-1)]
                       .view(S, ws_size, n))
