"""K1's blocked chain (``csrc/cd_epoch.cu: cd_gram_kernel``) on the CPU.

The CUDA kernel runs only on a card, so these tests hold what surrounds
it here:

* ``gram_plan`` puts each K on the branch it should (one CTA or a cluster,
  q in shared memory beside the head on both), within the card's 232,448
  bytes of shared memory a CTA, with thread counts the kernel can launch,
  refuses a K whose state does not fit, and its constants mirror the
  kernel's;
* a torch emulation of the kernel's schedule (the chain over a block of B
  coordinates, the chain's own application of the previous block's deltas,
  the update warps' deferred per-row updates in coordinate order with
  Delta = 0 skipped, the last drain) equals ``cd_epoch_gram_plain`` in
  float64 for all seven penalties. The plain version adds G * 0 where a
  coordinate did not move, so the two may differ in the sign of a zero:
  ``torch.equal`` counts -0.0 and +0.0 as equal. The schedule is the one of
  both K1 kernels: the cluster kernel only moves the rows' updates to other
  CTAs.
"""
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import penalties as P
from repro_torch.kernels import ops  # noqa: F401  (before the submodule)
from repro_torch.kernels import cd_epoch as cd
from repro_torch.kernels.common import make_penalty, penalty_params

F64, F32 = torch.float64, torch.float32
CARD_SMEM = 232_448
PENALTIES = [P.L1(0.11), P.L1L2(0.11, 0.6), P.MCP(0.11, 3.0),
             P.SCAD(0.11, 3.7), P.Box(0.8), P.L05(0.05), P.L23(0.05)]
IDS = [type(p).__name__ for p in PENALTIES]


# ------------------------------------------------------------------ plan
@pytest.mark.parametrize("K,branch", [(1, "single"), (31, "single"),
                                      (32, "single"), (33, "single"),
                                      (256, "single"),
                                      (257, "cluster-shared"),
                                      (1024, "cluster-shared"),
                                      (2048, "cluster-shared"),
                                      (16_384, "cluster-shared")])
def test_gram_plan_branch(K, branch):
    """One CTA up to GRAM_SINGLE_MAX_K coordinates, a cluster of
    GRAM_CLUSTER CTAs above (the dense and sparse SVC fits' working sets of
    1024 to 2048); q's rows fit the update CTAs' shared memory at every K
    of the main path."""
    plan = cd.gram_plan(K, F64)
    assert plan.branch == branch
    assert cd.GRAM_B == 32
    assert plan.cluster == (1 if branch == "single" else cd.GRAM_CLUSTER)
    assert cd.GRAM_SINGLE_MAX_K == 256


def _rows(K, C):
    """The q rows a CTA holds: all K (and beta) on one CTA, else the
    update CTAs' ceil(nb / (C - 1)) blocks."""
    if C == 1:
        return 2 * K
    return -(-(-(-K // 32)) // (C - 1)) * 32


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("K", [1, 31, 32, 33, 64, 65, 256, 257, 1024, 2048,
                               12_300, 16_384, 100_000, 300_000])
def test_gram_plan_fits_the_card(K, dtype):
    plan = cd.gram_plan(K, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    head = cd.GRAM_HEAD * item
    state = _rows(K, plan.cluster) * item
    assert plan.dyn_bytes == head + state
    assert plan.dyn_bytes <= cd.SMEM_DYN_MAX < CARD_SMEM
    # the chain warp and at least one more, whole warps, within the
    # registers of a row's 32 loads a thread
    assert 64 <= plan.threads <= cd.GRAM_MAX_THREADS <= 512
    assert plan.threads % 32 == 0
    # a cluster needs three blocks (the kernel refuses fewer)
    assert plan.cluster == 1 or K > 64
    # one thread a row where the cap allows, and enough warps to stage
    # each block's tiles
    rows = K + 32 if plan.cluster == 1 else _rows(K, plan.cluster)
    assert plan.threads == min(cd.GRAM_MAX_THREADS,
                               max(cd.GRAM_MIN_THREADS, -(-rows // 32) * 32))


@pytest.mark.parametrize("fits,too_big,dtype,cluster", [
    (12_000, 16_384, F64, 1), (24_000, 32_768, F32, 1),
    (300_000, 400_000, F64, None), (600_000, 800_000, F32, None)])
def test_gram_plan_refuses_what_does_not_fit(fits, too_big, dtype, cluster):
    """K1 keeps its state in shared memory on every layout: one CTA holds q
    and beta (2 K values) up to ~12k float64 coordinates (twice as many in
    float32), the cluster's update CTAs hold q's rows up to ~360k at
    C = 16. Past that the plan raises; it never reaches for global
    memory."""
    assert cd.gram_plan(fits, dtype, cluster=cluster).dyn_bytes \
        <= cd.SMEM_DYN_MAX
    with pytest.raises(ValueError, match="shared memory"):
        cd.gram_plan(too_big, dtype, cluster=cluster)


def test_gram_plan_forced():
    """`cluster` and `threads` force a size and keep the byte rule."""
    plan = cd.gram_plan(2049, F64, cluster=1, threads=256)
    assert (plan.threads, plan.branch) == (256, "single")
    assert plan.dyn_bytes == (cd.GRAM_HEAD + 2 * 2049) * 8
    plan = cd.gram_plan(2049, F64, cluster=16)
    assert (plan.cluster, plan.branch) == (16, "cluster-shared")
    assert plan.dyn_bytes == (cd.GRAM_HEAD + 5 * 32) * 8
    assert cd.gram_plan(2049, F64, cluster=2).threads == 512
    assert cd.gram_plan(64, F64, threads=512).threads == 512


def test_gram_plan_mirrors_the_kernel_constants():
    """The plan's block, head and thread cap are the kernel's kGramB,
    kGramHead and kGramMaxThreads."""
    src = (Path(cd.__file__).resolve().parent.parent / "csrc"
           / "cd_epoch.cu").read_text()

    def const(name):
        return re.search(rf"constexpr int {name} = ([^;]+);", src).group(1)

    B = int(const("kGramB"))
    assert B == cd.GRAM_B
    assert int(const("kGramMaxThreads")) == cd.GRAM_MAX_THREADS
    tile = B * B
    assert const("kGramTile") == "kGramB * kGramB"
    head = eval(const("kGramHead"), {"kGramTile": tile, "kGramB": B})
    assert head == cd.GRAM_HEAD


def test_branch_counts_cover_k1():
    ops.reset_launch_counts()
    assert ops.branch_counts()["cd_epoch_gram"] == \
        dict.fromkeys(cd.BRANCHES, 0)
    G, c, beta0, q0, L = _gram_case(40, 0)
    ops.cd_epoch_gram(G, c, beta0, q0, L, P.L1, penalty_params(P.L1(0.1)))
    # the CPU route runs the plain version and counts nothing
    assert ops.branch_counts()["cd_epoch_gram"] == \
        dict.fromkeys(cd.BRANCHES, 0)
    assert ops.launch_counts()["cd_epoch_gram"] == 0


# ------------------------------------------------------------- emulation
def blocked_epochs(G, c, beta0, q0, L, penalty, epochs, B=32):
    """The kernel's schedule in torch. Chain step s runs block s % nb (its
    rows take every delta, 0 included, as the plain version's do); the
    update warps' step s applies the moved deltas D_{s-1} of chain s - 1 to
    every row outside block s - 1 (its own chain applied them) and block s
    (chain s applies them before its own coordinates), block s + 1's rows
    first; step S drains D_{S-1}. Chain s and update step s touch disjoint
    rows, so running them one after the other is one of the kernel's
    interleavings."""
    K = G.shape[0]
    nb = -(-K // B)
    S = epochs * nb
    beta, q = beta0.clone(), q0.clone()
    step = 1.0 / torch.clamp(L, min=1e-30)

    def rows(k):
        return torch.arange(k * B, min(K, (k + 1) * B))

    def apply(idx, moves):
        for j, d in moves:               # coordinate order, moved only
            q[idx] = q[idx] + G[idx, j] * d

    moves, deltas = {}, {}
    for s in range(S + 1):
        kp = (s - 1) % nb if s > 0 else None
        kc = s % nb if s < S else None
        kn = (s + 1) % nb if s + 1 < S else None
        if kc is not None:
            own = rows(kc)
            if s > 0 and nb > 1:
                # the chain's handoff adds every delta of the previous block
                for j, d in deltas[s - 1]:
                    q[own] = q[own] + G[own, j] * d
            moved, every = [], []
            for j in own.tolist():
                bj = beta[j].clone()
                new = penalty.prox(bj - (q[j] - c[j]) * step[j], step[j])
                new = torch.where(L[j] > 0.0, new, bj)
                d = new - bj
                beta[j] = new
                q[own] = q[own] + G[own, j] * d     # every delta, 0 too
                every.append((j, d))
                if d != 0:
                    moved.append((j, d))
            moves[s], deltas[s] = moved, every
        if s > 0:
            if kn is not None and kn not in (kp, kc):
                apply(rows(kn), moves[s - 1])
            rest = [k for k in range(nb) if k not in (kp, kc, kn)]
            if rest:
                apply(torch.cat([rows(k) for k in rest]), moves[s - 1])
            del moves[s - 1], deltas[s - 1]
    return beta, q


def _gram_case(K, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((3 * K, K))
    G = X.T @ X / (3 * K)
    beta0 = rng.standard_normal(K) * 0.1 * (rng.random(K) < 0.5)
    c = X.T @ rng.standard_normal(3 * K) / (3 * K)
    t = [torch.tensor(a) for a in (G, c, beta0, G @ beta0, np.diag(G))]
    return t[0].t().contiguous().t(), *t[1:]


def _svc_case(K, seed):
    """The LinearSVC dual's Gram subproblem: G = Z Z^T with Z = y * X (one
    row a sample), c = 1, L = diag(G), a Box(C) penalty, from beta = 0:
    most coordinates move every epoch."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((K, 12))
    y = np.sign(rng.standard_normal(K))
    Z = y[:, None] * X
    G = Z @ Z.T
    t = [torch.tensor(a) for a in (G, np.ones(K), np.zeros(K),
                                   np.zeros(K), np.diag(G))]
    return t[0].t().contiguous().t(), *t[1:]


def _equal(got, ref):
    return all(torch.equal(a, b) for a, b in zip(got, ref))


@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("K", [1, 31, 33, 100, 257])
@pytest.mark.parametrize("pen", PENALTIES, ids=IDS)
def test_blocked_order_equals_plain(pen, K, epochs):
    G, c, beta0, q0, L = _gram_case(K, K)
    args = (G, c, beta0, q0, L, type(pen), penalty_params(pen))
    ref = cd.cd_epoch_gram_plain(*args, epochs=epochs)
    got = blocked_epochs(G, c, beta0, q0, L,
                         make_penalty(type(pen), penalty_params(pen)), epochs)
    assert _equal(got, ref)


@pytest.mark.parametrize("epochs", [1, 3])
@pytest.mark.parametrize("K", [33, 100, 257])
def test_blocked_order_equals_plain_svc(K, epochs):
    G, c, beta0, q0, L = _svc_case(K, K)
    pen = P.Box(0.8)
    ref = cd.cd_epoch_gram_plain(G, c, beta0, q0, L, P.Box,
                                 penalty_params(pen), epochs=epochs)
    got = blocked_epochs(G, c, beta0, q0, L, pen, epochs)
    assert torch.sum(ref[0] != beta0) > K // 2
    assert _equal(got, ref)


@pytest.mark.parametrize("K", [40, 100])
def test_blocked_order_frozen_block_and_no_move(K):
    """A block where no coordinate moves (L = 0 on rows 32..63), and a
    penalty level at which nothing moves at all."""
    G, c, beta0, q0, L = _gram_case(K, 5)
    L = L.clone()
    L[32:64] = 0.0
    for pen in (P.L1(0.11), P.L1(1e6)):
        args = (G, c, beta0, q0, L, P.L1, penalty_params(pen))
        ref = cd.cd_epoch_gram_plain(*args, epochs=3)
        got = blocked_epochs(G, c, beta0, q0, L, pen, 3)
        assert torch.equal(ref[0][32:64], beta0[32:64])
        assert _equal(got, ref)
