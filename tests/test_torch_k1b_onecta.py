"""K1b's and K1bl's one-CTA block epoch (``csrc/cd_epoch.cu:
cd_gram_block_kernel``) on the CPU.

The CUDA kernel runs only on a card (``tests/test_torch_gpu.py -k onecta``
and ``chip_smoke.py`` hold it there bit for bit to the emulation below), so
these tests hold what surrounds it here:

* ``emulate_block_epoch``, the kernel's arithmetic in torch (the row norm
  by lane partials and a shuffle tree, q's updates one j at a time with an
  all-zero delta skipped), equals ``cd_epoch_gram_plain`` and the JAX
  reference's block epoch (``repro.core.cd.cd_epoch_gram`` with beta
  [K, T]) within 1e-12 + 1e-10 |ref| for BlockL1 and BlockMCP, with rows
  that do not move and a row with L = 0, lane by lane with frozen lanes;
* the kernel's shortened shuffle tree (``tree_top``: the levels whose
  lanes hold +0 skipped) gives the whole tree's bits;
* ``gram_block_plan``'s one-CTA layout fits the card's 232,448 bytes a
  CTA at every K * T it plans one CTA for, in float64 and float32, with
  launchable threads, owners that hold q in registers and cover each
  entry once, G staged whole exactly where it fits, and constants that
  mirror the kernel's.
"""
import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core.penalties as jpen
from repro.core.cd import cd_epoch_gram as j_cd_epoch_gram
from repro_torch.convert import from_reference
from repro_torch.kernels import ops  # noqa: F401  (before the submodule)
from repro_torch.kernels import cd_epoch as cd
from repro_torch.kernels.common import penalty_params

F64, F32 = torch.float64, torch.float32
CARD_SMEM = 232_448
CSRC = Path(cd.__file__).resolve().parents[1] / "csrc" / "cd_epoch.cu"
J_BLOCK = [jpen.BlockL1(0.3), jpen.BlockMCP(0.3, 3.0)]
IDS = [type(p).__name__ for p in J_BLOCK]
TASKS = [1, 5, 20, 33, 50]


def _case(K, T, seed, S=None):
    """Seeded numpy inputs: G the Gram of a 3K x K design, c, beta0 with
    half its rows zero, L = diag(G) with L[1] = 0 (the row stays put), and
    rows j = 3 mod 5 orthogonal to the others with c_j = beta0_j = 0 (their
    gradient stays 0: they never move); with S, S lanes of them, lane s's G
    scaled by 1 + 0.01 s."""
    rng = np.random.default_rng(seed)
    lanes = 1 if S is None else S
    X = rng.standard_normal((3 * K, K))
    G = X.T @ X / (3 * K)
    idle = np.arange(K) % 5 == 3
    G[np.ix_(idle, ~idle)] = 0.0
    G[np.ix_(~idle, idle)] = 0.0
    G = G[None] * (1.0 + 0.01 * np.arange(lanes))[:, None, None]
    c = np.einsum("ki,snt->skt", X.T, rng.standard_normal((lanes, 3 * K, T)))
    c = c / (3 * K)
    beta0 = rng.standard_normal((lanes, K, T)) * 0.1 * \
        (rng.random((lanes, K, 1)) < 0.5)
    c[:, idle] = 0.0
    beta0[:, idle] = 0.0
    L = np.diagonal(G, axis1=1, axis2=2).copy()
    L[:, 1 % K] = 0.0
    q0 = G @ beta0
    if S is None:
        return G[0], c[0], beta0[0], q0[0], L[0]
    return G, c, beta0, q0, L


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _close(got, want, atol=1e-12, rtol=1e-10):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=atol,
                               rtol=rtol)


# ------------------------------------------------------------- emulation
@pytest.mark.parametrize("jp", J_BLOCK, ids=IDS)
@pytest.mark.parametrize("T", TASKS)
def test_emulation_matches_plain(jp, T):
    """The emulation against the plain epoch: only the norm's summation
    order differs. Rows with beta0 = 0 at a lambda that keeps some of them
    at 0, and row 1 with L = 0, which must not move."""
    K = 24
    G, c, beta0, q0, L = (_t(a) for a in _case(K, T, seed=T))
    tp = from_reference(jp)
    prm = penalty_params(tp)
    for epochs in (1, 3):
        be, qe = cd.emulate_block_epoch(G, c, beta0, q0, L, type(tp), prm,
                                        epochs=epochs)
        bp, qp = cd.cd_epoch_gram_plain(G, c, beta0, q0, L, type(tp), prm,
                                        epochs=epochs)
        _close(be, bp)
        _close(qe, qp)
        assert torch.equal(be[1], beta0[1])
    still = torch.all(be == beta0, dim=1)
    assert bool(torch.all(still[3::5])) and not bool(torch.all(still))


@pytest.mark.parametrize("jp", J_BLOCK, ids=IDS)
@pytest.mark.parametrize("T", TASKS)
def test_emulation_matches_reference_epoch(jp, T):
    """The emulation against the JAX reference's block epoch on the same
    numpy inputs (the reference runs its jax epoch under jax on the CPU)."""
    K = 16
    G, c, beta0, q0, L = _case(K, T, seed=100 + T)
    tp = from_reference(jp)
    for epochs in (1, 3):
        b, q = jnp.asarray(beta0), jnp.asarray(q0)
        for _ in range(epochs):
            b, q = j_cd_epoch_gram(jnp.asarray(G), jnp.asarray(c), b, q,
                                   jnp.asarray(L), jp)
        be, qe = cd.emulate_block_epoch(_t(G), _t(c), _t(beta0), _t(q0),
                                        _t(L), type(tp), penalty_params(tp),
                                        epochs=epochs)
        _close(be, b)
        _close(qe, q)


@pytest.mark.parametrize("jp", J_BLOCK, ids=IDS)
@pytest.mark.parametrize("T", [5, 50])
def test_emulation_over_lanes(jp, T):
    """Lanes side by side (their own G, c, beta, q, L and parameter row)
    equal the single-lane emulation lane by lane bit for bit and the lanes'
    plain version within the tolerance; a frozen lane comes back
    unchanged."""
    S, K = 5, 12
    G, c, beta0, q0, L = (_t(a) for a in _case(K, T, seed=7 * T, S=S))
    tp = from_reference(jp)
    prm = penalty_params(tp).repeat(S, 1)
    prm[:, 0] *= torch.linspace(0.5, 1.5, S, dtype=F64)
    active = torch.arange(S) % 3 != 1
    be, qe = cd.emulate_block_epoch(G, c, beta0, q0, L, type(tp), prm,
                                    epochs=2, active=active)
    bp, qp = cd.cd_epoch_gram_block_lanes_plain(G, c, beta0, q0, L, type(tp),
                                                prm, active, epochs=2)
    _close(be, bp)
    _close(qe, qp)
    for s in range(S):
        if not bool(active[s]):
            assert torch.equal(be[s], beta0[s]) and torch.equal(qe[s], q0[s])
            continue
        b1, q1 = cd.emulate_block_epoch(G[s], c[s], beta0[s], q0[s], L[s],
                                        type(tp), prm[s], epochs=2)
        assert torch.equal(be[s], b1) and torch.equal(qe[s], q1)


def test_emulation_float32():
    """The emulation runs in the tensors' type with the parameters cast to
    it, as the kernel reads them: float32 stays within float32's rounding
    of the float64 plain epoch."""
    G, c, beta0, q0, L = (_t(a) for a in _case(16, 20, seed=3))
    tp = from_reference(J_BLOCK[1])
    prm = penalty_params(tp)
    be, qe = cd.emulate_block_epoch(*(a.float() for a in (G, c, beta0, q0,
                                                          L)),
                                    type(tp), prm, epochs=2)
    assert be.dtype == F32 and qe.dtype == F32
    bp, qp = cd.cd_epoch_gram_plain(G, c, beta0, q0, L, type(tp), prm,
                                    epochs=2)
    _close(be.double(), bp, atol=1e-5, rtol=1e-4)
    _close(qe.double(), qp, atol=1e-5, rtol=1e-4)


def _tree(part, top):
    """The kernel's shuffle-down tree from offset `top` on [32] partials:
    lane l + o into lane l; lane 0's sum."""
    v = part.clone()
    o = top
    while o > 0:
        v = torch.cat([v[:o] + v[o:2 * o], v[o:]])
        o >>= 1
    return v[0]


def _tree_top(nt):
    top = 16
    while top > 0 and top >= nt:
        top >>= 1
    return top


@pytest.mark.parametrize("T", list(range(1, 65)))
def test_short_tree_gives_the_whole_trees_bits(T):
    """Lanes at or past T hold +0, so the tree levels at offsets >= T add
    +0 to sums of squares (or to inf and NaN): starting the tree at
    ``tree_top`` gives the bits of the whole tree, which
    ``emulate_block_epoch`` (and the parent kernel) run."""
    rng = np.random.default_rng(T)
    x = _t(rng.standard_normal(T) * 10.0 ** rng.integers(-8, 8, T))
    m = -(-T // 32)
    xx = torch.zeros(m * 32, dtype=F64)
    xx[:T] = x * x
    part = torch.zeros(32, dtype=F64)
    for k in range(m):
        part = part + xx[32 * k:32 * (k + 1)]
    whole = _tree(part, 16)
    assert torch.equal(_tree(part, _tree_top(T)), whole)
    assert torch.equal(torch.sqrt(whole), cd._lane_norms(x[None])[0, 0])


# ------------------------------------------------------------------ plan
def _one_cta_bytes(K, T, plan, item):
    KT = K * T
    return ((2 + cd.GRAM_BLOCK_SLOTS) * T + 2 * K
            + (K * K if plan.g_whole else cd.GRAM_BLOCK_RING * K)
            + (2 * KT if plan.smem else 0) + (0 if plan.per else KT)) * item


def _one_cta_shapes():
    """Every (K, T) the plan may keep on one CTA: T up to the chain's 64
    tasks, K * T up to the threshold, on a grid with the main path's."""
    Ts = (1, 2, 5, 20, 31, 32, 33, 50, 63, 64)
    out = set()
    for T in Ts:
        kmax = cd.GRAM_BLOCK_SINGLE_MAX_KT // T
        for K in sorted({1, 2, 3, 4, 7, 31, 64, 65, 127, 128, 255, 256, 511,
                         512, kmax - 1, kmax, kmax + 1}):
            if K >= 1:
                out.add((K, T))
    return sorted(out)


@pytest.mark.parametrize("dtype", [F64, F32])
def test_one_cta_plan_fits_the_card(dtype):
    """At every shape it keeps on one CTA, the plan's shared memory is the
    kernel's layout and fits the card; the owners hold q in registers
    (GRAM_BLOCK_PER entries at most each, every entry once) on launchable
    threads; G is staged whole exactly where it fits beside the rest."""
    item = torch.empty((), dtype=dtype).element_size()
    n_single = 0
    for K, T in _one_cta_shapes():
        plan = cd.gram_block_plan(K, T, dtype)
        if plan.cluster != 1:
            assert K * T > cd.GRAM_BLOCK_SINGLE_MAX_KT or \
                cd._block_one_cta(K, T, dtype, None).dyn_bytes > \
                cd.SMEM_DYN_MAX or not cd._block_one_cta(K, T, dtype,
                                                         None).smem
            continue
        n_single += 1
        assert plan.branch == "single"
        assert plan.dyn_bytes == _one_cta_bytes(K, T, plan, item)
        assert plan.dyn_bytes <= cd.SMEM_DYN_MAX < CARD_SMEM
        assert plan.smem and plan.per == cd.GRAM_BLOCK_PER
        assert plan.threads % 32 == 0
        assert cd.GRAM_BLOCK_MIN_THREADS <= plan.threads <= \
            cd.GRAM_BLOCK_MAX_THREADS
        assert 1 <= plan.owners <= plan.threads - 32
        assert plan.per * plan.owners >= K * T
        whole = (_one_cta_bytes(K, T, plan._replace(g_whole=True), item)
                 <= cd.SMEM_DYN_MAX)
        assert plan.g_whole == whole
        # the owners of a multiple of T share one task each (one delta load
        # a step) wherever that still holds q
        if plan.owners % T == 0:
            e = np.arange(plan.owners)[:, None] + \
                plan.owners * np.arange(plan.per)[None]
            for u in range(0, plan.owners, max(1, plan.owners // 7)):
                ts = {int(x) % T for x in e[u] if x < K * T}
                assert len(ts) <= 1
    assert n_single > 20


@pytest.mark.parametrize("K,T", [(64, 50), (512, 5), (256, 20), (128, 20),
                                 (10, 64)])
def test_one_cta_walk_covers_every_entry_once(K, T):
    """Owner u of the plan's owners holds e = u + k * owners (k < per): the
    flat [K, T] once over, each owner at most GRAM_BLOCK_PER entries."""
    plan = cd.gram_block_plan(K, T, F64)
    assert plan.cluster == 1
    e = np.arange(plan.owners)[:, None] + \
        plan.owners * np.arange(plan.per)[None]
    got = np.sort(e[e < K * T])
    np.testing.assert_array_equal(got, np.arange(K * T))


@pytest.mark.parametrize("K,T,whole", [(64, 50, True), (128, 20, True),
                                       (256, 20, False), (512, 5, False),
                                       (2049, 1, False)])
def test_one_cta_stages_g_where_the_plan_says(K, T, whole):
    """The leadfield's K = 64 (32 KB of G) and K = 128 stage G whole; the
    K = 256 and 512 lanes of the grids stream its columns through the ring
    (G would take 0.5 and 2 MB)."""
    plan = cd.gram_block_plan(K, T, F64)
    assert plan.cluster == 1 and plan.g_whole == whole


def test_forced_one_cta_layouts():
    """A forced single CTA takes the layouts that hold what it can: q in
    shared memory past the registers' reach, beta and c in global memory
    past the shared memory's (the step-down's last resort at K = 1024, T =
    20 in float64); past the chain's 64 tasks it raises, and the
    step-down never reaches one CTA there."""
    p = cd.gram_block_plan(1024, 20, F64, cluster=1)
    assert (p.per, p.smem, p.g_whole) == (0, False, False)
    assert p.dyn_bytes <= cd.SMEM_DYN_MAX and p.threads == 1024
    p = cd.gram_block_plan(300, 50, F32, cluster=1)
    assert (p.per, p.smem) == (0, True) and p.dyn_bytes <= cd.SMEM_DYN_MAX
    p = cd.gram_block_plan(64, 50, F64, cluster=1, threads=64)
    assert p.per == 0 and p.owners == 32
    with pytest.raises(ValueError, match="64 tasks"):
        cd.gram_block_plan(4, 65, F64, cluster=1)
    with pytest.raises(RuntimeError, match="no cluster size"):
        cd.gram_block_plan(4, 65, F64, placeable=lambda k, p, d: False)


def test_constants_mirror_the_kernel():
    """The plan's constants are the kernel's (csrc/cd_epoch.cu)."""
    src = CSRC.read_text()

    def const(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])
    assert const("kBlockPer") == cd.GRAM_BLOCK_PER
    assert const("kBlockThreads") == cd.GRAM_BLOCK_MAX_THREADS
    assert 32 * const("kBlockChain") == cd.GRAM_BLOCK_CHAIN_T
    assert const("kBlockRing") == cd.GRAM_BLOCK_RING
    assert const("kBlockSlots") == cd.GRAM_BLOCK_SLOTS
    # the launch bounds of the one-CTA kernel admit the plan's threads
    assert re.search(r"__launch_bounds__\(PER > 0 \? kBlockThreads : 1024\)"
                     r"\s+cd_gram_block_kernel", src)
