"""The launch plans of K2 (``xb_plan``) and K1b (``gram_block_plan``).

The plans choose, from a call's shape alone, the layout of a K2 or K1b
launch: K1b's one CTA or a thread-block cluster, the state's slices in
shared or in global memory, the dynamic shared memory of each CTA, the
threads and the register path. These tests hold them to what the kernels
of ``csrc/cd_epoch.cu`` need: a cluster at the main path's shapes, every
shared-memory branch within the card's 232,448 bytes per CTA, thread counts
the kernels can launch, and the single-CTA and global branches where the
plan's thresholds put them. They run on the CPU: the plans are plain
Python.
"""
import pytest
import torch

from repro_torch.kernels import ops  # noqa: F401  (before the submodule)
from repro_torch.kernels import cd_epoch as cd

F64, F32 = torch.float64, torch.float32
CARD_SMEM = 232_448


def _xb_state(n, C, weighted, item):
    """What K2's cluster kernel keeps per CTA in dynamic shared memory: Xb,
    the raw gradient, y (and w) for ceil(n / C) samples."""
    return -(-n // C) * (4 if weighted else 3) * item


def _gram_block_state(K, T, C, item):
    """K1b's cluster kernel: two parity slots and the local copy of delta_j
    and its flag (3 (T + 1) values), then ceil(K / C) rows of q."""
    return (3 * (T + 1) + -(-K // C) * T) * item


def _one_cta_state(K, T, plan, item):
    """K1b's one-CTA kernel: the next rows [2][T] and deltas [3][T], L and
    step [K], G whole or its ring of columns, beta and c where staged, q
    where the owners do not hold it in registers."""
    KT = K * T
    return ((2 + 3) * T + 2 * K
            + (K * K if plan.g_whole else cd.GRAM_BLOCK_RING * K)
            + (2 * KT if plan.smem else 0) + (0 if plan.per else KT)) * item


def _threads_ok(plan):
    assert 32 <= plan.threads <= 1024 and plan.threads % 32 == 0
    # the cluster kernels' register paths run on at most PER_THREADS threads
    # (their launch bounds); K1b's one CTA on up to 1024
    assert plan.per == 0 or plan.threads <= cd.PER_THREADS or \
        plan.cluster == 1


@pytest.mark.parametrize("n,weighted", [(10_000, False), (10_000, True),
                                        (50_000, False), (50_000, True)])
def test_xb_plan_clusters_the_main_path(n, weighted):
    """K2 at the main path's shapes (512 x 10,000 dense logistic; up to
    4096 x 50,000 weighted sparse logistic) runs on a cluster with its
    slices in shared memory."""
    plan = cd.xb_plan(n, weighted, F64)
    assert plan.cluster == cd.CLUSTER >= 2
    assert plan.branch == "cluster-shared"
    assert plan.dyn_bytes == _xb_state(n, plan.cluster, weighted, 8)
    assert plan.dyn_bytes <= cd.SMEM_DYN_MAX < CARD_SMEM


@pytest.mark.parametrize("K", [1024, 2048, 4096])
def test_gram_block_plan_clusters_the_main_path(K):
    """K1b at the sparse multitask fit's working sets (T = 20) runs on a
    cluster with q's rows in shared memory."""
    plan = cd.gram_block_plan(K, 20, F64)
    assert plan.cluster == cd.CLUSTER >= 2
    assert plan.branch == "cluster-shared"
    assert plan.dyn_bytes == _gram_block_state(K, 20, plan.cluster, 8)
    assert plan.dyn_bytes <= cd.SMEM_DYN_MAX


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("n", [1, 7, 255, 2048, 2049, 10_001, 77_000,
                               100_003, 1_000_000])
def test_xb_plan_fits_the_card(n, weighted, dtype):
    """K2 always runs on a cluster; the shared branch holds the whole slice
    within the card's shared memory, the global one holds none of it."""
    plan = cd.xb_plan(n, weighted, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert plan.cluster == cd.CLUSTER
    assert plan.branch in cd.BRANCHES
    _threads_ok(plan)
    full = _xb_state(n, plan.cluster, weighted, item)
    assert plan.smem == (full <= cd.SMEM_DYN_MAX)
    assert plan.dyn_bytes == (full if plan.smem else 0)
    # the register path covers the slice: per samples a thread
    if plan.per:
        assert plan.per * plan.threads >= -(-n // plan.cluster)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("K,T", [(1, 1), (64, 20), (64, 50), (512, 20),
                                 (1024, 20), (2049, 1), (4096, 50),
                                 (20_000, 20), (3, 500)])
def test_gram_block_plan_fits_the_card(K, T, dtype):
    plan = cd.gram_block_plan(K, T, dtype)
    item = torch.empty((), dtype=dtype).element_size()
    assert plan.branch in cd.BRANCHES
    _threads_ok(plan)
    if plan.cluster == 1:
        # one CTA holds the whole state on chip: q in its owners'
        # registers, beta, c, L and G (or G's ring) in shared memory
        assert plan.smem and plan.per == cd.GRAM_BLOCK_PER
        assert plan.per * plan.owners >= K * T
        assert plan.dyn_bytes == _one_cta_state(K, T, plan, item) \
            <= cd.SMEM_DYN_MAX
    else:
        full = _gram_block_state(K, T, plan.cluster, item)
        assert plan.smem == (full <= cd.SMEM_DYN_MAX)
        assert plan.dyn_bytes == (full if plan.smem else 3 * (T + 1) * item)
        assert plan.dyn_bytes <= cd.SMEM_DYN_MAX
        if plan.per:
            assert plan.per * plan.threads >= -(-K // plan.cluster) * T


def test_plans_take_every_branch_where_they_say():
    """K1b on one CTA at or below its single-CTA threshold and on a cluster
    above it, and on the cluster where one CTA cannot hold the state on
    chip (T = 1 at K = the threshold: beta, c, L, step and G's ring in
    shared memory) or runs more tasks than its chain warp holds; K2 and
    K1b on the global-memory branch of a cluster past C slices of shared
    memory (float32 halves the bytes: the shared branch reaches twice as
    far)."""
    kt = cd.GRAM_BLOCK_SINGLE_MAX_KT
    assert cd.gram_block_plan(kt // 20, 20, F64).branch == "single"
    assert cd.gram_block_plan(kt // 20 + 1, 20, F64).cluster == cd.CLUSTER
    assert cd.gram_block_plan(kt, 1, F64).cluster == cd.CLUSTER
    assert cd.gram_block_plan(kt + 1, 1, F64).cluster == cd.CLUSTER
    assert cd.gram_block_plan(2, cd.GRAM_BLOCK_CHAIN_T + 1,
                              F64).cluster == cd.CLUSTER
    assert cd.gram_block_plan(2048, 240, F64).branch == "cluster-global"
    assert cd.gram_block_plan(2048, 240, F32).branch == "cluster-shared"
    assert cd.xb_plan(1, True, F64).branch == "cluster-shared"
    for weighted in (False, True):
        assert cd.xb_plan(160_003, weighted, F64).branch == "cluster-global"
        assert cd.xb_plan(160_003, weighted, F32).branch == "cluster-shared"


def test_forced_cluster_sizes():
    """`cluster=` forces C (K1b's 1 is its one-CTA kernel) and keeps the
    shared-memory rule."""
    for C in (1, 8, 16):
        assert cd.xb_plan(50_000, True, F64, cluster=C).cluster == C
        assert cd.gram_block_plan(4096, 20, F64, cluster=C).cluster == C
    assert not cd.xb_plan(50_000, True, F64, cluster=1).smem
    assert cd.xb_plan(50_000, True, F64, cluster=16).smem
    assert cd.gram_block_plan(4096, 20, F64, cluster=1).branch == "single"


def test_branch_counts_start_at_zero_and_cpu_counts_nothing():
    """The per-branch counters cover every branch, are reset with the
    launch counts, and the CPU route (the plain versions) counts none."""
    ops.reset_launch_counts()
    counts = ops.branch_counts()
    assert set(counts) == {"cd_epoch_gram", "cd_epoch_xb",
                           "cd_epoch_gram_block", "cd_epoch_gram_lanes",
                           "cd_epoch_xb_lanes", "cd_epoch_gram_block_lanes"}
    for per in counts.values():
        assert per == dict.fromkeys(cd.BRANCHES, 0)
    from repro_torch.core.penalties import L1
    g = torch.Generator().manual_seed(0)
    Xt = torch.randn(4, 300, generator=g, dtype=F64)
    y = torch.sign(torch.randn(300, generator=g, dtype=F64))
    z = torch.zeros(4, dtype=F64)
    ops.cd_epoch_xb(Xt, y, z, torch.zeros(300, dtype=F64),
                    torch.sum(Xt * Xt, 1) / 1200, z, L1,
                    ops.penalty_params(L1(0.01)), "logistic")
    assert ops.branch_counts()["cd_epoch_xb"] == \
        dict.fromkeys(cd.BRANCHES, 0)
    assert ops.launch_counts()["cd_epoch_xb"] == 0


# ------------------------------------------- plans the card can place
# placement tests that refuse 16 CTAs, everything above 2, and every
# cluster, with the size each plan must step down to
REFUSALS = {"no-16": (lambda kernel, plan, dtype: plan.cluster <= 8, 8),
            "above-2": (lambda kernel, plan, dtype: plan.cluster <= 2, 2),
            "every-cluster": (lambda kernel, plan, dtype: plan.cluster == 1,
                              1)}


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("refusal", list(REFUSALS))
def test_plans_step_down_to_a_placeable_cluster(refusal, dtype):
    """Where the placement test refuses their cluster, K1, K2 and K1b step
    down 16 -> 8 -> 4 -> 2 -> one CTA and come back with the layout of the
    plan forced to the first size it accepts (the same rows a CTA, state
    in shared memory by the same rule, threads in range), having asked
    the sizes from the top down. K1b on one CTA cannot hold q at K = 4096,
    T = 20: with every cluster refused, that plan raises."""
    test, C = REFUSALS[refusal]
    item = torch.empty((), dtype=dtype).element_size()
    asked = []

    def spy(kernel, plan, dt):
        asked.append(plan.cluster)
        return test(kernel, plan, dt)

    def sizes_from_the_top():
        want = [c for c in cd.STEP_DOWN if c >= C]
        assert asked == want, (asked, want)
        asked.clear()

    for K in (257, 1024, 4096):
        plan = cd.gram_plan(K, dtype, placeable=spy)
        sizes_from_the_top()
        assert plan == cd.gram_plan(K, dtype, cluster=C)
        assert plan.dyn_bytes <= cd.SMEM_DYN_MAX
        assert cd.GRAM_MIN_THREADS <= plan.threads <= cd.GRAM_MAX_THREADS
    for n, weighted in ((10_000, False), (50_000, True), (160_003, True)):
        plan = cd.xb_plan(n, weighted, dtype, placeable=spy)
        sizes_from_the_top()
        assert plan == cd.xb_plan(n, weighted, dtype, cluster=C)
        assert plan.dyn_bytes <= cd.SMEM_DYN_MAX
        _threads_ok(plan)
    for K, T in ((1024, 20), (2048, 20), (4096, 20)):
        if C == 1 and (T + K * T) * item > cd.SMEM_DYN_MAX:
            with pytest.raises(RuntimeError, match="no cluster size"):
                cd.gram_block_plan(K, T, dtype, placeable=spy)
            asked.clear()
            continue
        plan = cd.gram_block_plan(K, T, dtype, placeable=spy)
        sizes_from_the_top()
        assert plan == cd.gram_block_plan(K, T, dtype, cluster=C)
        assert plan.dyn_bytes <= cd.SMEM_DYN_MAX
        _threads_ok(plan)


def test_placement_swaps_the_default_test():
    """``placement`` makes its test the plans' default within it (how a
    solve is run with 16 CTAs refused); a forced ``cluster=`` is never
    stepped down."""
    with cd.placement(REFUSALS["no-16"][0]):
        assert cd.gram_plan(2048, F64).cluster == 8
        assert cd.xb_plan(10_000, False, F64).cluster == 8
        assert cd.gram_block_plan(4096, 20, F64).cluster == 8
        assert cd.xb_plan(10_000, False, F64, cluster=16).cluster == 16
    assert cd.gram_plan(2048, F64).cluster == cd.GRAM_CLUSTER


# ------------------------------------------------- K1l's plan of S lanes
# one gram_plan a K, as the plans stood before the lane plan came: the
# one-lane plan (K1's) must not move. (K, cluster, dyn_bytes, threads)
ONE_LANE_PLANS = {
    F64: [(1, 1, 36880, 256), (31, 1, 37360, 256), (33, 1, 37392, 256),
          (64, 1, 37888, 256), (256, 1, 40960, 288), (257, 16, 37120, 256),
          (1023, 16, 37632, 256), (1024, 16, 37632, 256),
          (1025, 16, 37632, 256), (2048, 16, 38144, 256),
          (2049, 16, 38144, 256), (4096, 16, 39168, 288),
          (20_000, 16, 47616, 512)],
    F32: [(1, 1, 18440, 256), (31, 1, 18680, 256), (33, 1, 18696, 256),
          (64, 1, 18944, 256), (256, 1, 20480, 288), (257, 16, 18560, 256),
          (1023, 16, 18816, 256), (1024, 16, 18816, 256),
          (1025, 16, 18816, 256), (2048, 16, 19072, 256),
          (2049, 16, 19072, 256), (4096, 16, 19584, 288),
          (20_000, 16, 23808, 512)]}


# the H100's answers for K1l (``cd_sweep.py k1l_rule``): clusters of C
# CTAs placed at once, a CTA an SM and two of 256 threads an SM
_H100 = {16: (7, 14), 8: (15, 30), 4: (30, 62), 2: (66, 132)}


def _one_card(plan, dtype, pen):
    """A stand-in for the card's answer to K1l's plan (``lane_capacity``):
    an H100's clusters at once and its 132 SMs."""
    one, two = _H100[plan.cluster]
    return (two if plan.threads <= 256 else one), 132


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("case", range(13))
def test_gram_plan_of_one_lane_is_unchanged(case, dtype):
    """K1's plan (``gram_plan`` of one lane) is the same at every K the
    tests use, unforced and on a card that places every size."""
    K, C, dyn, threads = ONE_LANE_PLANS[dtype][case]
    assert cd.gram_plan(K, dtype) == cd.GramPlan(C, dyn, threads)
    assert cd.gram_plan(K, dtype, placeable=lambda *a: True) == \
        cd.GramPlan(C, dyn, threads)


def _key(S, plan):
    """(waves, threads a CTA, CTAs on an SM in a wave) of `plan` for S lanes
    on the stand-in card."""
    n, sms = _one_card(plan, F64, 0)
    return -(-S // n), plan.threads, -(-min(S, n) * plan.cluster // sms)


def _sizes(K):
    return {D: cd.gram_plan(K, F64, cluster=D) for D in cd.STEP_DOWN[:-1]}


@pytest.mark.parametrize("S,K,C", [
    (1, 1024, 16), (7, 1024, 16), (10, 1024, 8), (14, 1024, 8),
    (20, 1024, 8), (30, 1024, 8), (50, 1024, 2), (10, 512, 8),
    (20, 512, 4), (50, 512, 4), (62, 512, 4), (10, 2048, 16),
    (15, 2048, 8), (20, 2048, 4), (1, 4096, 16), (7, 4096, 16),
    (10, 4096, 8), (50, 4096, 2), (63, 512, 2), (10, 257, 8),
    (66, 20_000, 2)])
def test_gram_lanes_plan_takes_one_wave(S, K, C):
    """Where a cluster size of STEP_DOWN runs all S lanes at once, the lane
    plan takes one such size, laid out by ``gram_plan`` at that size: of
    those, the fewest threads a CTA, then the fewest CTAs on an SM, then
    the largest."""
    plan = cd.gram_lanes_plan(S, K, F64, capacity=_one_card)
    assert plan.cluster == C and plan == cd.gram_plan(K, F64, cluster=C)
    key = _key(S, plan)
    assert key[0] == 1
    for D, other in _sizes(K).items():
        assert _key(S, other) > key or (D <= C and _key(S, other) == key)


@pytest.mark.parametrize("S,K,C", [(67, 1024, 2), (100, 2048, 2),
                                   (133, 4096, 2), (200, 512, 4),
                                   (100, 512, 4)])
def test_gram_lanes_plan_takes_the_fewest_waves(S, K, C):
    """Where no cluster size runs all S lanes at once, the lane plan takes
    a size with the fewest waves as the card places them (CTAs sharing an
    SM), not K1's 16 CTAs in as many waves as the card needs; of those,
    the fewest threads a CTA, then the fewest CTAs on an SM."""
    plan = cd.gram_lanes_plan(S, K, F64, capacity=_one_card)
    assert plan.cluster == C and plan == cd.gram_plan(K, F64, cluster=C)
    waves = {D: _key(S, other)[0] for D, other in _sizes(K).items()}
    assert waves[C] == min(waves.values()) > 1
    key = _key(S, plan)
    for D, other in _sizes(K).items():
        assert _key(S, other) > key or (D <= C and _key(S, other) == key)


@pytest.mark.parametrize("S,K", [(1, 1024), (10, 1024), (50, 2048),
                                 (10, 4096)])
def test_gram_lanes_plan_keeps_the_one_lane_plan_without_capacity(S, K):
    """Where the card runs no cluster of any size (capacity 0, as without a
    card), the lane plan is K1's own, which steps down as K1's does."""
    plan = cd.gram_lanes_plan(S, K, F64, capacity=lambda *a: (0, 0))
    assert plan == cd.gram_plan(K, F64)
    with cd.placement(REFUSALS["no-16"][0]):
        assert cd.gram_lanes_plan(S, K, F64, capacity=lambda *a: (0, 0)) == \
            cd.gram_plan(K, F64, cluster=8)


@pytest.mark.parametrize("dtype", [F64, F32])
@pytest.mark.parametrize("K", [1, 31, 64, 255, 256])
def test_gram_lanes_plan_keeps_one_cta_at_small_k(K, dtype):
    """K <= GRAM_SINGLE_MAX_K: one CTA a lane, whatever the card holds."""
    for S in (1, 10, 50):
        for cap in (_one_card, lambda *a: (10 ** 6, 132),
                    lambda *a: (0, 0)):
            plan = cd.gram_lanes_plan(S, K, dtype, capacity=cap)
            assert plan == cd.gram_plan(K, dtype) and plan.cluster == 1


def test_gram_lanes_plan_asks_the_capacity_of_its_penalty():
    """The lane plan asks one count a size, the capacity of the penalty's
    own instance, from the largest size down, and skips a size the card
    places none of (as the one-lane plans step down)."""
    asked = []

    def cap(plan, dtype, pen):
        asked.append((plan.cluster, pen))
        return (0, 0) if plan.cluster == 16 else (10 ** 6, 132)

    assert cd.gram_lanes_plan(1, 1024, F64, pen=2, capacity=cap).cluster == 8
    assert asked == [(16, 2), (8, 2), (4, 2), (2, 2)]


@pytest.mark.parametrize("K", [30_000, 400_000])
def test_gram_lanes_plan_refuses_a_state_no_size_holds(K):
    """A size whose update CTAs cannot hold a lane's rows is skipped (at K
    = 30,000 two CTAs cannot: 16 takes the lanes); past what 16 CTAs hold,
    no size holds a lane and the plan raises, as ``gram_plan`` does."""
    if K == 30_000:
        with pytest.raises(ValueError, match="shared memory"):
            cd.gram_plan(K, F64, cluster=2)
        plan = cd.gram_lanes_plan(200, K, F64, capacity=_one_card)
        assert plan.cluster in (16, 8, 4)
        return
    for cap in (_one_card, lambda *a: (0, 0)):
        with pytest.raises(ValueError, match="shared memory"):
            cd.gram_lanes_plan(10, K, F64, capacity=cap)


@pytest.mark.parametrize("K,C,key", [(1, 1, "K=1 C=1"), (200, 1, "K=256 C=1"),
                                     (1000, 8, "K=1024 C=8"),
                                     (1024, 4, "K=1024 C=4"),
                                     (1025, 16, "K=2048 C=16")])
def test_lane_launches_count_by_shape(K, C, key):
    """K1l, K2l and K1bl count their launches by (K rounded up to a power
    of two, cluster size), directly and per replay of a captured graph;
    the reset clears them."""
    ops.reset_launch_counts()
    plan = cd.gram_plan(K, F64, cluster=C) if C > 1 or K <= 256 else None
    plan = plan or cd.GramPlan(C, 0, 256)
    for kernel in ops.SHAPED:
        ops._count(kernel, plan, K=K)
        with ops.deferred_launches() as records:
            ops._count(kernel, plan, K=K)
        assert kernel.launches == 1
        ops.add_launches(records, 3)
    counts = ops.shape_counts()
    assert set(counts) == {k.__name__ for k in ops.SHAPED}
    for name in counts:
        assert counts[name] == {key: 4}
        assert ops.launch_counts()[name] == 4
    ops.reset_launch_counts()
    assert all(v == {} for v in ops.shape_counts().values())
