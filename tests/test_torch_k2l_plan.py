"""K2l's lane plan (``kernels/cd_epoch.py: xb_lanes_plan``) on the CPU,
with stand-ins for the card's answer to how many clusters of each size it
places at once. Of the sizes whose slice fits the shared-memory branch:
the fewest waves of lanes first, then the fewest CTAs on an SM in a wave,
then the largest cluster, then the fewest threads; K2's own plan where no
size qualifies (no card, or slices past shared memory at every size)."""
import pytest
import torch

from repro_torch.kernels import ops  # noqa: F401  (imports core first)
from repro_torch.kernels import cd_epoch as cd

F64, F32 = torch.float64, torch.float32
SMS = 132
# the H100's answers for K2's clusters at n = 10,000, weighted, float64
# (``cd_sweep.py k2l_rule``: its clusters at once, by size)
H100 = {16: 14, 8: 15, 4: 30, 2: 66, 1: 132}


def _table(counts):
    def capacity(plan, dtype):
        return counts.get(plan.cluster, 0), SMS
    return capacity


@pytest.mark.parametrize("S,C", [(1, 16), (5, 16), (8, 16), (9, 8),
                                 (10, 8), (15, 8), (16, 4), (30, 4),
                                 (31, 2), (50, 2), (66, 2), (100, 2)])
def test_the_h100s_answers(S, C):
    """On the H100's answers: one wave with a CTA an SM at the largest
    size that allows it (16 CTAs a lane up to 8 lanes, 8 up to 15), then
    the fewest waves (2 CTAs a lane place 66 lanes at once; one CTA a
    lane holds no slice of 10,000 samples)."""
    plan = cd.xb_lanes_plan(S, 10_000, True, F64, capacity=_table(H100))
    assert plan == cd.xb_plan(10_000, True, F64, cluster=C)
    assert plan.smem


@pytest.mark.parametrize("S,counts,C", [
    (10, {16: 8, 8: 16, 4: 3}, 8),         # C = 16 takes 2 waves, 8 one
    (50, {16: 8, 8: 16, 4: 33}, 4),        # 7, 4 and 2 waves
    (5, {16: 5, 8: 5, 4: 5}, 16),          # one wave, a CTA an SM: largest
    (20, {16: 25, 8: 25, 4: 25}, 4),       # one wave; 16 and 8 share SMs
    (60, {16: 30, 8: 30, 4: 30, 2: 30}, 4),  # two waves; 4 and 2 share none
])
def test_fewest_waves_then_fewest_ctas_an_sm(S, counts, C):
    """Of the sizes that fit, the fewest waves of lanes wins, then the
    fewest CTAs on an SM in a wave, then the largest cluster."""
    plan = cd.xb_lanes_plan(S, 10_000, True, F64, capacity=_table(counts))
    assert plan.cluster == C
    assert plan == cd.xb_plan(10_000, True, F64, cluster=C)


def test_sizes_the_card_does_not_place_are_skipped():
    """A size with no cluster at once is never taken; where the card
    places none of the qualifying sizes (no card: capacity 0), K2's own
    plan."""
    assert cd.xb_lanes_plan(10, 10_000, True, F64,
                            capacity=_table({16: 4})).cluster == 16
    none = cd.xb_lanes_plan(10, 10_000, True, F64, capacity=_table({}))
    assert none == cd.xb_plan(10_000, True, F64)
    # this sandbox has no card: the default capacity is 0 at every size
    assert cd.xb_lanes_plan(10, 10_000, True, F64) == \
        cd.xb_plan(10_000, True, F64)


@pytest.mark.parametrize("n,weighted,dtype", [(160_003, True, F64),
                                              (160_003, False, F64),
                                              (400_000, True, F32)])
def test_k2_plan_where_no_slice_fits(n, weighted, dtype):
    """Slices past shared memory at every size: K2's own plan, whatever
    the card places."""
    assert not any(cd.xb_plan(n, weighted, dtype, cluster=C).smem
                   for C in cd.STEP_DOWN)
    assert cd.xb_lanes_plan(10, n, weighted, dtype,
                            capacity=_table(H100)) == \
        cd.xb_plan(n, weighted, dtype)


@pytest.mark.parametrize("n,weighted", [(10_000, True), (50_000, True),
                                        (2000, False), (65_536, False)])
def test_every_qualifying_size_fits_a_cta(n, weighted):
    """Each size the plan may take holds its warp-sum slots and slices in
    a CTA's shared memory, and its threads cover the slice: XB_PER
    samples a thread in registers on at most PER_THREADS threads, else
    the slice read from memory."""
    for C in cd.STEP_DOWN:
        p = cd.xb_plan(n, weighted, F64, cluster=C)
        if not p.smem:
            continue
        m = -(-n // C)
        assert p.dyn_bytes <= cd.SMEM_DYN_MAX
        if p.per:
            assert p.per * p.threads >= m and p.threads <= cd.PER_THREADS
        else:
            assert p.threads > cd.PER_THREADS or \
                p.threads * cd.XB_PER < m
