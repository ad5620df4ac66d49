"""The launch plan of the float64 product of K3b, K3l and K3bl
(``product_plan`` in ``repro_torch/kernels/fused_ws.py``).

The plan is plain Python: from (n, p, N) and the card's CTA slots (its
SMs times the kernel's resident CTAs an SM) it picks the kernel (the
narrow one at N <= 24, the wide one above, for K3b, K3l and K3bl alike),
the column tile, the sample spans and the scratch. These tests hold it to
what ``csrc/fused_ws.cu`` needs: one launch whose grid covers every
feature, column and sample, column tiles that are multiples of 8, shared
memory within the H100's 232,448 bytes a CTA, enough CTAs to fill the card
at the main path's shapes, and tiles that match the CUDA source's
constants. The gpu tests (``tests/test_torch_gpu.py``) ask the card for
its occupancy and hold the launches to their plain versions.
"""
import re

import pytest

from repro_torch.kernels import ops  # noqa: F401  (before the submodule)
from repro_torch.kernels import fused_ws as fw

SMEM_CTA_MAX = 232_448          # H100: dynamic shared memory a CTA
SMEM_SM = 233_472               # H100: shared memory an SM (228 KB)
SMS = 132
# the H100's resident CTAs an SM of each kernel (its answer to
# fused_ws_product_info(wide, 1), asked by tests/test_torch_gpu.py)
PER_SM = {"narrow": 4, "wide": 2}
ROW = (10_000, 20_000)          # K3b's and K3bl's row shape (n, p)
LEADFIELD = (305, 7498)         # the M/EEG leadfield at MEG width
NS = (1, 24, 25, 100, 200, 500, 4096)


def _slots(N):
    return SMS * PER_SM["wide" if N > fw.MMA_TASKS else "narrow"]


def _plan(n, p, N):
    return fw.product_plan(n, p, N, slots=_slots(N))


def _cuda_constants():
    src = fw.__file__.rsplit("/", 2)[0] + "/csrc/fused_ws.cu"
    text = open(src).read()
    return {k: int(v) for k, v in
            re.findall(r"constexpr int (k\w+) = (\d+);", text)}


def _covers(plan, n, p, N):
    """The grid of the one launch covers every feature, column and sample,
    and no tile lies wholly past them."""
    c = plan.tile
    assert plan.feat_tiles * c.bm >= p > (plan.feat_tiles - 1) * c.bm
    assert plan.spans * plan.span >= n
    assert plan.span % c.bk == 0
    if plan.wide:
        assert plan.col_tiles * plan.bn >= N > (plan.col_tiles - 1) * plan.bn
    else:
        assert plan.col_tiles == 1 and N <= plan.bn == fw.MMA_TASKS
    assert plan.feat_tiles <= 65_535 and 1 <= plan.spans <= fw.MAX_SPANS


@pytest.mark.parametrize("N", NS)
@pytest.mark.parametrize("shape", [ROW, LEADFIELD, (200, 400), (7, 3)],
                         ids=["row", "leadfield", "g4", "tiny"])
def test_one_product_launch_covers_the_output(shape, N):
    n, p = shape
    _covers(_plan(n, p, N), n, p, N)


@pytest.mark.parametrize("N", NS)
def test_column_tile_is_a_multiple_of_8(N):
    for shape in (ROW, LEADFIELD):
        plan = _plan(*shape, N)
        assert plan.bn % 8 == 0 and 8 <= plan.bn <= 128
        if plan.wide:
            # the tiles are as even as multiples of 8 allow
            assert plan.bn - 8 < -(-N // plan.col_tiles) <= plan.bn


@pytest.mark.parametrize("name", ["narrow", "wide"])
def test_shared_memory_fits_a_cta_and_its_slots(name):
    """Each kernel's ring of stages of X [bm, bk + 4] and R [bk, bn + 4]
    (the CUDA source's constants) fits a CTA, and the H100 occupancy this
    file assumes fits the SM's shared memory (1 KB of it reserved a CTA)
    and its 2048 threads."""
    k = _cuda_constants()
    if name == "narrow":
        bm, bn, bk, stages, threads = (k["kMmaM"], k["kMmaT"], k["kMmaK"], 2,
                                       k["kMmaThreads"])
    else:
        bm, bn, bk, stages = (32 * k["kWideWM"], k["kWideN"], k["kWideK"],
                              k["kWideStages"])
        threads = 32 * k["kWideWM"] * k["kWideWN"]
        assert PER_SM["wide"] == k["kWidePerSM"]
    smem = 8 * stages * (bm * (bk + 4) + bk * (bn + 4))
    assert smem <= SMEM_CTA_MAX
    assert PER_SM[name] * (smem + 1024) <= SMEM_SM
    assert threads * PER_SM[name] <= 2048


@pytest.mark.parametrize("shape", [ROW, LEADFIELD], ids=["row", "leadfield"])
def test_a_full_wave_at_the_main_path_shapes(shape):
    n, p = shape
    N = 200 if shape == ROW else 500
    assert _plan(n, p, N).ctas >= _slots(N)


def test_spans_at_the_row_and_leadfield_shapes():
    """The row shape's 626 CTAs (2.4 waves of 264 slots) get a second span
    (5 waves of half the stages: the modelled time's minimum); at the
    leadfield (n = 305) K3bl's 472 CTAs take one span, K3b's 118 at T = 50
    two (one wave either way, half the stages); K3b's narrow row keeps the
    5 spans it had before the plan (the fill of its 4-a-SM slots)."""
    assert _plan(*ROW, 200).spans == 2
    assert _plan(*LEADFIELD, 500).spans == 1
    assert _plan(*LEADFIELD, 50).spans == 2
    assert _plan(*ROW, 20).spans == 5
    assert _plan(*ROW, 10).spans == 5
    # a grid of whole waves needs no span
    assert _plan(10_000, fw.WIDE.bm * _slots(128), 128).spans == 1
    # no span shorter than MIN_SPAN_STAGES stages
    for n in (7, 300, 10_000):
        plan = _plan(n, 400, 100)
        assert plan.spans == 1 or \
            plan.spans * fw.MIN_SPAN_STAGES * plan.tile.bk <= n


@pytest.mark.parametrize("N", NS)
def test_scratch_holds_every_span(N):
    for shape in (ROW, LEADFIELD):
        n, p = shape
        plan = _plan(n, p, N)
        ld = N if N > fw.MMA_TASKS else fw.MMA_TASKS
        assert plan.ld == ld
        assert plan.scratch == plan.spans * p * ld


@pytest.mark.parametrize("N", NS)
def test_routing_by_width(N):
    """The narrow kernel at N <= 24 (K3b's and K3l's rows do not move; it
    is the faster there), the wide one above: K3bl at every S*T past 24,
    K3b at the leadfield's T = 50, K3l at the (g4) grid's 50 lanes."""
    for shape in (ROW, LEADFIELD):
        plan = _plan(*shape, N)
        assert plan.wide == (N > fw.MMA_TASKS)
        assert plan.name == ("wide" if N > fw.MMA_TASKS else "narrow")


def test_configurations_match_the_cuda_source():
    """NARROW and WIDE hold the CUDA kernels' CTA tiles: features (the
    wide kernel's 32 a warp row), the most columns and the samples of a
    stage; MAX_SPANS is the launcher's bound."""
    k = _cuda_constants()
    assert (fw.NARROW.bm, fw.NARROW.bn, fw.NARROW.bk) == (
        k["kMmaM"], k["kMmaT"], k["kMmaK"])
    assert (fw.WIDE.bm, fw.WIDE.bn, fw.WIDE.bk) == (
        32 * k["kWideWM"], k["kWideN"], k["kWideK"])
    assert fw.MMA_TASKS == k["kMmaT"]
    assert fw.MAX_SPANS == k["kMmaMaxSplits"]
