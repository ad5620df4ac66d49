"""K3 and K3b: the fused working-set head (``csrc/fused_ws.cu``), its CUDA
launchers and its plain torch version.

K3 replaces ``repro/kernels/fused_ws.py:fused_ws_pallas`` (scalar form): one
pass over the feature-major design Xt [p, n] yields the violation scores,
the offset-corrected gradient and each tile's top-``kc`` candidates
(``kc = min(bp, ws_size)``) under the ``lax.top_k`` order with the
generalized support pinned to +inf; exhausted slots emit index p. On the
card it is three launches: the score launch (``score_cuda``, which K4
shares), the select launch (``select_cuda``) and the merge launch
(``merge_cuda``), which merges the tiles' sorted lists into the working
set, equal to ``select_working_set`` on the scores. None copies a
candidate row: the wrapper (``kernels/ops.py``) gathers the working set's
K rows of Xt, so no [tiles * kc, n] buffer exists on the card.

K3b replaces the block branch of the same kernel (multitask coefficients
beta [p, T], raw gradient R [n, T], a block penalty): the gradient is
[p, T] and each feature's score is its row score (``subdiff_dist`` of the
block penalty, or the row norm of the fixed-point difference). In float64
its product runs on the tensor cores (DMMA), one launch whatever T is
(``product_plan`` picks its kernel and sample spans); its select
launch is K3's, and its wrapper takes the working set with
``select_working_set``.

K3l (``fused_ws_lanes``) is K3 over S lanes that share X, the chunked
driver's dense head (``fused_ws_pallas`` under the reference's ``vmap``):
for each lane s, ``grad_s = Xt @ R[:, s] + offset``, its scalar scores
with its own beta, L and row of the codec vector, and its working set.
X is read once for all lanes: the gradient is K3b's float64 product
launch (DMMA) on R [n, S], then a reduce and score launch sums the
product's sample spans and writes each lane's scores, gradient and
priorities, and K3's select and merge launches run with a lane index on
their grids. Float64 only on the card. Its plain
version applies K3's lane by lane.

K3l's working-set rows come from K3g (``ws_gather_cuda``): one copy of
each distinct row of Xt that the S lanes selected into every lane slot
that selected it (``slot_map`` is its map of slots; ``ws_gather_plain``,
the same copy through the map, is its plain version, and equals
``index_select`` of the S K rows).

K3bl (``fused_ws_block_lanes``) is K3b over S lanes of multitask blocks
that share X: R [n, S*T] holds the lanes' raw gradients lane-major, beta
is [S, p, T]. One product launch runs over all S*T columns (the wide
one past 24: X streams once) into a scratch [spans, p, ld]; a reduce and
score launch sums the spans and writes each lane's gradient rows [S, p,
T], its row scores with its own beta, L and codec row, and its
priorities; K3's select and merge launches then run with the lane on grid
y, as K3l's. Float64 only on the card. Its plain version applies K3b's
lane by lane.

The plain version below covers both forms and keeps the four outputs
(``cand_cols``, the candidates' rows of Xt, included): it is the oracle
both heads are held to, and ``candidate_columns`` recovers the working
set's rows from it.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import torch

from ..core.working_set import priorities, violation_scores
from ._build import BUILD
from .cd_epoch import _check_rc, _suffix, kernel_params
from .common import make_penalty

__all__ = ["pick_bp", "fused_ws_plain", "fused_ws_cuda", "score_cuda",
           "select_cuda", "merge_cuda", "fused_ws_block_cuda", "MMA_TASKS",
           "MERGE_SMEM_K", "fused_ws_lanes_plain", "fused_ws_lanes_cuda",
           "merge_lanes_cuda", "fused_ws_block_lanes_plain",
           "fused_ws_block_lanes_cuda", "ProductTile", "NARROW", "WIDE",
           "ProductPlan", "product_plan", "card_product_plan",
           "product_cuda", "dmma_rate_cuda", "slot_map", "ws_gather_plain",
           "ws_gather_cuda", "gather_bytes"]

# columns of the narrow float64 product (csrc/fused_ws.cu: kMmaT)
MMA_TASKS = 24
# the largest working set whose merge lists fit in shared memory
# (csrc/fused_ws.cu: kMergeSmemK)
MERGE_SMEM_K = 6144


def pick_bp(p: int, cap: int = 1024) -> int:
    """Feature-tile width: the whole axis when it fits, else the largest
    divisor of p in (cap/2, cap] (no ragged tile), else `cap`."""
    if p <= cap:
        return p
    for b in range(cap, cap // 2, -1):
        if p % b == 0:
            return b
    return cap


def _tiling(p, ws_size, bp):
    bp = pick_bp(p) if bp is None else min(bp, p)
    return bp, -(-p // bp), min(bp, ws_size)


def fused_ws_plain(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                   ws_size, *, use_fp=False, bp=None):
    p, n = Xt.shape
    bp, tiles, kc = _tiling(p, ws_size, bp)
    grad = Xt @ r
    grad = grad + (offset[:, None] if grad.ndim == 2 else offset)
    scores = violation_scores(make_penalty(penalty_cls, params), beta, grad,
                              L, use_fixed_point=use_fp)
    pri = torch.full((tiles * bp,), -torch.inf, dtype=Xt.dtype,
                     device=Xt.device)
    pri[:p] = priorities(scores, gsupp)
    order = torch.sort(pri.view(tiles, bp), dim=1, descending=True,
                       stable=True).indices[:, :kc]
    gidx = (order + bp * torch.arange(tiles, device=Xt.device)[:, None])
    gidx = gidx.reshape(-1)
    valid = gidx < p
    cand_idx = torch.where(valid, gidx, p).to(torch.int32)
    cand_cols = torch.where(valid[:, None], Xt[torch.clamp(gidx, max=p - 1)],
                            0.0)
    return scores, grad, cand_idx, cand_cols


def fused_ws_lanes_plain(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                         ws_size, *, use_fp=False, bp=None):
    """K3l's plain version: K3's on each lane s (raw R[:, s], beta[s],
    L[s], gsupp[s], params[s]; offset shared). Returns the four outputs
    stacked over the lanes: scores, grad [S, p], cand_idx [S, C] and
    cand_cols [S, C, n]."""
    outs = [fused_ws_plain(Xt, R[:, s], beta[s], L[s], offset, gsupp[s],
                           penalty_cls, params[s], ws_size, use_fp=use_fp,
                           bp=bp)
            for s in range(beta.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def fused_ws_block_lanes_plain(Xt, R, beta, L, offset, gsupp, penalty_cls,
                               params, ws_size, *, use_fp=False, bp=None):
    """K3bl's plain version: K3b's on each lane s (raw R[:, s*T:(s+1)*T],
    beta[s] [p, T], L[s], gsupp[s], params[s]; offset shared). Returns the
    four outputs stacked over the lanes: scores [S, p], grad [S, p, T],
    cand_idx [S, C] and cand_cols [S, C, n]."""
    T = beta.shape[2]
    outs = [fused_ws_plain(Xt, R[:, s * T:(s + 1) * T].contiguous(), beta[s],
                           L[s], offset, gsupp[s], penalty_cls, params[s],
                           ws_size, use_fp=use_fp, bp=bp)
            for s in range(beta.shape[0])]
    return tuple(torch.stack(o) for o in zip(*outs))


def score_cuda(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
               gsupp=None, use_fp=False):
    """Launch the score pass on the tensors' stream (Xt contiguous [p, n]):
    K4's scores, or with `gsupp` K3's (scores, grad, pri), pri the
    selection priorities."""
    fn = getattr(BUILD.lib("fused_ws"), f"score_{_suffix(Xt)}")
    p, n = Xt.shape
    pid, prm = kernel_params(penalty_cls, params, Xt.device)
    scores = torch.empty_like(beta)
    grad = pri = None
    if gsupp is not None:
        grad, pri = torch.empty_like(beta), torch.empty_like(beta)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = fn(Xt.data_ptr(), r.data_ptr(), ptr(w), beta.data_ptr(),
                L.data_ptr(), offset.data_ptr(), ptr(gsupp),
                scores.data_ptr(), ptr(grad), ptr(pri), n, p, pid,
                int(bool(use_fp)), prm.data_ptr(), stream)
    _check_rc(rc, "score")
    return scores if gsupp is None else (scores, grad, pri)


def select_cuda(pri, bp, kc):
    """Launch the select pass on `pri` [p]'s stream: each tile of `bp`
    features' top-`kc` indices in the ``lax.top_k`` order, padded with p
    ([tiles * kc] int32)."""
    fn = getattr(BUILD.lib("fused_ws"), f"select_{_suffix(pri)}")
    p = pri.shape[0]
    cand_idx = torch.empty(-(-p // bp) * kc, dtype=torch.int32,
                           device=pri.device)
    with torch.cuda.device(pri.device):
        stream = torch.cuda.current_stream(pri.device).cuda_stream
        rc = fn(pri.data_ptr(), cand_idx.data_ptr(), p, bp, kc, stream)
    _check_rc(rc, "select")
    return cand_idx


def merge_cuda(pri, cand_idx, bp, ws_size):
    """Launch the merge pass on `pri` [p]'s stream: the working set, the
    first `ws_size` features of the ``lax.top_k`` order of the priorities,
    merged from the tiles' sorted top-kc lists `cand_idx` (int64
    [ws_size]; its plain version is ``select_working_set``). Its
    ceil(sqrt(tiles)) CTAs each merge a run of tiles, the last to finish
    merges their lists; past MERGE_SMEM_K the lists lie in global
    scratch."""
    fn = getattr(BUILD.lib("fused_ws"), f"merge_{_suffix(pri)}")
    p = pri.shape[0]
    tiles = -(-p // bp)
    kc = cand_idx.shape[0] // tiles
    ctas = min(tiles, math.ceil(math.sqrt(tiles)))
    dev = pri.device

    def scratch(entries):
        return (torch.empty(entries, dtype=pri.dtype, device=dev),
                torch.empty(entries, dtype=torch.int32, device=dev))

    part_pri, part_idx = scratch(ctas * ws_size)
    gbuf_pri = gbuf_idx = None
    if ws_size > MERGE_SMEM_K:
        gbuf_pri, gbuf_idx = scratch(3 * ctas * ws_size)
    counter = torch.zeros(1, dtype=torch.int32, device=dev)
    ws = torch.empty(ws_size, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pri.data_ptr(), cand_idx.data_ptr(), part_pri.data_ptr(),
                part_idx.data_ptr(),
                None if gbuf_pri is None else gbuf_pri.data_ptr(),
                None if gbuf_idx is None else gbuf_idx.data_ptr(),
                counter.data_ptr(), ws.data_ptr(), p, bp, kc, ws_size, ctas,
                stream)
    _check_rc(rc, "merge")
    return ws


def fused_ws_cuda(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                  ws_size, *, use_fp=False, bp=None):
    """Launch K3 (the score, select and merge launches) on the tensors'
    stream; Xt is contiguous [p, n]. Returns (scores, grad, cand_idx, ws):
    no candidate rows are copied."""
    bp, _, kc = _tiling(Xt.shape[0], ws_size, bp)
    scores, grad, pri = score_cuda(Xt, r, beta, L, offset, penalty_cls,
                                   params, gsupp=gsupp, use_fp=use_fp)
    cand_idx = select_cuda(pri, bp, kc)
    return scores, grad, cand_idx, merge_cuda(pri, cand_idx, bp, ws_size)


class ProductTile(NamedTuple):
    """The CTA tile of a float64 product kernel (``csrc/fused_ws.cu``: the
    narrow ``block_mma_kernel``'s ``kMma*`` constants, the wide
    ``wide_mma_kernel``'s ``kWide*``): features, the most columns and the
    samples of a shared-memory stage. Its shared memory and occupancy are
    the card's answers (``fused_ws_product_info``)."""
    name: str
    bm: int
    bn: int
    bk: int


NARROW = ProductTile("narrow", 64, MMA_TASKS, 32)
WIDE = ProductTile("wide", 64, 128, 16)
# float64 tensor-core peak and HBM rate of the H100 SXM (data sheet); the
# most sample spans, and the fewest stages a span beyond the first
F64_OPS_PER_S = 67e12
HBM_BYTES_PER_S = 3.35e12
MAX_SPANS = 16
MIN_SPAN_STAGES = 8


class ProductPlan(NamedTuple):
    """One launch of the float64 product: ``grid (col_tiles, feat_tiles,
    spans)`` of the narrow or wide kernel, column tile ``bn``, ``span``
    samples a span; the scratch ``[spans, p, ld]`` holds ``scratch``
    entries."""
    wide: bool
    bn: int
    col_tiles: int
    feat_tiles: int
    spans: int
    span: int
    ld: int
    scratch: int

    @property
    def tile(self) -> ProductTile:
        return WIDE if self.wide else NARROW

    @property
    def name(self) -> str:
        return self.tile.name

    @property
    def ctas(self) -> int:
        return self.col_tiles * self.feat_tiles * self.spans


def _cdiv(a, b):
    return -(-a // b)


def _spans(n, p, ld, tiles, slots, c, bn):
    """The sample spans (1 to MAX_SPANS, MIN_SPAN_STAGES stages of bk
    samples a span or more beyond one) that minimize the modelled time,
    the fewest among equal times: the waves of CTAs over the card's
    `slots`, times the stages a span, times a stage's bm bn bk
    multiply-adds at the float64 peak shared by the slots; plus the
    scratch each span adds, written once and read once by the reduce."""
    step = 2 * c.bm * bn * c.bk * slots / F64_OPS_PER_S
    best, best_t = 1, math.inf
    for s in range(1, MAX_SPANS + 1):
        if s > 1 and s * MIN_SPAN_STAGES * c.bk > n:
            break
        stages = _cdiv(_cdiv(n, s), c.bk)
        t = (_cdiv(tiles * s, slots) * stages * step
              + s * 16 * p * ld / HBM_BYTES_PER_S)
        if t < best_t * (1 - 1e-9):
            best, best_t = s, t
    return best


def product_plan(n, p, N, *, slots) -> ProductPlan:
    """The launch of the float64 product Xt [p, n] @ R [n, N], one launch
    at every N: the narrow kernel for N <= MMA_TASKS and the wide one above
    (K3b, K3l and K3bl alike: at N <= 24 the narrow kernel is the faster,
    PERF.md section 6), the wide column tile (the fewest tiles of at most
    128 columns, the width of each rounded up to 8), the sample spans
    (``_spans`` on the card's `slots`: its SMs times the kernel's resident
    CTAs an SM) and the scratch."""
    wide = N > MMA_TASKS
    c = WIDE if wide else NARROW
    if wide:
        bn = 8 * _cdiv(_cdiv(N, _cdiv(N, c.bn)), 8)
        ld, col_tiles = N, _cdiv(N, bn)
    else:
        bn, ld, col_tiles = MMA_TASKS, MMA_TASKS, 1
    feat_tiles = _cdiv(p, c.bm)
    spans = _spans(n, p, ld, col_tiles * feat_tiles, slots, c, bn)
    span = _cdiv(_cdiv(n, spans), c.bk) * c.bk
    return ProductPlan(wide, bn, col_tiles, feat_tiles, spans, span, ld,
                       spans * p * ld)


_SLOTS: dict = {}
_PLANS: dict = {}


def _card_slots(dev, wide):
    """CTAs of the narrow or wide product kernel that `dev` runs at once:
    its SMs times the kernel's resident CTAs an SM (the card's occupancy
    query), cached."""
    key = (dev, bool(wide))
    if key not in _SLOTS:
        lib = BUILD.lib("fused_ws")
        with torch.cuda.device(dev):
            per_sm = lib.fused_ws_product_info(int(wide), 1)
        if per_sm < 1:
            raise RuntimeError("fused_ws: the card did not report the "
                               "occupancy of the float64 product")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        _SLOTS[key] = sms * per_sm
    return _SLOTS[key]


def card_product_plan(Xt, N):
    """``product_plan`` for Xt [p, n] at N columns on Xt's card, cached by
    (device, n, p, N)."""
    p, n = Xt.shape
    key = (Xt.device, n, p, N)
    if key not in _PLANS:
        _PLANS[key] = product_plan(
            n, p, N, slots=_card_slots(Xt.device, N > MMA_TASKS))
    return _PLANS[key]


def dmma_rate_cuda(mma, threads, ctas, iters, device):
    """Launch the float64 tensor cores' rate probe (``csrc/fused_ws.cu``:
    ``dmma_rate_kernel``): `ctas` CTAs of `threads` threads, each warp
    `iters` rounds of 8 independent MMAs of shape `mma` from registers (no
    loads): 2 * 8 * iters * m n k * warps operations, the rate the wide
    product's loads stand between it and."""
    shapes = ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16")
    out = torch.empty(ctas * threads, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = BUILD.lib("fused_ws").dmma_rate_probe(
            shapes.index(mma), threads, ctas, iters, out.data_ptr(), stream)
    _check_rc(rc, "dmma_rate_probe")
    return out


def product_cuda(Xt, R, plan):
    """Launch the float64 product alone on the tensors' stream: the
    scratch [spans, p, ld] of `plan` (its spans' partial products; summed
    over the spans it is Xt @ R in the first N of its ld columns)."""
    p, n = Xt.shape
    N = R.shape[1]
    part = torch.empty((plan.spans, p, plan.ld), dtype=Xt.dtype,
                       device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = BUILD.lib("fused_ws").fused_ws_product_f64(
            Xt.data_ptr(), R.data_ptr(), part.data_ptr(), n, p, N,
            *_plan_args(plan), stream)
    _check_rc(rc, "fused_ws_product")
    return part


def _plan_args(plan):
    """The plan's fields in the C launchers' order (wide, bn, spans,
    span); zeros where there is none (float32)."""
    return (0, 0, 0, 0) if plan is None else (int(plan.wide), plan.bn,
                                              plan.spans, plan.span)


def fused_ws_block_cuda(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                        ws_size, *, use_fp=False, bp=None):
    """Launch K3b on the tensors' stream; Xt is contiguous [p, n], R and
    beta are contiguous [n, T] and [p, T]. Returns (scores, grad,
    cand_idx): no candidate rows are copied."""
    fn = getattr(BUILD.lib("fused_ws"), f"fused_ws_block_{_suffix(Xt)}")
    p, n = Xt.shape
    T = R.shape[1]
    bp, tiles, kc = _tiling(p, ws_size, bp)
    pid, prm = kernel_params(penalty_cls, params, Xt.device)
    scores, pri = torch.empty_like(L), torch.empty_like(L)
    grad = torch.empty_like(beta)
    cand_idx = torch.empty(tiles * kc, dtype=torch.int32, device=Xt.device)
    # float64: the product's launch and the partial products of its spans
    # (float32 runs the scalar product: no plan, no scratch)
    plan = card_product_plan(Xt, T) if Xt.dtype == torch.float64 else None
    part = torch.empty(plan.scratch if plan else 1, dtype=Xt.dtype,
                       device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = fn(Xt.data_ptr(), R.data_ptr(), beta.data_ptr(), L.data_ptr(),
                offset.data_ptr(), gsupp.data_ptr(), scores.data_ptr(),
                grad.data_ptr(), pri.data_ptr(), cand_idx.data_ptr(),
                part.data_ptr(), *_plan_args(plan), n, p, T, bp, kc, pid,
                int(bool(use_fp)), prm.data_ptr(), stream)
    _check_rc(rc, "fused_ws_block")
    return scores, grad, cand_idx


def fused_ws_lanes_cuda(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                        ws_size, *, use_fp=False, bp=None):
    """Launch K3l on the tensors' stream (float64): Xt contiguous [p, n],
    R contiguous [n, S], beta and gsupp contiguous [S, p], L [S, p] with a
    lane stride of p or 0, params [S, arity] on the card. Returns (scores,
    grad, cand_idx [S, tiles * kc], ws [S, ws_size]): no candidate rows
    are copied."""
    if Xt.dtype != torch.float64:
        raise TypeError("fused_ws_lanes: the card runs it in float64 only "
                        "(its product is the float64 tensor-core launch)")
    lib = BUILD.lib("fused_ws")
    p, n = Xt.shape
    S = R.shape[1]
    bp, tiles, kc = _tiling(p, ws_size, bp)
    pid, prm = kernel_params(penalty_cls, params, Xt.device, lanes=S)
    scores, grad, pri = (torch.empty_like(beta) for _ in range(3))
    cand_idx = torch.empty((S, tiles * kc), dtype=torch.int32,
                           device=Xt.device)
    plan = card_product_plan(Xt, S)
    part = torch.empty(plan.scratch, dtype=Xt.dtype, device=Xt.device)
    gs = gsupp.to(torch.uint8)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = lib.fused_ws_lanes_f64(
            Xt.data_ptr(), R.data_ptr(), beta.data_ptr(), L.data_ptr(),
            L.stride(0), offset.data_ptr(), gs.data_ptr(), scores.data_ptr(),
            grad.data_ptr(), pri.data_ptr(), cand_idx.data_ptr(),
            part.data_ptr(), *_plan_args(plan), n, p, S, bp, kc, pid,
            int(bool(use_fp)), prm.data_ptr(), prm.shape[1], stream)
    _check_rc(rc, "fused_ws_lanes")
    return scores, grad, cand_idx, merge_lanes_cuda(pri, cand_idx, bp,
                                                    ws_size)


def fused_ws_block_lanes_cuda(Xt, R, beta, L, offset, gsupp, penalty_cls,
                              params, ws_size, *, use_fp=False, bp=None):
    """Launch K3bl on the tensors' stream (float64): Xt contiguous [p, n],
    R contiguous [n, S*T] (lane-major), beta contiguous [S, p, T], gsupp
    contiguous [S, p], L [S, p] with a lane stride of p or 0, params
    [S, arity] on the card. Returns (scores [S, p], grad [S, p, T],
    cand_idx [S, tiles * kc], ws [S, ws_size]): no candidate rows are
    copied."""
    if Xt.dtype != torch.float64:
        raise TypeError("fused_ws_block_lanes: the card runs it in float64 "
                        "only (its product is the float64 tensor-core "
                        "launch)")
    lib = BUILD.lib("fused_ws")
    p, n = Xt.shape
    S, _, T = beta.shape
    bp, tiles, kc = _tiling(p, ws_size, bp)
    pid, prm = kernel_params(penalty_cls, params, Xt.device, lanes=S)
    scores, pri = (torch.empty((S, p), dtype=Xt.dtype, device=Xt.device)
                   for _ in range(2))
    grad = torch.empty_like(beta)
    cand_idx = torch.empty((S, tiles * kc), dtype=torch.int32,
                           device=Xt.device)
    # one product launch over the S*T columns, its scratch [spans, p, ld]
    plan = card_product_plan(Xt, S * T)
    part = torch.empty(plan.scratch, dtype=Xt.dtype, device=Xt.device)
    gs = gsupp.to(torch.uint8)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = lib.fused_ws_block_lanes_f64(
            Xt.data_ptr(), R.data_ptr(), beta.data_ptr(), L.data_ptr(),
            L.stride(0), offset.data_ptr(), gs.data_ptr(), scores.data_ptr(),
            grad.data_ptr(), pri.data_ptr(), cand_idx.data_ptr(),
            part.data_ptr(), *_plan_args(plan), n, p, S, T, bp, kc,
            pid, int(bool(use_fp)), prm.data_ptr(), prm.shape[1], stream)
    _check_rc(rc, "fused_ws_block_lanes")
    return scores, grad, cand_idx, merge_lanes_cuda(pri, cand_idx, bp,
                                                    ws_size)


def merge_lanes_cuda(pri, cand_idx, bp, ws_size):
    """K3's merge launch with a lane index on its grid: each lane's working
    set from its priorities pri [S, p] and tiles' lists cand_idx [S, C]
    (int64 [S, ws_size])."""
    fn = getattr(BUILD.lib("fused_ws"), f"merge_lanes_{_suffix(pri)}")
    S, p = pri.shape
    tiles = -(-p // bp)
    kc = cand_idx.shape[1] // tiles
    ctas = min(tiles, math.ceil(math.sqrt(tiles)))
    dev = pri.device

    def scratch(entries):
        return (torch.empty(S * entries, dtype=pri.dtype, device=dev),
                torch.empty(S * entries, dtype=torch.int32, device=dev))

    part_pri, part_idx = scratch(ctas * ws_size)
    gbuf_pri = gbuf_idx = None
    if ws_size > MERGE_SMEM_K:
        gbuf_pri, gbuf_idx = scratch(3 * ctas * ws_size)
    counter = torch.zeros(S, dtype=torch.int32, device=dev)
    ws = torch.empty((S, ws_size), dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(pri.data_ptr(), cand_idx.data_ptr(), part_pri.data_ptr(),
                part_idx.data_ptr(),
                None if gbuf_pri is None else gbuf_pri.data_ptr(),
                None if gbuf_idx is None else gbuf_idx.data_ptr(),
                counter.data_ptr(), ws.data_ptr(), p, bp, kc, ws_size, ctas,
                S, stream)
    _check_rc(rc, "merge_lanes")
    return ws


def slot_map(ws, p):
    """K3g's map of slots: pos [p, S] int32, pos[j, s] = k where lane s
    selected feature j at slot k (ws[s, k] = j), else -1."""
    S, K = ws.shape
    pos = torch.full((p, S), -1, dtype=torch.int32, device=ws.device)
    lanes = torch.arange(S, device=ws.device)[:, None].expand(S, K)
    slots = torch.arange(K, dtype=torch.int32, device=ws.device)
    pos[ws, lanes] = slots.expand(S, K)
    return pos


def ws_gather_plain(Xt, ws):
    """K3g's plain version, the kernel's copy in torch: for each feature
    any lane selected (a row of ``slot_map`` with a slot), its row of Xt
    [p, n] written to every slot (s, pos[j, s]). Returns (Xt_ws [S, K, n],
    U, the distinct rows read); Xt_ws equals ``Xt.index_select(0,
    ws.reshape(-1))`` viewed [S, K, n]."""
    S, K = ws.shape
    pos = slot_map(ws, Xt.shape[0])
    rows = torch.nonzero(torch.any(pos >= 0, dim=1)).reshape(-1)
    out = torch.empty((S, K, Xt.shape[1]), dtype=Xt.dtype, device=Xt.device)
    sel = pos[rows]
    for s in range(S):
        hit = sel[:, s] >= 0
        out[s, sel[hit, s].long()] = Xt[rows[hit]]
    return out, int(rows.shape[0])


def gather_bytes(S, K, n, U, itemsize=8):
    """The bytes K3g must move: U distinct rows of n values read and S K
    written (an ``index_select`` of the S K rows reads S K rows, not U)."""
    return (U + S * K) * n * itemsize


def ws_gather_cuda(Xt, ws, rows_read=None):
    """Launch K3g on Xt's stream (float64): Xt contiguous [p, n], ws
    contiguous int64 [S, K] (each lane's K distinct features). Returns
    Xt_ws [S, K, n]; `rows_read` (a 0-d int64 tensor on the card, or None)
    gains the distinct rows read."""
    if Xt.dtype != torch.float64:
        raise TypeError("ws_gather: the card runs it in float64 only")
    p, n = Xt.shape
    S, K = ws.shape
    pos = torch.empty((p, S), dtype=torch.int32, device=Xt.device)
    out = torch.empty((S, K, n), dtype=Xt.dtype, device=Xt.device)
    with torch.cuda.device(Xt.device):
        stream = torch.cuda.current_stream(Xt.device).cuda_stream
        rc = BUILD.lib("fused_ws").ws_gather_f64(
            Xt.data_ptr(), ws.data_ptr(), pos.data_ptr(), out.data_ptr(), n,
            p, S, K, None if rows_read is None else rows_read.data_ptr(),
            stream)
    _check_rc(rc, "ws_gather")
    return out
