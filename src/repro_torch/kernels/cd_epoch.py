"""K1, K1b and K2: the CD-epoch kernels (``csrc/cd_epoch.cu``), their CUDA
launchers and their plain torch versions.

K1 (``cd_epoch_gram``) replaces ``repro/kernels/cd_epoch.py:
cd_epoch_gram_pallas``; K2 (``cd_epoch_xb``) replaces
``cd_epoch_xb_pallas``. K1b (``cd_epoch_gram_block``) is the block form of
K1 for multitask coefficients beta [K, T] with a block penalty; the TPU has
no kernel for it (the reference runs its jax epoch
``repro/core/cd.py:cd_epoch_gram`` there). The plain versions run the same
epochs through ``kernels/ref.py`` (``cd_epoch_gram_plain`` covers both
forms) and are what the CPU takes; the public, checked and counted
wrappers are in ``kernels/ops.py``.

K1 runs a blocked chain (a chain warp over blocks of 32 coordinates; the
previous block's deltas applied to the other rows beside it) on one CTA at
small K and on a thread-block cluster above, K2 on a thread-block cluster
of C CTAs that split the epoch state, K1b on one CTA at small shapes (a
chain warp over the rows, q's entries in owner threads' registers, the
next row handed over on named barriers) and on a cluster above them
(``csrc/cd_epoch.cu`` describes the designs; ``emulate_block_epoch`` is
the one-CTA kernel's arithmetic in torch, which it equals bit for bit).
``gram_plan``, ``xb_plan`` and ``gram_block_plan`` are the one place
that chooses a call's launch layout, from its shape alone: the cluster size C, the threads, whether the
state lives in shared or in global memory (K1's always in shared memory),
the dynamic shared memory per CTA and the register path. The wrappers hand the plan to the C
launchers as ints; a launch that the card refuses raises, and nothing
retries on another layout.

K1l and K2l (``cd_epoch_gram_lanes``, ``cd_epoch_xb_lanes``) are K1 and
K2 over a lane dimension, the counterpart of ``pallas_call`` under the
reference's ``vmap`` (the chunked driver and the CV grid): one launch runs
S independent epochs, each lane on its own tensors and its own row of the
codec vector, as a grid of S CTAs or S clusters. K2l's clusters take the
lane plan ``xb_lanes_plan`` (the fewest waves, then the fewest CTAs on
an SM, then the largest cluster whose slice keeps shared memory); K1l's
take
``gram_lanes_plan``, the cluster size that runs the S lanes in the fewest
waves on the card (one, where one fits).
An active-lane mask freezes lanes: a frozen K1l lane runs zero epochs,
which copies its state through; a frozen K2l lane copies it and returns
at entry. K1bl (``cd_epoch_gram_block_lanes``) is
K1b over lanes of multitask blocks (c, beta, q [S, K, T]), each lane on K1b's
plan of one lane (``gram_block_plan(K, T)``); a frozen lane runs zero
epochs, which copies its state through. Their plain versions apply the
single-lane plain version lane by lane, skipping the frozen lanes.

A plan's cluster must be one the card can place: 16 CTAs is beyond the
portable 8, and a MIG slice or a GPC with SMs taken may not hold it. Each
plan function asks a placement test (by default ``card_placeable``, the
card's own answer through ``cudaOccupancyMaxActiveClusters`` for that
kernel, cluster size, threads and shared memory, cached) and steps down
16 -> 8 -> 4 -> 2 -> one CTA until the test passes, laying the state out
again by the same rules at each size. A forced ``cluster=`` is taken as
given.
"""
from __future__ import annotations

import ctypes
from contextlib import contextmanager
from typing import NamedTuple

import torch

from ..core.datafits import Logistic, Quadratic, QuadraticSVC
from ..core.penalties import MCP as _MCP
from ._build import BUILD
from .common import PENALTY_IDS, make_penalty, penalty_arity
from .ref import cd_epoch_gram_ref, cd_epoch_xb_ref

__all__ = ["KIND_IDS", "cd_epoch_gram_plain", "cd_epoch_xb_plain",
           "cd_epoch_gram_cuda", "cd_epoch_gram_block_cuda",
           "cd_epoch_xb_cuda", "cd_epoch_gram_lanes_plain",
           "cd_epoch_xb_lanes_plain", "cd_epoch_gram_lanes_cuda",
           "cd_epoch_xb_lanes_cuda", "cd_epoch_gram_block_lanes_plain",
           "cd_epoch_gram_block_lanes_cuda", "emulate_block_epoch",
           "kernel_params", "EpochPlan",
           "GramPlan",
           "gram_plan", "gram_lanes_plan", "xb_plan", "xb_lanes_plan",
           "gram_block_plan", "BRANCHES",
           "SMEM_DYN_MAX", "cluster_barrier_cuda", "gram_chain_floor_cuda",
           "gram_block_chain_floor_cuda",
           "fill_shared_memory_cuda", "card_placeable", "card_capacity",
           "lane_capacity",
           "placement", "gram_kernel_attrs_cuda", "STEP_DOWN"]

# dynamic shared memory a CTA may take: the H100's 232,448 bytes per CTA
# less 1 KB for the kernels' few static shared values
SMEM_DYN_MAX = 232_448 - 1024
# the cluster size, and the largest K1b shape that keeps one CTA: all the
# one-CTA kernel's registers hold (GRAM_BLOCK_PER entries on each of
# GRAM_BLOCK_MAX_THREADS - 32 owners), where it ran 1.9-2.8x faster than
# the better cluster at every K T measured, up to 5880 (`cd_sweep.py k1b`
# on the H100; the numbers are in PERF.md). 16 CTAs is beyond the portable
# 8: the plans step down where the card cannot place them (STEP_DOWN), and
# the launcher still refuses a cluster no GPC can place.
CLUSTER = 16
# K1b on one CTA (csrc/cd_epoch.cu: kBlockPer, kBlockChain, kBlockRing,
# kBlockSlots, which the kernel alone sets): the entries of q an owner
# thread keeps in registers, on at most GRAM_BLOCK_MAX_THREADS threads
# (the register path's launch bounds); the most tasks T (the chain warp's
# lanes hold a row's entries t = l + 32 m, m < 2); the columns of G's ring
# where G is not staged whole; the steps whose deltas are kept. The fewest
# threads a CTA (the chain warp and the owners; `cd_sweep.py k1b`: the
# fewest that hold q were within 2% of the fastest count at every shape).
GRAM_BLOCK_PER = 8
GRAM_BLOCK_MAX_THREADS = 768
GRAM_BLOCK_CHAIN_T = 64
GRAM_BLOCK_RING = 5
GRAM_BLOCK_SLOTS = 3
GRAM_BLOCK_MIN_THREADS = 256
GRAM_BLOCK_SINGLE_MAX_KT = GRAM_BLOCK_PER * (GRAM_BLOCK_MAX_THREADS - 32)
# values a thread keeps in registers on the register paths (K2's samples,
# K1b's q entries), which the kernels run on at most PER_THREADS threads
XB_PER, GRAM_PER, PER_THREADS = 2, 8, 768
# K2's samples a thread past the register path (its threads, and so the
# warp sums a coordinate reads, stay fewer there)
XB_GLOBAL_PER = 4
# K1: coordinates a block (the chain warp's lanes: csrc/cd_epoch.cu's
# kGramB, which the kernel alone sets); the head of its dynamic shared
# memory in values (tiles [2][2][32][32], staged c, L, step, beta [4][2][32],
# deltas by lane and compacted [2][3][32], the chain block's q rows [2][32];
# kGramHead); the most threads a CTA (each update thread holds a row's 32
# loads of G in registers); the cluster size and the largest K that keeps
# one CTA (measured on the H100 by `cd_sweep.py`; the numbers are in
# PERF.md)
GRAM_B = 32
GRAM_HEAD = 4 * GRAM_B * GRAM_B + 16 * GRAM_B
GRAM_MAX_THREADS = 512
GRAM_CLUSTER = 16
GRAM_SINGLE_MAX_K = 256
# a K1 CTA, on one CTA or in the cluster, runs at least this many threads:
# with fewer, the warps that stage each block's tiles (one CTA) or apply
# the deltas to an update CTA's rows fall behind the chain (`cd_sweep.py`:
# 128 threads cost 28% more at K = 256 on one CTA, 44% more at K = 2048 on
# the cluster; 512 gain nothing below K = 4096; PERF.md)
GRAM_MIN_THREADS = 256
BRANCHES = ("single", "cluster-shared", "cluster-global")
_ERR_CLUSTER_UNPLACEABLE = -1
# the cluster sizes a plan steps down through while the card cannot place
# its cluster (8 is the portable size, 1 one CTA)
STEP_DOWN = (16, 8, 4, 2, 1)
# kernel name -> csrc/cd_epoch.cu cluster_capacity's kernel id
_CAPACITY_IDS = {"cd_epoch_gram": 0, "cd_epoch_xb": 1,
                 "cd_epoch_gram_block": 2, "cd_epoch_gram_lanes": 3}
_CAPACITY: dict = {}


def card_capacity(kernel: str, plan, dtype, pen: int = 0,
                  device=None) -> int:
    """How many clusters of `plan` for `kernel` ("cd_epoch_gram",
    "cd_epoch_xb", "cd_epoch_gram_block" or "cd_epoch_gram_lanes") the
    card of `device` (default: the current one) places at once, as
    ``cudaOccupancyMaxActiveClusters`` answers for the instance that
    launches (K1's and K1l's of penalty id `pen`) with the plan's cluster
    size, threads and dynamic shared memory; cached per (device, kernel,
    dtype, shape, penalty). Without a card there is nothing to ask: 0."""
    if not torch.cuda.is_available():
        return 0
    dev = None if device is None else torch.device(device).index
    dev = torch.cuda.current_device() if dev is None else dev
    per = getattr(plan, "per", 0)
    key = (dev, kernel, dtype, plan.cluster, plan.threads, plan.dyn_bytes,
           per, pen)
    if key not in _CAPACITY:
        active = ctypes.c_int(0)
        with torch.cuda.device(dev):
            rc = BUILD.lib("cd_epoch").cluster_capacity(
                _CAPACITY_IDS[kernel], int(dtype == torch.float64), per, pen,
                plan.cluster, plan.threads, plan.dyn_bytes,
                ctypes.byref(active))
        _check_rc(rc, f"{kernel} placement query", plan)
        _CAPACITY[key] = active.value
    return _CAPACITY[key]


def card_placeable(kernel: str, plan, dtype) -> bool:
    """Whether the current card places one cluster of `plan` for `kernel`
    (``card_capacity`` at least 1; K1's L1 instance). One CTA always
    places. Without a card every plan passes: no launch follows on this
    host."""
    if plan.cluster == 1 or not torch.cuda.is_available():
        return True
    return card_capacity(kernel, plan, dtype) >= 1


_PLACEMENT = [card_placeable]


@contextmanager
def placement(test):
    """Within: `test(kernel, plan, dtype) -> bool` is the plans' default
    placement test instead of the card's (a check can refuse a cluster size
    the card would place, to drive the step-down)."""
    _PLACEMENT.append(test)
    try:
        yield test
    finally:
        _PLACEMENT.pop()


def _step_down(kernel, first, dtype, layout, placeable, last=1):
    """The first layout(C) from cluster size `first` down through
    STEP_DOWN to `last` whose shared memory a CTA can hold and that the
    placement test accepts."""
    test = _PLACEMENT[-1] if placeable is None else placeable
    for C in (first,) + tuple(c for c in STEP_DOWN if last <= c < first):
        plan = layout(C)
        if plan.dyn_bytes <= SMEM_DYN_MAX and test(kernel, plan, dtype):
            return plan
    raise RuntimeError(f"{kernel}: no cluster size of {STEP_DOWN} that the "
                       f"card places holds the state")


class EpochPlan(NamedTuple):
    """How one K2 or K1b launch runs: ``cluster`` CTAs (1: K1b's one-CTA
    kernel), the state's slices in shared memory (``smem``) or in global
    memory, ``dyn_bytes`` of dynamic shared memory, ``threads`` per CTA and
    ``per`` values a thread keeps in registers (0: no register path). On
    K1b's one CTA, ``smem`` says whether beta and c are staged in shared
    memory, ``per`` whether ``owners`` threads hold q's entries in
    registers (GRAM_BLOCK_PER each) or in shared memory (0), and
    ``g_whole`` whether G is staged whole or through a ring of columns."""
    cluster: int
    smem: bool
    dyn_bytes: int
    threads: int
    per: int
    owners: int = 0
    g_whole: bool = False

    @property
    def branch(self) -> str:
        if self.cluster == 1:
            return "single"
        return "cluster-shared" if self.smem else "cluster-global"


class GramPlan(NamedTuple):
    """How one K1 launch runs: on one CTA (``cluster`` = 1: the chain warp
    and update warps, q and beta in shared memory) or on a cluster of
    ``cluster`` CTAs (rank 0 the chain, the others q's rows in their shared
    memory), ``threads`` a CTA, ``dyn_bytes`` of dynamic shared memory a
    CTA."""
    cluster: int
    dyn_bytes: int
    threads: int

    @property
    def branch(self) -> str:
        return "single" if self.cluster == 1 else "cluster-shared"


def gram_plan(K: int, dtype, cluster: int | None = None,
              threads: int | None = None, placeable=None) -> GramPlan:
    """K1's layout for K coordinates in blocks of GRAM_B: one CTA for
    K <= GRAM_SINGLE_MAX_K, holding q and beta (2 K values) beside the head
    in shared memory; above, a cluster of GRAM_CLUSTER CTAs whose C - 1
    update CTAs hold ceil(nb / (C - 1)) blocks of q's rows each. One thread
    a row (one warp a block on one CTA, beside the chain warp),
    GRAM_MIN_THREADS to GRAM_MAX_THREADS. `cluster` and `threads` force a
    size (``cd_sweep.py`` times them to set GRAM_SINGLE_MAX_K and
    GRAM_MIN_THREADS); a cluster needs K > 2 GRAM_B. Unforced, the
    cluster steps down while `placeable` (default: the card's answer,
    ``card_placeable``) refuses it. Raises ValueError where the state does
    not fit a CTA's shared memory (past ~360k float64 coordinates on the
    cluster, where G alone would take ~1 PB)."""
    if cluster is None:
        first = 1 if K <= GRAM_SINGLE_MAX_K else GRAM_CLUSTER
        return _step_down("cd_epoch_gram", first, dtype,
                          lambda C: gram_plan(K, dtype, C, threads),
                          placeable)
    item = dtype.itemsize
    if cluster == 1:
        state, rows = 2 * K, GRAM_B + K
    else:
        nb = -(-K // GRAM_B)
        state = rows = -(-nb // (cluster - 1)) * GRAM_B
    dyn = (GRAM_HEAD + state) * item
    if dyn > SMEM_DYN_MAX:
        raise ValueError(f"cd_epoch_gram: K = {K} needs {dyn} bytes of shared "
                         f"memory a CTA on {cluster} CTA(s); a CTA has "
                         f"{SMEM_DYN_MAX}")
    if threads is None:
        threads = min(GRAM_MAX_THREADS, max(GRAM_MIN_THREADS, _threads(rows)))
    return GramPlan(cluster, dyn, threads)


def lane_capacity(plan, dtype, pen: int = 0, device=None,
                  kernel: str = "cd_epoch_gram_lanes"):
    """The card of `device` for a lane kernel's `plan` (K1l's, or with
    `kernel` "cd_epoch_xb" K2l's, which is K2's kernel): (how many of its
    clusters the card places at once, ``card_capacity`` of that instance
    (K1l's for penalty id `pen`), several CTAs sharing an SM where they
    fit; the SMs they share). (0, 0) without a card."""
    n = card_capacity(kernel, plan, dtype, pen, device)
    if not n:
        return 0, 0
    dev = torch.device("cuda") if device is None else torch.device(device)
    return n, torch.cuda.get_device_properties(dev).multi_processor_count


def gram_lanes_plan(S: int, K: int, dtype, pen: int = 0, device=None,
                    capacity=None) -> GramPlan:
    """K1l's layout for S lanes of K coordinates on the card of `device`,
    each lane on K1's layout of one cluster size (``gram_plan(K, dtype,
    cluster=C)``): one CTA a lane for K <= GRAM_SINGLE_MAX_K; above, of
    the cluster sizes of STEP_DOWN, the one that runs the S lanes in the
    fewest waves as the card places the clusters (``lane_capacity`` for
    K1l's instance of penalty id `pen`; `capacity(plan, dtype, pen)`
    stands in for it in the tests); of those, the fewest threads a CTA (a
    lane's rows on more update CTAs, which pack two to an SM at
    GRAM_MIN_THREADS); of those, the fewest CTAs on an SM in a wave; of
    those, the largest. ``cd_sweep.py k1l_rule`` times every size against
    it (PERF.md). Where the card runs no cluster at all (capacity 0, as
    without a card), K1's own plan, ``gram_plan(K, dtype)``. Raises
    ValueError where no cluster size holds a lane's state."""
    if K > GRAM_SINGLE_MAX_K:
        best = None
        for C in STEP_DOWN[:-1]:
            try:
                plan = gram_plan(K, dtype, cluster=C)
            except ValueError:      # a smaller cluster holds more rows a CTA
                break
            n, sms = lane_capacity(plan, dtype, pen, device) \
                if capacity is None else capacity(plan, dtype, pen)
            if n >= 1:
                key = (-(-S // n), plan.threads, -(-min(S, n) * C // sms))
                if best is None or key < best[0]:
                    best = (key, plan)
        if best is not None:
            return best[1]
    return gram_plan(K, dtype)


def _threads(m: int) -> int:
    """Warps enough for m values, 1 to 32 of them."""
    return min(1024, max(32, -(-m // 32) * 32))


def xb_plan(n: int, weighted: bool, dtype, cluster: int | None = None,
            placeable=None) -> EpochPlan:
    """K2's layout for n samples: each of `cluster` CTAs (CLUSTER unless
    forced, stepping down while `placeable` refuses it) holds the slots of
    the cluster's warp sums (2 C warps values) and a slice of ceil(n / C)
    samples of Xb, the raw gradient, y (and w), in shared memory while they
    fit, and takes XB_PER samples a thread in registers where PER_THREADS
    threads hold the slice, else about XB_GLOBAL_PER from memory.
    (``cd_sweep.py k2``: 2 samples a thread ran K2 at (512, 10,000) 12%
    faster than 4, whose axpy serialized each thread's exps, PERF.md.)"""
    if cluster is None:
        return _step_down("cd_epoch_xb", CLUSTER, dtype,
                          lambda C: xb_plan(n, weighted, dtype, C),
                          placeable)
    m = -(-n // cluster)
    threads, per = max(128, _threads(-(-m // XB_PER))), XB_PER
    if threads > PER_THREADS:
        threads, per = max(128, _threads(-(-m // XB_GLOBAL_PER))), 0
    # the head: the cluster's warp sums of a coordinate, by parity
    # (csrc/cd_epoch.cu: K2's slots [2][C][warps])
    head = 2 * cluster * (threads // 32) * dtype.itemsize
    state = m * dtype.itemsize * (4 if weighted else 3)
    smem = head + state <= SMEM_DYN_MAX
    return EpochPlan(cluster, smem, head + state if smem else head, threads,
                     per)


def xb_lanes_plan(S: int, n: int, weighted: bool, dtype, device=None,
                  capacity=None) -> EpochPlan:
    """K2l's layout for S lanes of n samples on the card of `device`, each
    lane on K2's layout of one cluster size (``xb_plan(n, weighted, dtype,
    cluster=C)``): of the sizes of STEP_DOWN whose slice fits the
    shared-memory branch, the one that runs the S lanes in the fewest
    waves as the card places the clusters (``lane_capacity`` of K2's
    instance; `capacity(plan, dtype)` -> (clusters at once, SMs) stands in
    for it in the tests); of those, the fewest CTAs on an SM in a wave
    (the axpy with its exp is the chain's longest step and runs on the
    SM's float64 units, which CTAs sharing an SM share); of those, the
    largest (a lane's samples over more SMs); of those, the fewest
    threads. ``cd_sweep.py k2l_rule`` times every size against it
    (PERF.md). Where no size qualifies (no card, or a slice past shared
    memory at every size), K2's own plan, ``xb_plan(n, weighted,
    dtype)``."""
    best = None
    for C in STEP_DOWN:
        plan = xb_plan(n, weighted, dtype, cluster=C)
        if not plan.smem:
            continue
        at_once, sms = lane_capacity(plan, dtype, 0, device, "cd_epoch_xb") \
            if capacity is None else capacity(plan, dtype)
        if at_once >= 1:
            share = -(-min(S, at_once) * C // sms)
            key = (-(-S // at_once), share, -C, plan.threads)
            if best is None or key < best[0]:
                best = (key, plan)
    return xb_plan(n, weighted, dtype) if best is None else best[1]


def _block_one_cta(K: int, T: int, dtype, threads: int | None) -> EpochPlan:
    """K1b's one-CTA layout (``csrc/cd_epoch.cu: cd_gram_block_kernel``):
    q's K T entries in registers, GRAM_BLOCK_PER an owner thread, where
    GRAM_BLOCK_MAX_THREADS threads hold them (else in shared memory, on
    1024 threads); `threads` (default: the chain warp and owners enough,
    at least GRAM_BLOCK_MIN_THREADS); the owners a multiple of T where
    that holds q (an owner's entries then
    share one task, one delta load a step); in shared memory the next rows
    [2][T], the deltas [3][T], L and step [K], then beta and c [K T] where
    they fit, then G whole where it fits (else a ring of GRAM_BLOCK_RING
    columns). Raises ValueError past GRAM_BLOCK_CHAIN_T tasks."""
    if T > GRAM_BLOCK_CHAIN_T:
        raise ValueError(f"cd_epoch_gram_block: one CTA runs at most "
                         f"{GRAM_BLOCK_CHAIN_T} tasks, got T = {T}")
    KT = K * T
    top = GRAM_BLOCK_MAX_THREADS
    per = GRAM_BLOCK_PER if KT <= GRAM_BLOCK_PER * (top - 32) else 0
    if threads is None:
        threads = 1024 if not per else min(top, max(
            GRAM_BLOCK_MIN_THREADS, 32 + _threads(-(-KT // per))))
    n = threads - 32
    owners = n - n % T if T <= n else n
    if per and (owners < 1 or KT > per * owners):
        owners = n
    if per and (KT > per * owners or threads > top):
        per = 0                 # forced threads off the register path
    head = (2 + GRAM_BLOCK_SLOTS) * T + 2 * K + (0 if per else KT)
    for bc, whole in ((True, True), (True, False), (False, False)):
        vals = head + (2 * KT if bc else 0) + \
            (K * K if whole else GRAM_BLOCK_RING * K)
        if vals * dtype.itemsize <= SMEM_DYN_MAX:
            break
    return EpochPlan(1, bc, vals * dtype.itemsize, threads, per, owners,
                     whole)


def gram_block_plan(K: int, T: int, dtype, cluster: int | None = None,
                    placeable=None, threads: int | None = None) -> EpochPlan:
    """K1b's layout for q [K, T]: one CTA (``_block_one_cta``) for T <=
    GRAM_BLOCK_CHAIN_T and K * T <= GRAM_BLOCK_SINGLE_MAX_KT where it holds
    the state on chip (q in registers, beta and c in shared memory); else a
    cluster of CLUSTER CTAs (stepping down while `placeable` refuses it),
    each holding the slots of 3 (T + 1) values and ceil(K / C) rows of q
    (in shared memory while they fit), about GRAM_PER entries a thread.
    `cluster` forces C (a forced single CTA may ask for more shared memory
    than a CTA has: the launch then fails), `threads` the one CTA's
    threads (``cd_sweep.py`` times them)."""
    if cluster is None:
        first = CLUSTER
        if T <= GRAM_BLOCK_CHAIN_T and K * T <= GRAM_BLOCK_SINGLE_MAX_KT:
            one = _block_one_cta(K, T, dtype, threads)
            if one.smem and one.per and one.dyn_bytes <= SMEM_DYN_MAX:
                first = 1
        return _step_down("cd_epoch_gram_block", first, dtype,
                          lambda C: gram_block_plan(K, T, dtype, C,
                                                    threads=threads),
                          placeable, 1 if T <= GRAM_BLOCK_CHAIN_T else 2)
    item = dtype.itemsize
    C = cluster
    if C == 1:
        return _block_one_cta(K, T, dtype, threads)
    rows = -(-K // C)
    head = 3 * (T + 1) * item
    state = rows * T * item
    smem = head + state <= SMEM_DYN_MAX
    threads = max(128, _threads(-(-rows * T // GRAM_PER)))
    return EpochPlan(C, smem, head + state if smem else head, threads,
                     GRAM_PER if threads <= PER_THREADS else 0)

# datafit kind -> the raw-gradient formula id of csrc/cd_epoch.cu
KIND_IDS = {"quadratic": 0, "logistic": 1, "svc": 2}
_KIND_DATAFITS = {"quadratic": Quadratic(), "logistic": Logistic(),
                  "svc": QuadraticSVC()}


def kernel_params(penalty_cls, params, device, lanes=None):
    """(penalty id, the codec vector): the C launchers take a pointer to
    the vector, which the kernels read at entry (a captured launch reads
    the values bound at each replay). The vector is ``(arity,)``, or with
    `lanes` ``(lanes, arity)`` (one row a lane), float64, and must lie on
    `device`, the kernel's tensors' device: a vector elsewhere raises
    (``penalty_params(pen, device)`` makes one there). The plain versions
    take a vector on any device."""
    arity = penalty_arity(penalty_cls)
    want = (arity,) if lanes is None else (lanes, arity)
    if params.dtype != torch.float64 or tuple(params.shape) != want:
        raise ValueError(f"{penalty_cls.__name__}: params must be a float64 "
                         f"tensor of shape {want}, got {params.dtype} "
                         f"{tuple(params.shape)}")
    if params.device != device:
        raise ValueError(f"{penalty_cls.__name__}: params must lie on the "
                         f"kernel's device {device}, got {params.device} "
                         f"(penalty_params(pen, device) makes it there)")
    return PENALTY_IDS[penalty_cls], params.contiguous()


def _suffix(t):
    return {torch.float64: "f64", torch.float32: "f32"}[t.dtype]


def _check_rc(rc, name, plan=None):
    if rc == _ERR_CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"{name}: no GPC of this card can place a cluster "
                           f"of {plan.cluster} CTAs with {plan.dyn_bytes} "
                           f"bytes of shared memory each")
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA kernel launch failed with "
                           f"cudaError {rc}"
                           + (f" ({plan})" if plan is not None else ""))


def cd_epoch_gram_plain(G, c, beta0, q0, L, penalty_cls, params, *,
                        epochs=1):
    return cd_epoch_gram_ref(G, c, beta0, q0, L,
                             make_penalty(penalty_cls, params), epochs)


def cd_epoch_xb_plain(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                      datafit_kind="quadratic", *, w=None, epochs=1):
    return cd_epoch_xb_ref(Xt_ws, y, beta0, Xb0, L, offset,
                           _KIND_DATAFITS[datafit_kind],
                           make_penalty(penalty_cls, params), epochs, w=w)


def cd_epoch_gram_lanes_plain(G, c, beta0, q0, L, penalty_cls, params,
                              active, *, epochs=1):
    """K1l's plain version: K1's plain epoch on each active lane s of G
    [S, K, K], c, beta0, q0, L [S, K] with params[s] (K1b's on block lanes
    c, beta0, q0 [S, K, T]); a frozen lane's beta and q come back
    unchanged."""
    beta, q = beta0.clone(), q0.clone()
    for s in range(G.shape[0]):
        if bool(active[s]):
            beta[s], q[s] = cd_epoch_gram_plain(G[s], c[s], beta0[s], q0[s],
                                                L[s], penalty_cls, params[s],
                                                epochs=epochs)
    return beta, q


# K1bl's plain version: K1l's on block lanes (c, beta0, q0 [S, K, T]),
# which runs K1b's plain epoch on each active lane
cd_epoch_gram_block_lanes_plain = cd_epoch_gram_lanes_plain


def _lane_norms(x):
    """The row norms of x [S, T] in the one-CTA kernel's order: lane l of
    a warp sums x_t^2 over t = l, l + 32, ... in ascending t from +0, then
    a shuffle-down tree adds lane l + o into lane l for o = 16, 8, 4, 2, 1;
    lane 0's sum, square-rooted."""
    S, T = x.shape
    m = -(-T // 32)
    xx = torch.zeros(S, m * 32, dtype=x.dtype, device=x.device)
    xx[:, :T] = x * x
    xx = xx.view(S, m, 32)
    part = torch.zeros(S, 32, dtype=x.dtype, device=x.device)
    for k in range(m):
        part = part + xx[:, k]
    for o in (16, 8, 4, 2, 1):
        part = torch.cat([part[:, :o] + part[:, o:2 * o], part[:, o:]], 1)
    return torch.sqrt(part[:, :1])


def emulate_block_epoch(G, c, beta0, q0, L, penalty_cls, params, *,
                        epochs=1, active=None):
    """K1b's and K1bl's one-CTA kernel in torch, in its arithmetic order:
    `epochs` cyclic passes; for each row j the row x = beta_j - (q_j - c_j)
    step_j (step = 1 / max(L_j, 1e-30)), its norm by ``_lane_norms``, the
    block prox of BlockL1 or BlockMCP on that norm (``rt::block_prox``),
    beta_j unchanged where L_j = 0, then q += G[:, j] (x) delta_j, one j at
    a time, skipped where every entry of delta_j is zero. G [S, K, K] (or
    [K, K]), c, beta0, q0 [S, K, T] (or [K, T]), L [S, K], params [S,
    arity] (or [arity]): the lanes run side by side; a lane with
    active[s] False comes back unchanged. Only the norm's order differs
    from ``cd_epoch_gram_plain``; on the card the kernel equals this bit for
    bit. Returns (beta, q)."""
    lanes = beta0.ndim == 3
    if not lanes:
        G, c, beta0, q0, L, params = (G[None], c[None], beta0[None],
                                      q0[None], L[None], params[None])
    S, K, T = beta0.shape
    on = torch.ones(S, dtype=torch.bool, device=beta0.device) \
        if active is None else active.to(beta0.device)
    prm = params.to(device=beta0.device, dtype=beta0.dtype)
    lam = prm[:, 0:1]
    mcp = None if penalty_cls.__name__ == "BlockL1" else \
        _MCP(lam, prm[:, 1:2])
    beta, q = beta0.clone(), q0.clone()
    step = 1.0 / torch.clamp(L, min=1e-30)
    for _ in range(epochs):
        for j in range(K):
            b, st = beta[:, j], step[:, j:j + 1]
            x = b - (q[:, j] - c[:, j]) * st
            nrm = _lane_norms(x)
            den = torch.clamp(nrm, min=1e-30)
            if mcp is None:
                nw = x * (torch.clamp(nrm - st * lam, min=0.0) / den)
            else:
                nw = x * mcp.prox(nrm, st) / den
            nw = torch.where(L[:, j:j + 1] > 0.0, nw, b)
            nw = torch.where(on[:, None], nw, b)
            d = nw - b
            beta[:, j] = nw
            nz = torch.any(d != 0.0, dim=1) & on
            q = torch.where(nz[:, None, None],
                            q + G[:, :, j, None] * d[:, None, :], q)
    return (beta, q) if lanes else (beta[0], q[0])


def cd_epoch_xb_lanes_plain(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                            params, active, datafit_kind="quadratic", *,
                            w=None, epochs=1):
    """K2l's plain version: K2's plain epoch on each active lane s of
    Xt_ws [S, K, n], beta0, L, offset [S, K], Xb0 [S, n] with the shared y
    [n], the weights w (None, [n] or [S, n]) and params[s]; a frozen
    lane's beta and Xb come back unchanged."""
    beta, Xb = beta0.clone(), Xb0.clone()
    for s in range(Xt_ws.shape[0]):
        if bool(active[s]):
            ws = w if w is None or w.ndim == 1 else w[s]
            beta[s], Xb[s] = cd_epoch_xb_plain(
                Xt_ws[s], y, beta0[s], Xb0[s], L[s], offset[s], penalty_cls,
                params[s], datafit_kind, w=ws, epochs=epochs)
    return beta, Xb


def cd_epoch_gram_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                       plan, epochs=1):
    """Launch K1 on the tensors' stream with `plan` (a ``gram_plan``); G
    may have any strides. Returns (beta, q)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_{_suffix(G)}")
    pid, prm = kernel_params(penalty_cls, params, G.device)
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), G.shape[0], epochs, pid,
                prm.data_ptr(), plan.cluster, plan.dyn_bytes, plan.threads,
                stream)
    _check_rc(rc, "cd_epoch_gram", plan)
    return beta, q


def cd_epoch_gram_block_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                             plan, epochs=1):
    """Launch K1b on the tensors' stream with `plan` (a
    ``gram_block_plan``); G may have any strides, c, beta0 and q0 are
    contiguous [K, T]. Returns (beta, q)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_block_{_suffix(G)}")
    pid, prm = kernel_params(penalty_cls, params, G.device)
    K, T = beta0.shape
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), K, T, epochs, pid,
                prm.data_ptr(), plan.cluster, int(plan.smem), plan.dyn_bytes,
                plan.threads, plan.per, plan.owners, int(plan.g_whole),
                stream)
    _check_rc(rc, "cd_epoch_gram_block", plan)
    return beta, q


def cd_epoch_xb_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                     datafit_kind="quadratic", *, plan, w=None, epochs=1):
    """Launch K2 on the tensors' stream with `plan` (an ``xb_plan``);
    Xt_ws is contiguous [K, n]. Returns (beta, Xb)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_xb_{_suffix(Xt_ws)}")
    pid, prm = kernel_params(penalty_cls, params, Xt_ws.device)
    K, n = Xt_ws.shape
    beta, Xb = torch.empty_like(beta0), torch.empty_like(Xb0)
    # the beta copies of ranks 1..C-1, and the raw gradient on the global
    # branch
    scratch = torch.empty((plan.cluster - 1) * K + (0 if plan.smem else n),
                          dtype=Xt_ws.dtype, device=Xt_ws.device)
    with torch.cuda.device(Xt_ws.device):
        stream = torch.cuda.current_stream(Xt_ws.device).cuda_stream
        rc = fn(Xt_ws.data_ptr(), y.data_ptr(),
                None if w is None else w.data_ptr(), L.data_ptr(),
                offset.data_ptr(), beta0.data_ptr(), Xb0.data_ptr(),
                beta.data_ptr(), Xb.data_ptr(), scratch.data_ptr(), K, n,
                epochs, KIND_IDS[datafit_kind], pid, prm.data_ptr(),
                plan.cluster,
                int(plan.smem), plan.dyn_bytes, plan.threads, plan.per,
                stream)
    _check_rc(rc, "cd_epoch_xb", plan)
    return beta, Xb


def _mask_ptr(active):
    """The active-lane mask as the kernels read it (one byte a lane): the
    bool mask's own bytes, no copy."""
    return active.contiguous().view(torch.uint8)


def cd_epoch_gram_lanes_cuda(G, c, beta0, q0, L, penalty_cls, params, active,
                             *, plan, epochs=1):
    """Launch K1l on the tensors' stream: K1 with `plan` (a
    ``gram_lanes_plan``, or a ``gram_plan`` of one lane's K) on each lane
    of G [S, K, K] (each lane with K1's strides), c, beta0, q0, L
    contiguous [S, K], params [S, arity] on the card and the bool mask
    `active` [S]; float64 only. Returns (beta, q)."""
    if G.dtype != torch.float64:
        raise TypeError("cd_epoch_gram_lanes: the card runs it in float64 "
                        "only")
    fn = BUILD.lib("cd_epoch").cd_epoch_gram_lanes_f64
    S, K = beta0.shape
    pid, prm = kernel_params(penalty_cls, params, G.device, lanes=S)
    mask = _mask_ptr(active)
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(1), G.stride(2), G.stride(0),
                c.data_ptr(), L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), K, epochs, pid,
                prm.data_ptr(), prm.shape[1], mask.data_ptr(), S,
                plan.cluster, plan.dyn_bytes, plan.threads, stream)
    _check_rc(rc, "cd_epoch_gram_lanes", plan)
    return beta, q


def cd_epoch_gram_block_lanes_cuda(G, c, beta0, q0, L, penalty_cls, params,
                                   active, *, plan, epochs=1):
    """Launch K1bl on the tensors' stream: K1b with `plan` (a
    ``gram_block_plan`` of one lane's K and T) on each lane of G [S, K, K]
    (each lane with K1b's strides), c, beta0, q0 contiguous [S, K, T], L
    contiguous [S, K], params [S, arity] on the card and the bool mask
    `active` [S]; float64 only. Returns (beta, q)."""
    if G.dtype != torch.float64:
        raise TypeError("cd_epoch_gram_block_lanes: the card runs it in "
                        "float64 only")
    fn = BUILD.lib("cd_epoch").cd_epoch_gram_block_lanes_f64
    S, K, T = beta0.shape
    pid, prm = kernel_params(penalty_cls, params, G.device, lanes=S)
    mask = _mask_ptr(active)
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(1), G.stride(2), G.stride(0),
                c.data_ptr(), L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), K, T, epochs, pid,
                prm.data_ptr(), prm.shape[1], mask.data_ptr(), S,
                plan.cluster, int(plan.smem), plan.dyn_bytes, plan.threads,
                plan.per, plan.owners, int(plan.g_whole), stream)
    _check_rc(rc, "cd_epoch_gram_block_lanes", plan)
    return beta, q


def cd_epoch_xb_lanes_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                           params, active, datafit_kind="quadratic", *, plan,
                           w=None, epochs=1):
    """Launch K2l on the tensors' stream: K2 with `plan` (an ``xb_plan``
    of n) on each lane of Xt_ws contiguous [S, K, n], beta0, L, offset
    [S, K], Xb0 [S, n], the shared y [n], w None, [n] or [S, n], params
    [S, arity] on the card and the bool mask `active` [S]. Returns
    (beta, Xb)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_xb_lanes_{_suffix(Xt_ws)}")
    S, K, n = Xt_ws.shape
    pid, prm = kernel_params(penalty_cls, params, Xt_ws.device, lanes=S)
    mask = _mask_ptr(active)
    beta, Xb = torch.empty_like(beta0), torch.empty_like(Xb0)
    per_lane = (plan.cluster - 1) * K + (0 if plan.smem else n)
    scratch = torch.empty(max(1, S * per_lane), dtype=Xt_ws.dtype,
                          device=Xt_ws.device)
    w_lane = 0 if w is None or w.ndim == 1 else n
    with torch.cuda.device(Xt_ws.device):
        stream = torch.cuda.current_stream(Xt_ws.device).cuda_stream
        rc = fn(Xt_ws.data_ptr(), y.data_ptr(),
                None if w is None else w.data_ptr(), w_lane, L.data_ptr(),
                offset.data_ptr(), beta0.data_ptr(), Xb0.data_ptr(),
                beta.data_ptr(), Xb.data_ptr(), scratch.data_ptr(), per_lane,
                K, n, epochs, KIND_IDS[datafit_kind], pid, prm.data_ptr(),
                prm.shape[1], mask.data_ptr(), S, plan.cluster,
                int(plan.smem), plan.dyn_bytes, plan.threads, plan.per,
                stream)
    _check_rc(rc, "cd_epoch_xb_lanes", plan)
    return beta, Xb


def cluster_barrier_cuda(cluster, threads, iters, device):
    """Enqueue `iters` cluster barriers on one cluster of `cluster` CTAs of
    `threads` threads each (the chain floor of K2 and K1b; counted in no
    launch count)."""
    lib = BUILD.lib("cd_epoch")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.cluster_barrier_loop(cluster, threads, iters, stream)
    _check_rc(rc, "cluster_barrier_loop", EpochPlan(cluster, False, 0,
                                                    threads, 0))


def gram_chain_floor_cuda(K, epochs, threads, device):
    """Enqueue K1's chain floor in float64: `epochs` passes of K chain
    steps (a shuffle and a multiply-add each) with K1's handoff every
    GRAM_B steps, on one CTA of `threads` threads (counted in no launch
    count)."""
    lib = BUILD.lib("cd_epoch")
    out = torch.empty(GRAM_B, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gram_chain_floor(K, epochs, threads, out.data_ptr(), stream)
    _check_rc(rc, "gram_chain_floor")


def gram_block_chain_floor_cuda(K, T, epochs, threads, device):
    """Enqueue K1b's one-CTA chain floor in float64: `epochs` passes of K
    chain steps (a norm over T tasks by the kernel's shuffle tree, a sqrt
    and a divide, no loads) with the kernel's hand-off every step, on one
    CTA of `threads` threads (counted in no launch count)."""
    lib = BUILD.lib("cd_epoch")
    out = torch.empty(32, dtype=torch.float64, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.gram_block_chain_floor(K, T, epochs, threads, out.data_ptr(),
                                        stream)
    _check_rc(rc, "gram_block_chain_floor")


def gram_kernel_attrs_cuda(lanes: bool, cluster: bool, pen: int = 0):
    """(registers a thread, local bytes a thread) of K1's float64 kernel
    (K1l's with `lanes`) of penalty id `pen`, on one CTA or the cluster
    kernel, as ``cudaFuncGetAttributes`` reports them."""
    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    rc = BUILD.lib("cd_epoch").gram_kernel_attrs(
        int(lanes), int(cluster), pen, ctypes.byref(regs), ctypes.byref(local))
    _check_rc(rc, "gram_kernel_attrs")
    return regs.value, local.value


def fill_shared_memory_cuda(device):
    """Enqueue a fill of every SM's shared memory with 0xFF bytes (NaN in
    float32 and float64), so that a kernel launched next which reads shared
    memory it never wrote shows it (the gpu tests and ``chip_smoke.py``;
    counted in no launch count)."""
    lib = BUILD.lib("cd_epoch")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = lib.fill_shared_memory(stream)
    _check_rc(rc, "fill_shared_memory")
