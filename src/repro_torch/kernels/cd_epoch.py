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

K2 runs on a thread-block cluster of C CTAs that split the epoch state,
K1b on one CTA at small shapes and on a cluster above them
(``csrc/cd_epoch.cu`` describes both designs). ``xb_plan`` and
``gram_block_plan`` are the one place that chooses a call's launch layout,
from its shape alone: the cluster size C, whether the state's slices live in
shared or in global memory, the dynamic shared memory per CTA, the threads
and the register path. The wrappers hand the plan to the C launchers as
ints; a launch that the card refuses raises, and nothing retries on another
layout.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..core.datafits import Logistic, Quadratic, QuadraticSVC
from ._build import BUILD
from .common import PENALTY_IDS, make_penalty
from .ref import cd_epoch_gram_ref, cd_epoch_xb_ref

__all__ = ["KIND_IDS", "cd_epoch_gram_plain", "cd_epoch_xb_plain",
           "cd_epoch_gram_cuda", "cd_epoch_gram_block_cuda",
           "cd_epoch_xb_cuda", "kernel_params", "EpochPlan", "xb_plan",
           "gram_block_plan", "BRANCHES", "SMEM_DYN_MAX",
           "cluster_barrier_cuda"]

# dynamic shared memory a CTA may take: the H100's 232,448 bytes per CTA
# less 1 KB for the kernels' few static shared values
SMEM_DYN_MAX = 232_448 - 1024
# the cluster size, and the largest K1b shape that keeps one CTA because
# the cluster barrier costs more there than the split saves (measured on the
# H100 by `cd_sweep.py` at the root of the checkout; the numbers are in
# PERF.md). 16 CTAs is beyond the portable 8: the launcher asks the card
# whether a GPC can place them and raises if not.
CLUSTER = 16
GRAM_BLOCK_SINGLE_MAX_KT = 256 * 20
# values a thread keeps in registers on the register paths (K2's samples,
# K1b's q entries), which the kernels run on at most PER_THREADS threads
XB_PER, GRAM_PER, PER_THREADS = 4, 8, 768
BRANCHES = ("single", "cluster-shared", "cluster-global")
_ERR_CLUSTER_UNPLACEABLE = -1


class EpochPlan(NamedTuple):
    """How one K2 or K1b launch runs: ``cluster`` CTAs (1: K1b's one-CTA
    kernel), the state's slices in shared memory (``smem``) or in global
    memory, ``dyn_bytes`` of dynamic shared memory, ``threads`` per CTA and
    ``per`` values a thread keeps in registers (0: no register path)."""
    cluster: int
    smem: bool
    dyn_bytes: int
    threads: int
    per: int

    @property
    def branch(self) -> str:
        if self.cluster == 1:
            return "single"
        return "cluster-shared" if self.smem else "cluster-global"


def _threads(m: int) -> int:
    """Warps enough for m values, 1 to 32 of them."""
    return min(1024, max(32, -(-m // 32) * 32))


def xb_plan(n: int, weighted: bool, dtype, cluster: int = CLUSTER
            ) -> EpochPlan:
    """K2's layout for n samples: each of `cluster` CTAs holds a slice of
    ceil(n / C) samples of Xb, the raw gradient, y (and w), in shared memory
    while they fit, and takes about XB_PER samples a thread."""
    m = -(-n // cluster)
    state = m * dtype.itemsize * (4 if weighted else 3)
    smem = state <= SMEM_DYN_MAX
    threads = max(128, _threads(-(-m // XB_PER)))
    return EpochPlan(cluster, smem, state if smem else 0, threads,
                     XB_PER if threads <= PER_THREADS else 0)


def gram_block_plan(K: int, T: int, dtype, cluster: int | None = None
                    ) -> EpochPlan:
    """K1b's layout for q [K, T]: one CTA holding delta_j and all of q for
    K * T <= GRAM_BLOCK_SINGLE_MAX_KT; above, a cluster of CLUSTER CTAs,
    each holding the slots of 3 (T + 1) values and ceil(K / C) rows of q
    (in shared memory while they fit), about GRAM_PER entries a thread.
    `cluster` forces C."""
    item = dtype.itemsize
    C = cluster or (1 if K * T <= GRAM_BLOCK_SINGLE_MAX_KT else CLUSTER)
    if C == 1:
        return EpochPlan(1, True, (T + K * T) * item, _threads(K * T), 0)
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


def kernel_params(penalty_cls, params):
    """(penalty id, p0, p1): the codec vector as the C launchers take it."""
    vals = [float(v) for v in params.tolist()] + [0.0, 0.0]
    return PENALTY_IDS[penalty_cls], vals[0], vals[1]


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


def cd_epoch_gram_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                       epochs=1):
    """Launch K1 on the tensors' stream; G may have any strides."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_{_suffix(G)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), G.shape[0], epochs, pid, p0,
                p1, stream)
    _check_rc(rc, "cd_epoch_gram")
    return beta, q


def cd_epoch_gram_block_cuda(G, c, beta0, q0, L, penalty_cls, params, *,
                             plan, epochs=1):
    """Launch K1b on the tensors' stream with `plan` (a
    ``gram_block_plan``); G may have any strides, c, beta0 and q0 are
    contiguous [K, T]. Returns (beta, q)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_gram_block_{_suffix(G)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
    K, T = beta0.shape
    beta, q = torch.empty_like(beta0), torch.empty_like(q0)
    with torch.cuda.device(G.device):
        stream = torch.cuda.current_stream(G.device).cuda_stream
        rc = fn(G.data_ptr(), G.stride(0), G.stride(1), c.data_ptr(),
                L.data_ptr(), beta0.data_ptr(), q0.data_ptr(),
                beta.data_ptr(), q.data_ptr(), K, T, epochs, pid, p0, p1,
                plan.cluster, int(plan.smem), plan.dyn_bytes, plan.threads,
                plan.per, stream)
    _check_rc(rc, "cd_epoch_gram_block", plan)
    return beta, q


def cd_epoch_xb_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                     datafit_kind="quadratic", *, plan, w=None, epochs=1):
    """Launch K2 on the tensors' stream with `plan` (an ``xb_plan``);
    Xt_ws is contiguous [K, n]. Returns (beta, Xb)."""
    fn = getattr(BUILD.lib("cd_epoch"), f"cd_epoch_xb_{_suffix(Xt_ws)}")
    pid, p0, p1 = kernel_params(penalty_cls, params)
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
                epochs, KIND_IDS[datafit_kind], pid, p0, p1, plan.cluster,
                int(plan.smem), plan.dyn_bytes, plan.threads, plan.per,
                stream)
    _check_rc(rc, "cd_epoch_xb", plan)
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
