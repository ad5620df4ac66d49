"""Public, checked wrappers of the kernels K1-K5 and their block forms, with
launch counters.

Each wrapper checks device, dtype, shape and contiguity, then routes by the
device of its tensors: on the CPU it runs the kernel's plain torch version;
on a CUDA device it launches the CUDA kernel (built at first use) and adds
one to its ``launches`` count, or raises. There is no fallback from the
kernel to the plain version. ``launches`` is a plain int on the wrapper;
``reset_launch_counts`` and ``launch_counts`` cover all of them:

  cd_epoch_gram        K1, CD epochs on the Gram subproblem
  cd_epoch_xb          K2, CD epochs on the Xb state
  fused_ws             K3, the fused working-set head (dense designs),
                       with the working set's rows in place of the
                       candidates
  ws_score             K4, the two-pass score head (dense designs)
  csc_score            K5, the sparse score pass X.T @ raw (CSC designs)
  csc_weighted_col_sq  K5s, K5 in square mode: sum_i w_i x_ij^2
  cd_epoch_gram_block  K1b, K1 on multitask blocks beta [K, T]
  fused_ws_block       K3b, K3 on blocks: raw [n, T], beta [p, T]
  csc_score_block      K5b, K5 on a raw gradient [n, T] -> [p, T]
  cd_epoch_gram_lanes  K1l, K1 over S lanes in one launch (the chunked
                       driver and the CV grid), with an active-lane mask
  cd_epoch_xb_lanes    K2l, K2 over S lanes in one launch, with the mask
  fused_ws_lanes       K3l, K3 over S lanes sharing X (X read once)
  ws_gather            K3g, K3l's gather of the lanes' working-set rows,
                       each distinct row of X read once
  cd_epoch_gram_block_lanes
                       K1bl, K1b over S lanes of multitask blocks in one
                       launch, with the mask
  fused_ws_block_lanes K3bl, K3b over S lanes of multitask blocks sharing X
  csc_row_sum          K5r, the CSC scatters (X @ beta, Xb + X_ws delta)
                       as row sums in a fixed order over a row-major
                       copy of the design (``ws_slot_map`` makes the
                       update's map of slots)

The block and lane forms have counters of their own, so a run can tell
them from the single-lane scalar launches. K1, K2, K1b, K1l, K2l and
K1bl also count their launches by
the branch their shape's plan took (``kernels/cd_epoch.py``:
``gram_plan``, ``xb_plan``, ``gram_block_plan``) in ``branch_launches``, a
dict over ``BRANCHES`` ("single", "cluster-shared", "cluster-global"),
and by the plan's cluster size in ``cluster_launches``;
``branch_counts`` and ``cluster_counts`` read them. The lane epochs K1l,
K2l and K1bl also count by shape in ``shape_launches``: (K rounded up to
a power of two, cluster size), and the lane heads K3l and K3bl by (ws
rounded up to a power of two, lane count), which ``shape_counts`` reads.
K3l's gathers count the rows they fill (S K) and, on the card, the
distinct rows they read (U, a device counter each launch adds to, so a
replayed launch adds at each replay) by ws bucket: ``gather_counts``.
K5r counts its launches by call site, ``matvec`` and ``update_xb``, and
the update's slot maps: ``row_sum_counts``.

A kernel captured into a CUDA graph launches at each replay of the graph:
inside ``deferred_launches`` the wrappers record their launches instead of
counting them, and the graph's owner counts them with ``add_launches``
after each replay, as often as the replay ran them (``core/flow.py``).
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

from .cd_epoch import (BRANCHES, KIND_IDS, cd_epoch_gram_block_cuda,
                       cd_epoch_gram_block_lanes_cuda,
                       cd_epoch_gram_block_lanes_plain,
                       cd_epoch_gram_cuda, cd_epoch_gram_lanes_cuda,
                       cd_epoch_gram_lanes_plain, cd_epoch_gram_plain,
                       cd_epoch_xb_cuda, cd_epoch_xb_lanes_cuda,
                       cd_epoch_xb_lanes_plain, cd_epoch_xb_plain,
                       gram_block_plan, gram_lanes_plan, gram_plan,
                       xb_lanes_plan, xb_plan)
from .common import (PENALTY_IDS, UnsupportedPenaltyError,
                     check_block_kernel_penalty,
                     check_kernel_penalty, check_score_kernel_penalty,
                     make_penalty, penalty_params)
from .csc_score import (csc_row_sum_cuda, csc_row_sum_plain,
                        csc_score_block_cuda, csc_score_cuda, csc_score_plain,
                        slot_bitmap, slot_map_cuda)
from ..core.working_set import candidate_columns, select_working_set
from .fused_ws import (fused_ws_block_cuda, fused_ws_block_lanes_cuda,
                       fused_ws_block_lanes_plain, fused_ws_cuda,
                       fused_ws_lanes_cuda, fused_ws_lanes_plain,
                       fused_ws_plain, score_cuda, slot_map,
                       ws_gather_cuda)
from .ws_score import ws_score_plain

__all__ = ["cd_epoch_gram", "cd_epoch_xb", "fused_ws", "ws_score",
           "csc_score", "csc_weighted_col_sq", "cd_epoch_gram_block",
           "fused_ws_block", "csc_score_block", "cd_epoch_gram_lanes",
           "cd_epoch_xb_lanes", "fused_ws_lanes",
           "cd_epoch_gram_block_lanes", "fused_ws_block_lanes",
           "csc_row_sum", "ws_slot_map", "ws_gather", "KERNELS",
           "launch_counts", "reset_launch_counts", "branch_counts",
           "cluster_counts", "shape_counts", "gather_counts",
           "row_sum_counts",
           "rows_read_counter", "deferred_launches",
           "add_launches",
           "penalty_params",
           "make_penalty", "check_kernel_penalty",
           "check_score_kernel_penalty", "UnsupportedPenaltyError"]


# the launch records of the CUDA graph bodies being captured, innermost
# last (deferred_launches)
_DEFERRED: list = []


def _count(wrapper, plan=None, times=1, K=None, lanes=None, rows=0,
           site=None):
    """Add a launch to `wrapper`'s counts (and, for a branched kernel, to
    its plan's branch and cluster size; with `K`, to its shape: K rounded
    up to a power of two and the plan's cluster size, or without a plan
    the `lanes`; `rows`, the slots a gather fills, to its bucket; `site`,
    K5r's call site, to its sites), or, while a graph captures, record it
    for the replays (a captured kernel launches when its graph replays,
    not when the wrapper runs)."""
    if _DEFERRED:
        _DEFERRED[-1].append((wrapper, plan, K, lanes, rows, site))
        return
    if site is not None:
        wrapper.site_launches[site] += times
        if site == "slot_map":             # the update's map: not K5r's
            return
    wrapper.launches += times
    if plan is not None and hasattr(wrapper, "branch_launches"):
        wrapper.branch_launches[plan.branch] += times
        sizes = wrapper.cluster_launches
        sizes[plan.cluster] = sizes.get(plan.cluster, 0) + times
    if K is not None:
        kb = 1 << (K - 1).bit_length()
        if hasattr(wrapper, "shape_launches"):
            key = (kb, f"C={plan.cluster}" if plan is not None
                   else f"S={lanes}")
            shapes = wrapper.shape_launches
            shapes[key] = shapes.get(key, 0) + times
        if rows:
            got = wrapper.bucket_rows.setdefault(kb, [0, 0])
            got[0] += times
            got[1] += rows * times


@contextmanager
def deferred_launches():
    """Within: the wrappers record their launches in the yielded list
    instead of counting them; ``add_launches`` counts them per replay."""
    records = []
    _DEFERRED.append(records)
    try:
        yield records
    finally:
        _DEFERRED.pop()


def add_launches(records, times=1):
    """Count the launches in `records` (from ``deferred_launches``)
    `times` times over."""
    if times:
        for wrapper, plan, K, lanes, rows, site in records:
            _count(wrapper, plan, times, K, lanes, rows, site)


def _route(name, **tensors) -> bool:
    """True for CUDA tensors, False for CPU ones; raise on anything else
    (mixed devices, dtypes, or a device type without a kernel route)."""
    devs = {t.device for t in tensors.values()}
    if len(devs) != 1:
        raise ValueError(f"{name}: tensors on several devices {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: no route for device {dev}")
    dtypes = {t.dtype for t in tensors.values()}
    if len(dtypes) != 1 or dtypes.pop() not in (torch.float32, torch.float64):
        raise TypeError(f"{name}: tensors must share one dtype, float32 or "
                        f"float64; got {[str(t.dtype) for t in tensors.values()]}")
    return dev.type == "cuda"


def _check_vec(name, n, **vecs):
    for key, v in vecs.items():
        if v.ndim != 1 or v.shape[0] != n or not v.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous [{n}] "
                             f"vector, got shape {tuple(v.shape)}")


def _check_mat(name, rows, cols, **mats):
    for key, m in mats.items():
        if m.ndim != 2 or tuple(m.shape) != (rows, cols) or \
                not m.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous "
                             f"[{rows}, {cols}] matrix, got shape "
                             f"{tuple(m.shape)}")


def cd_epoch_gram(G, c, beta0, q0, L, penalty_cls, params, *, epochs=1):
    """K1: `epochs` cyclic CD epochs on the Gram subproblem. G: [K, K] (any
    strides; column-major makes the kernel's column reads contiguous);
    c, beta0, q0, L: [K]. Returns (beta, q)."""
    check_kernel_penalty(penalty_cls)
    on_card = _route("cd_epoch_gram", G=G, c=c, beta0=beta0, q0=q0, L=L)
    K = G.shape[0]
    if G.ndim != 2 or G.shape[1] != K:
        raise ValueError(f"cd_epoch_gram: G must be [K, K], got {tuple(G.shape)}")
    _check_vec("cd_epoch_gram", K, c=c, beta0=beta0, q0=q0, L=L)
    if not on_card:
        return cd_epoch_gram_plain(G, c, beta0, q0, L, penalty_cls, params,
                                   epochs=epochs)
    plan = gram_plan(K, G.dtype)
    out = cd_epoch_gram_cuda(G, c, beta0, q0, L, penalty_cls, params,
                             epochs=epochs, plan=plan)
    _count(cd_epoch_gram, plan)
    return out


def cd_epoch_gram_block(G, c, beta0, q0, L, penalty_cls, params, *,
                        epochs=1):
    """K1b: `epochs` cyclic block-CD epochs on the Gram subproblem of
    multitask coefficients. G: [K, K] (any strides; column-major makes the
    kernel's column reads contiguous); c, beta0, q0: contiguous [K, T];
    L: [K]; a block penalty. Returns (beta, q)."""
    check_block_kernel_penalty(penalty_cls)
    on_card = _route("cd_epoch_gram_block", G=G, c=c, beta0=beta0, q0=q0,
                     L=L)
    K = G.shape[0]
    if G.ndim != 2 or G.shape[1] != K:
        raise ValueError(f"cd_epoch_gram_block: G must be [K, K], got "
                         f"{tuple(G.shape)}")
    if beta0.ndim != 2:
        raise ValueError("cd_epoch_gram_block: beta0 must be [K, T], got "
                         f"shape {tuple(beta0.shape)}")
    _check_mat("cd_epoch_gram_block", K, beta0.shape[1], c=c, beta0=beta0,
               q0=q0)
    _check_vec("cd_epoch_gram_block", K, L=L)
    if not on_card:
        return cd_epoch_gram_plain(G, c, beta0, q0, L, penalty_cls, params,
                                   epochs=epochs)
    plan = gram_block_plan(K, beta0.shape[1], G.dtype)
    out = cd_epoch_gram_block_cuda(G, c, beta0, q0, L, penalty_cls, params,
                                   epochs=epochs, plan=plan)
    _count(cd_epoch_gram_block, plan)
    return out


def cd_epoch_xb(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                datafit_kind="quadratic", *, w=None, epochs=1):
    """K2: `epochs` CD epochs maintaining Xb. Xt_ws: contiguous [K, n];
    y, Xb0 (and w): [n]; beta0, L, offset: [K]. Returns (beta, Xb)."""
    check_kernel_penalty(penalty_cls)
    if datafit_kind not in KIND_IDS:
        raise ValueError(f"cd_epoch_xb: unknown datafit kind {datafit_kind!r}")
    if datafit_kind == "svc" and w is not None:
        raise ValueError("QuadraticSVC does not support sample weights")
    extra = {} if w is None else {"w": w}
    on_card = _route("cd_epoch_xb", Xt_ws=Xt_ws, y=y, beta0=beta0, Xb0=Xb0,
                     L=L, offset=offset, **extra)
    if Xt_ws.ndim != 2 or not Xt_ws.is_contiguous():
        raise ValueError("cd_epoch_xb: Xt_ws must be a contiguous [K, n] "
                         f"matrix, got shape {tuple(Xt_ws.shape)}")
    K, n = Xt_ws.shape
    _check_vec("cd_epoch_xb", n, y=y, Xb0=Xb0, **extra)
    _check_vec("cd_epoch_xb", K, beta0=beta0, L=L, offset=offset)
    if not on_card:
        return cd_epoch_xb_plain(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                                 params, datafit_kind, w=w, epochs=epochs)
    plan = xb_plan(n, w is not None, Xt_ws.dtype)
    out = cd_epoch_xb_cuda(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls,
                           params, datafit_kind, w=w, epochs=epochs,
                           plan=plan)
    _count(cd_epoch_xb, plan)
    return out


def _check_mask(name, S, active, device):
    if active.dtype != torch.bool or tuple(active.shape) != (S,) or \
            active.device != device:
        raise TypeError(f"{name}: active must be a bool [{S}] mask on "
                        f"{device}, got {active.dtype} "
                        f"{tuple(active.shape)} on {active.device}")


def cd_epoch_gram_lanes(G, c, beta0, q0, L, penalty_cls, params, active, *,
                        epochs=1):
    """K1l: K1's `epochs` on each of S lanes in one launch. G: [S, K, K]
    (each lane any strides; column-major makes the kernel's column reads
    contiguous); c, beta0, q0, L: contiguous [S, K]; params: [S, arity],
    a row a lane; active: bool [S] (a frozen lane comes back unchanged).
    Float64 on the card. Returns (beta, q)."""
    check_kernel_penalty(penalty_cls)
    on_card = _route("cd_epoch_gram_lanes", G=G, c=c, beta0=beta0, q0=q0,
                     L=L)
    if G.ndim != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"cd_epoch_gram_lanes: G must be [S, K, K], got "
                         f"{tuple(G.shape)}")
    S, K = G.shape[:2]
    _check_mat("cd_epoch_gram_lanes", S, K, c=c, beta0=beta0, q0=q0, L=L)
    _check_mask("cd_epoch_gram_lanes", S, active, G.device)
    if not on_card:
        return cd_epoch_gram_lanes_plain(G, c, beta0, q0, L, penalty_cls,
                                         params, active, epochs=epochs)
    plan = gram_lanes_plan(S, K, G.dtype, PENALTY_IDS[penalty_cls], G.device)
    out = cd_epoch_gram_lanes_cuda(G, c, beta0, q0, L, penalty_cls, params,
                                   active, epochs=epochs, plan=plan)
    _count(cd_epoch_gram_lanes, plan, K=K)
    return out


def cd_epoch_gram_block_lanes(G, c, beta0, q0, L, penalty_cls, params,
                              active, *, epochs=1):
    """K1bl: K1b's `epochs` on each of S lanes of multitask blocks in one
    launch. G: [S, K, K] (each lane any strides; column-major makes the
    kernel's column reads contiguous); c, beta0, q0: contiguous [S, K, T];
    L: contiguous [S, K]; params: [S, arity], a row a lane; a block
    penalty; active: bool [S] (a frozen lane comes back unchanged).
    Float64 on the card. Returns (beta, q)."""
    check_block_kernel_penalty(penalty_cls)
    on_card = _route("cd_epoch_gram_block_lanes", G=G, c=c, beta0=beta0,
                     q0=q0, L=L)
    if G.ndim != 3 or G.shape[1] != G.shape[2]:
        raise ValueError(f"cd_epoch_gram_block_lanes: G must be [S, K, K], "
                         f"got {tuple(G.shape)}")
    S, K = G.shape[:2]
    if beta0.ndim != 3 or tuple(beta0.shape[:2]) != (S, K):
        raise ValueError(f"cd_epoch_gram_block_lanes: beta0 must be "
                         f"[{S}, {K}, T], got shape {tuple(beta0.shape)}")
    shape = tuple(beta0.shape)
    for key, t in (("c", c), ("beta0", beta0), ("q0", q0)):
        if tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"cd_epoch_gram_block_lanes: {key} must be a "
                             f"contiguous {list(shape)} tensor, got shape "
                             f"{tuple(t.shape)}")
    _check_mat("cd_epoch_gram_block_lanes", S, K, L=L)
    _check_mask("cd_epoch_gram_block_lanes", S, active, G.device)
    if not on_card:
        return cd_epoch_gram_block_lanes_plain(G, c, beta0, q0, L,
                                               penalty_cls, params, active,
                                               epochs=epochs)
    plan = gram_block_plan(K, shape[2], G.dtype)
    out = cd_epoch_gram_block_lanes_cuda(G, c, beta0, q0, L, penalty_cls,
                                         params, active, epochs=epochs,
                                         plan=plan)
    _count(cd_epoch_gram_block_lanes, plan, K=K)
    return out


def cd_epoch_xb_lanes(Xt_ws, y, beta0, Xb0, L, offset, penalty_cls, params,
                      active, datafit_kind="quadratic", *, w=None, epochs=1):
    """K2l: K2's `epochs` on each of S lanes in one launch, on its own lane
    plan (``xb_lanes_plan``). Xt_ws:
    contiguous [S, K, n]; y: [n], shared; beta0, L, offset: contiguous
    [S, K]; Xb0: contiguous [S, n]; w: None, [n] or [S, n]; params: [S,
    arity]; active: bool [S]. Returns (beta, Xb)."""
    check_kernel_penalty(penalty_cls)
    if datafit_kind not in KIND_IDS:
        raise ValueError(f"cd_epoch_xb_lanes: unknown datafit kind "
                         f"{datafit_kind!r}")
    if datafit_kind == "svc" and w is not None:
        raise ValueError("QuadraticSVC does not support sample weights")
    extra = {} if w is None else {"w": w}
    on_card = _route("cd_epoch_xb_lanes", Xt_ws=Xt_ws, y=y, beta0=beta0,
                     Xb0=Xb0, L=L, offset=offset, **extra)
    if Xt_ws.ndim != 3 or not Xt_ws.is_contiguous():
        raise ValueError("cd_epoch_xb_lanes: Xt_ws must be a contiguous "
                         f"[S, K, n] tensor, got shape {tuple(Xt_ws.shape)}")
    S, K, n = Xt_ws.shape
    _check_vec("cd_epoch_xb_lanes", n, y=y)
    _check_mat("cd_epoch_xb_lanes", S, K, beta0=beta0, L=L, offset=offset)
    _check_mat("cd_epoch_xb_lanes", S, n, Xb0=Xb0)
    if w is not None:
        if w.ndim == 1:
            _check_vec("cd_epoch_xb_lanes", n, w=w)
        else:
            _check_mat("cd_epoch_xb_lanes", S, n, w=w)
    _check_mask("cd_epoch_xb_lanes", S, active, Xt_ws.device)
    if not on_card:
        return cd_epoch_xb_lanes_plain(Xt_ws, y, beta0, Xb0, L, offset,
                                       penalty_cls, params, active,
                                       datafit_kind, w=w, epochs=epochs)
    plan = xb_lanes_plan(S, n, w is not None, Xt_ws.dtype, Xt_ws.device)
    out = cd_epoch_xb_lanes_cuda(Xt_ws, y, beta0, Xb0, L, offset,
                                 penalty_cls, params, active, datafit_kind,
                                 w=w, epochs=epochs, plan=plan)
    _count(cd_epoch_xb_lanes, plan, K=K)
    return out


def _plain_head(Xt, r, beta, L, offset, gsupp, penalty_cls, params,
                ws_size, use_fp, bp):
    """The CPU route of K3 and K3b: the plain version's four outputs, the
    working set (``select_working_set`` on the scores) and its rows of Xt
    recovered from the candidate buffer (``candidate_columns``)."""
    scores, grad, cand_idx, cand_cols = fused_ws_plain(
        Xt, r, beta, L, offset, gsupp, penalty_cls, params, ws_size,
        use_fp=use_fp, bp=bp)
    ws = select_working_set(scores, gsupp, ws_size)
    return (scores, grad, cand_idx, ws,
            candidate_columns(cand_idx, cand_cols, ws, Xt.shape[0]).T)


def fused_ws(Xt, r, beta, L, offset, gsupp, penalty_cls, params, ws_size, *,
             use_fp=False, bp=None):
    """K3: the fused head over the feature-major design Xt [p, n]
    (contiguous): the scores, the offset-corrected gradient and each tile's
    top-kc candidates in one pass over X. r: [n]; beta, L, offset: [p];
    gsupp: bool [p]. Returns ``(scores [p], grad [p], cand_idx [C] int32,
    ws [ws_size], Xt_ws [ws_size, n])``: the working set
    (``select_working_set`` on the scores; on the card the merge launch
    computes it) and its rows of Xt. On the card no candidate row is
    copied: the K rows are gathered from Xt; on the CPU they come from the
    plain version's candidate buffer, as ``candidate_columns`` recovers
    them."""
    check_kernel_penalty(penalty_cls)          # scalar form only in this port
    on_card = _route("fused_ws", Xt=Xt, r=r, beta=beta, L=L, offset=offset)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("fused_ws: Xt must be a contiguous [p, n] matrix, "
                         f"got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    _check_vec("fused_ws", n, r=r)
    _check_vec("fused_ws", p, beta=beta, L=L, offset=offset, gsupp=gsupp)
    if gsupp.dtype != torch.bool or gsupp.device != Xt.device:
        raise TypeError("fused_ws: gsupp must be a bool mask on Xt's device")
    if not 1 <= ws_size <= p:
        raise ValueError(f"fused_ws: ws_size must be in [1, {p}], got {ws_size}")
    if not on_card:
        return _plain_head(Xt, r, beta, L, offset, gsupp, penalty_cls,
                           params, ws_size, use_fp, bp)
    scores, grad, cand_idx, ws = fused_ws_cuda(
        Xt, r, beta, L, offset, gsupp, penalty_cls, params, ws_size,
        use_fp=use_fp, bp=bp)
    _count(fused_ws)
    return scores, grad, cand_idx, ws, Xt.index_select(0, ws)


def fused_ws_block(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                   ws_size, *, use_fp=False, bp=None):
    """K3b: the fused head of K3 on multitask blocks, over the
    feature-major design Xt [p, n] (contiguous). R: contiguous [n, T];
    beta: contiguous [p, T]; L, offset: [p]; gsupp: bool [p]; a block
    penalty. Returns ``(scores [p], grad [p, T], cand_idx [C] int32,
    ws [ws_size], Xt_ws [ws_size, n])``, as K3 returns them."""
    check_block_kernel_penalty(penalty_cls)
    on_card = _route("fused_ws_block", Xt=Xt, R=R, beta=beta, L=L,
                     offset=offset)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("fused_ws_block: Xt must be a contiguous [p, n] "
                         f"matrix, got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    if R.ndim != 2:
        raise ValueError("fused_ws_block: R must be [n, T], got shape "
                         f"{tuple(R.shape)}")
    T = R.shape[1]
    _check_mat("fused_ws_block", n, T, R=R)
    _check_mat("fused_ws_block", p, T, beta=beta)
    _check_vec("fused_ws_block", p, L=L, offset=offset, gsupp=gsupp)
    if gsupp.dtype != torch.bool or gsupp.device != Xt.device:
        raise TypeError("fused_ws_block: gsupp must be a bool mask on Xt's "
                        "device")
    if not 1 <= ws_size <= p:
        raise ValueError(f"fused_ws_block: ws_size must be in [1, {p}], got "
                         f"{ws_size}")
    if not on_card:
        return _plain_head(Xt, R, beta, L, offset, gsupp, penalty_cls,
                           params, ws_size, use_fp, bp)
    scores, grad, cand_idx = fused_ws_block_cuda(
        Xt, R, beta, L, offset, gsupp, penalty_cls, params, ws_size,
        use_fp=use_fp, bp=bp)
    _count(fused_ws_block)
    ws = select_working_set(scores, gsupp, ws_size)
    return scores, grad, cand_idx, ws, Xt.index_select(0, ws)


def _plain_lanes_head(plain, gsupp, ws_size, p):
    """The CPU route of K3l and K3bl from their plain version's four
    outputs: each lane's working set (``select_working_set``) and its rows
    of Xt recovered from its candidate buffer (``candidate_columns``)."""
    scores, grad, cand_idx, cand_cols = plain
    S = scores.shape[0]
    ws = torch.stack([select_working_set(scores[s], gsupp[s], ws_size)
                      for s in range(S)])
    Xt_ws = torch.stack([candidate_columns(cand_idx[s], cand_cols[s],
                                           ws[s], p).T for s in range(S)])
    return scores, grad, cand_idx, ws, Xt_ws


def fused_ws_lanes(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                   ws_size, *, use_fp=False, bp=None):
    """K3l: K3's head on S lanes over the shared feature-major design Xt
    [p, n] (contiguous), X read once. R: contiguous [n, S] (a lane's raw
    gradient a column); beta, gsupp (bool): contiguous [S, p]; L: [S, p],
    its lanes p apart or one row broadcast (stride 0); offset: [p];
    params: [S, arity]. Returns ``(scores [S, p], grad [S, p], cand_idx
    [S, C] int32, ws [S, ws_size], Xt_ws [S, ws_size, n])``, each lane as
    K3 returns it."""
    check_kernel_penalty(penalty_cls)
    on_card = _route("fused_ws_lanes", Xt=Xt, R=R, beta=beta, L=L,
                     offset=offset)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("fused_ws_lanes: Xt must be a contiguous [p, n] "
                         f"matrix, got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    if R.ndim != 2:
        raise ValueError("fused_ws_lanes: R must be [n, S], got shape "
                         f"{tuple(R.shape)}")
    S = R.shape[1]
    _check_mat("fused_ws_lanes", n, S, R=R)
    _check_mat("fused_ws_lanes", S, p, beta=beta, gsupp=gsupp)
    _check_lane_L("fused_ws_lanes", L, S, p)
    _check_vec("fused_ws_lanes", p, offset=offset)
    if gsupp.dtype != torch.bool or gsupp.device != Xt.device:
        raise TypeError("fused_ws_lanes: gsupp must be a bool mask on Xt's "
                        "device")
    if not 1 <= ws_size <= p:
        raise ValueError(f"fused_ws_lanes: ws_size must be in [1, {p}], got "
                         f"{ws_size}")
    if not on_card:
        return _plain_lanes_head(fused_ws_lanes_plain(
            Xt, R, beta, L, offset, gsupp, penalty_cls, params, ws_size,
            use_fp=use_fp, bp=bp), gsupp, ws_size, p)
    scores, grad, cand_idx, ws = fused_ws_lanes_cuda(
        Xt, R, beta, L, offset, gsupp, penalty_cls, params, ws_size,
        use_fp=use_fp, bp=bp)
    _count(fused_ws_lanes, K=ws_size, lanes=S)
    return scores, grad, cand_idx, ws, ws_gather(Xt, ws)


def _check_lane_L(name, L, S, p):
    if L.shape != (S, p) or L.stride(1) != 1 or L.stride(0) not in (0, p):
        raise ValueError(f"{name}: L must be [{S}, {p}] with rows {p} apart "
                         f"or broadcast, got {tuple(L.shape)} strides "
                         f"{L.stride()}")


def fused_ws_block_lanes(Xt, R, beta, L, offset, gsupp, penalty_cls, params,
                         ws_size, *, use_fp=False, bp=None):
    """K3bl: K3b's head on S lanes of multitask blocks over the shared
    feature-major design Xt [p, n] (contiguous). R: contiguous [n, S*T],
    lane-major (lane s's raw gradient is R[:, s*T:(s+1)*T]); beta:
    contiguous [S, p, T]; gsupp (bool): contiguous [S, p]; L: [S, p], its
    lanes p apart or one row broadcast (stride 0); offset: [p]; params:
    [S, arity]; a block penalty. Returns ``(scores [S, p], grad [S, p, T],
    cand_idx [S, C] int32, ws [S, ws_size], Xt_ws [S, ws_size, n])``, each
    lane as K3b returns it."""
    check_block_kernel_penalty(penalty_cls)
    on_card = _route("fused_ws_block_lanes", Xt=Xt, R=R, beta=beta, L=L,
                     offset=offset)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("fused_ws_block_lanes: Xt must be a contiguous "
                         f"[p, n] matrix, got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    if beta.ndim != 3 or beta.shape[1] != p or not beta.is_contiguous():
        raise ValueError(f"fused_ws_block_lanes: beta must be a contiguous "
                         f"[S, {p}, T] tensor, got shape "
                         f"{tuple(beta.shape)}")
    S, _, T = beta.shape
    _check_mat("fused_ws_block_lanes", n, S * T, R=R)
    _check_mat("fused_ws_block_lanes", S, p, gsupp=gsupp)
    _check_lane_L("fused_ws_block_lanes", L, S, p)
    _check_vec("fused_ws_block_lanes", p, offset=offset)
    if gsupp.dtype != torch.bool or gsupp.device != Xt.device:
        raise TypeError("fused_ws_block_lanes: gsupp must be a bool mask on "
                        "Xt's device")
    if not 1 <= ws_size <= p:
        raise ValueError(f"fused_ws_block_lanes: ws_size must be in "
                         f"[1, {p}], got {ws_size}")
    if not on_card:
        return _plain_lanes_head(fused_ws_block_lanes_plain(
            Xt, R, beta, L, offset, gsupp, penalty_cls, params, ws_size,
            use_fp=use_fp, bp=bp), gsupp, ws_size, p)
    scores, grad, cand_idx, ws = fused_ws_block_lanes_cuda(
        Xt, R, beta, L, offset, gsupp, penalty_cls, params, ws_size,
        use_fp=use_fp, bp=bp)
    _count(fused_ws_block_lanes, K=ws_size, lanes=S)
    return (scores, grad, cand_idx, ws,
            Xt.index_select(0, ws.reshape(-1)).view(S, ws_size, n))


# K3g's distinct rows read on the card: an int64 counter a power of two of
# ws a device, made outside any capture (``rows_read_counter``)
_ROWS_READ: dict = {}


def rows_read_counter(device):
    """The card's counters of K3g's distinct rows read, [64] int64 by
    log2 of the ws bucket; made at the first call, which must come before
    any graph capture that launches K3g (``core/flow.py`` asks for it
    before each capture)."""
    dev = torch.device(device)
    if dev.index is None:
        dev = torch.device(dev.type, torch.cuda.current_device())
    if dev not in _ROWS_READ:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError("ws_gather: its row counter must be made "
                               "before a graph capture")
        _ROWS_READ[dev] = torch.zeros(64, dtype=torch.int64, device=dev)
    return _ROWS_READ[dev]


def ws_gather(Xt, ws):
    """K3g: the lanes' working-set rows Xt_ws [S, K, n] of the
    feature-major design Xt [p, n] (contiguous) for ws [S, K] (int64, each
    lane's K distinct features), each distinct row read once. Float64 on
    the card. Equal bit for bit to ``Xt.index_select(0, ws.reshape(-1))``
    viewed [S, K, n], its CPU route."""
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("ws_gather: Xt must be a contiguous [p, n] matrix, "
                         f"got shape {tuple(Xt.shape)}")
    if ws.ndim != 2 or ws.dtype != torch.int64 or not ws.is_contiguous() \
            or ws.device != Xt.device:
        raise TypeError("ws_gather: ws must be a contiguous int64 [S, K] "
                        "tensor on Xt's device")
    S, K = ws.shape
    on_card = _route("ws_gather", Xt=Xt)
    if not on_card:
        return Xt.index_select(0, ws.reshape(-1)).view(S, K, Xt.shape[1])
    kb = 1 << (K - 1).bit_length()
    counter = rows_read_counter(Xt.device)
    out = ws_gather_cuda(Xt, ws, counter[kb.bit_length() - 1])
    _count(ws_gather, K=K, rows=S * K)
    return out


def ws_score(Xt, r, beta, L, offset, penalty_cls, params, *, w=None,
             use_fp=False):
    """K4: violation scores of every feature from ``Xt @ (r * w) +
    offset`` over the feature-major design Xt [p, n] (contiguous). r (and
    w): [n]; beta, L, offset: [p]. Returns the scores [p]."""
    check_kernel_penalty(penalty_cls)
    extra = {} if w is None else {"w": w}
    on_card = _route("ws_score", Xt=Xt, r=r, beta=beta, L=L, offset=offset,
                     **extra)
    if Xt.ndim != 2 or not Xt.is_contiguous():
        raise ValueError("ws_score: Xt must be a contiguous [p, n] matrix, "
                         f"got shape {tuple(Xt.shape)}")
    p, n = Xt.shape
    _check_vec("ws_score", n, r=r, **extra)
    _check_vec("ws_score", p, beta=beta, L=L, offset=offset)
    if not on_card:
        return ws_score_plain(Xt, r, beta, L, offset, penalty_cls, params,
                              w=w, use_fp=use_fp)
    out = score_cuda(Xt, r, beta, L, offset, penalty_cls, params, w=w,
                     use_fp=use_fp)
    _count(ws_score)
    return out


def _check_csc(name, data, indices, col_ids, indptr, v, block=False):
    """Check a CSC kernel call's arrays; True when it goes to the card.
    `v` is a contiguous [n] vector, or with `block` an [n, T] matrix."""
    on_card = _route(name, data=data, v=v)
    for key, t, dtype in (("indices", indices, torch.int32),
                          ("col_ids", col_ids, torch.int32),
                          ("indptr", indptr, torch.int64)):
        if t.dtype != dtype or t.device != data.device or t.ndim != 1 \
                or not t.is_contiguous():
            raise TypeError(f"{name}: {key} must be a contiguous 1-D "
                            f"{dtype} tensor on {data.device}, got "
                            f"{t.dtype} {tuple(t.shape)} on {t.device}")
    if data.ndim != 1 or not data.is_contiguous():
        raise ValueError(f"{name}: data must be a contiguous 1-D vector")
    if indices.shape != data.shape or col_ids.shape != data.shape:
        raise ValueError(f"{name}: data, indices and col_ids must have one "
                         f"length, got {data.shape[0]}, {indices.shape[0]},"
                         f" {col_ids.shape[0]}")
    if indptr.shape[0] < 1:
        raise ValueError(f"{name}: indptr must hold p + 1 entries")
    want, what = (2, "[n, T] matrix") if block else (1, "[n] vector")
    if v.ndim != want or not v.is_contiguous():
        raise ValueError(f"{name}: the {what} must be contiguous {want}-D, "
                         f"got shape {tuple(v.shape)}")
    return on_card


def csc_score(data, indices, col_ids, indptr, raw):
    """K5: ``X.T @ raw`` -> [p] over the window-padded CSC arrays of a
    ``CSCDesign`` (data, int32 indices and col_ids, int64 indptr [p + 1]);
    raw: [n]."""
    on_card = _check_csc("csc_score", data, indices, col_ids, indptr, raw)
    if not on_card:
        return csc_score_plain(data, indices, col_ids, indptr, raw)
    out = csc_score_cuda(data, indices, col_ids, indptr, raw)
    _count(csc_score)
    return out


def csc_weighted_col_sq(data, indices, col_ids, indptr, w):
    """K5s: ``sum_i w_i x_ij^2`` -> [p] over the same CSC arrays; w: [n]."""
    on_card = _check_csc("csc_weighted_col_sq", data, indices, col_ids,
                         indptr, w)
    if not on_card:
        return csc_score_plain(data, indices, col_ids, indptr, w,
                               square=True)
    out = csc_score_cuda(data, indices, col_ids, indptr, w, square=True)
    _count(csc_weighted_col_sq)
    return out


def csc_score_block(data, indices, col_ids, indptr, raw):
    """K5b: ``X.T @ raw`` -> [p, T] over the same CSC arrays; raw:
    contiguous [n, T]."""
    on_card = _check_csc("csc_score_block", data, indices, col_ids, indptr,
                         raw, block=True)
    if not on_card:
        return csc_score_plain(data, indices, col_ids, indptr, raw)
    out = csc_score_block_cuda(data, indices, col_ids, indptr, raw)
    _count(csc_score_block)
    return out


def csc_row_sum(val, order, keys, ptr, coef, *, kdiv=0, base=None,
                slots=None, bits=None):
    """K5r: ``base + out``, out[i] the sum of val[x] * coef[key(x)] over
    row i's entries x in a fixed order, the order ``index_add_`` adds in on
    the CPU. The card takes a row-major copy (``csc_score.row_major``:
    `order` None, val and keys its vals and cols (int32), ptr its int64
    [rows + 1]): key(x) = keys[x], row i's entries in the copy's order
    (``matvec``), or, with `slots` and `bits` (int32, the update's map of
    columns to slots and its bitmap, ``ws_slot_map``; the CPU reads slots
    alone), key(x) = slots[keys[x]], the entries without a slot left out
    and the rest by ascending slot (``update_xb``), on the plans
    ``csc_score.matvec_plan(T)`` and ``UPDATE_PLAN``. The CPU also takes
    `order` (int32 [E], ``csc_score.row_order``) over any flat arrays: row
    i's entries are its run of order, key(x) = keys[x] or, without keys,
    x // kdiv. coef: contiguous [P] or [P, T]; base: None or contiguous
    [rows] / [rows, T]. Launches count by site: ``row_sum_counts``."""
    extra = {} if base is None else {"base": base}
    on_card = _route("csc_row_sum", val=val, coef=coef, **extra)
    for key, t, dtype in (("order", order, torch.int32),
                          ("keys", keys, torch.int32),
                          ("ptr", ptr, torch.int64),
                          ("slots", slots, torch.int32),
                          ("bits", bits, torch.int32)):
        if t is not None and (t.dtype != dtype or t.device != val.device
                              or t.ndim != 1 or not t.is_contiguous()):
            raise TypeError(f"csc_row_sum: {key} must be a contiguous 1-D "
                            f"{dtype} tensor on {val.device}")
    if keys is None and (order is None or kdiv < 1):
        raise ValueError("csc_row_sum: without keys, an order and kdiv >= 1 "
                         "are needed")
    if slots is not None and order is not None:
        raise ValueError("csc_row_sum: slots take a row-major copy (order "
                         "None)")
    if coef.ndim not in (1, 2) or not coef.is_contiguous() or \
            not val.is_contiguous():
        raise ValueError("csc_row_sum: coef must be a contiguous [P] or "
                         "[P, T] tensor and val contiguous")
    shape = (ptr.shape[0] - 1,) + tuple(coef.shape[1:])
    if base is not None and (tuple(base.shape) != shape
                             or not base.is_contiguous()):
        raise ValueError(f"csc_row_sum: base must be contiguous {shape}, "
                         f"got {tuple(base.shape)}")
    if not on_card:
        return csc_row_sum_plain(val, order, keys, ptr, coef, kdiv=kdiv,
                                 base=base, slots=slots)
    if order is not None:
        raise ValueError("csc_row_sum: the card walks a row-major copy "
                         "(csc_score.row_major), not an order")
    if keys.shape != val.shape:
        raise ValueError("csc_row_sum: vals and cols must have one length")
    if slots is not None and (bits is None or bits.shape[0] !=
                              -(-slots.shape[0] // 32)):
        raise ValueError("csc_row_sum: the card's update takes the slot "
                         "map's bitmap, int32 [ceil(P / 32)]")
    out = csc_row_sum_cuda(val, keys, ptr, coef, base=base, slots=slots,
                           bits=bits)
    _count(csc_row_sum, site="matvec" if slots is None else "update_xb")
    return out


def ws_slot_map(ws, p):
    """The map of slots of a working set ws (int64 [K], distinct features
    of [0, p)) and its bitmap: (int32 [p], slot_of[ws[k]] = k, else -1, as
    K3g's ``fused_ws.slot_map`` at S = 1; int32 [ceil(p / 32)],
    ``csc_score.slot_bitmap``); on the card two memsets and a mark launch,
    counted in ``row_sum_counts``."""
    if ws.ndim != 1 or ws.dtype != torch.int64 or not ws.is_contiguous():
        raise TypeError("ws_slot_map: ws must be a contiguous int64 [K] "
                        "tensor")
    if ws.device.type != "cuda":
        slots = slot_map(ws.view(1, -1), p).view(p)
        return slots, slot_bitmap(slots)
    out = slot_map_cuda(ws, p)
    _count(csc_row_sum, site="slot_map")
    return out


def row_sum_counts() -> dict:
    """K5r's launches by call site ("matvec", "update_xb") and the
    update's slot maps ("slot_map")."""
    return dict(csc_row_sum.site_launches)


KERNELS = (cd_epoch_gram, cd_epoch_xb, fused_ws, ws_score, csc_score,
           csc_weighted_col_sq, cd_epoch_gram_block, fused_ws_block,
           csc_score_block, cd_epoch_gram_lanes, cd_epoch_xb_lanes,
           fused_ws_lanes, cd_epoch_gram_block_lanes, fused_ws_block_lanes,
           csc_row_sum, ws_gather)
# the kernels with more than one launch branch
BRANCHED = (cd_epoch_gram, cd_epoch_xb, cd_epoch_gram_block,
            cd_epoch_gram_lanes, cd_epoch_xb_lanes, cd_epoch_gram_block_lanes)
# the lane epochs and heads, counted by shape too
SHAPED = (cd_epoch_gram_lanes, cd_epoch_xb_lanes, cd_epoch_gram_block_lanes,
          fused_ws_lanes, fused_ws_block_lanes)


def reset_launch_counts():
    for k in KERNELS:
        k.launches = 0
    for k in BRANCHED:
        k.branch_launches = dict.fromkeys(BRANCHES, 0)
        k.cluster_launches = {}
    for k in SHAPED:
        k.shape_launches = {}
    ws_gather.bucket_rows = {}
    csc_row_sum.site_launches = dict.fromkeys(
        ("matvec", "update_xb", "slot_map"), 0)
    for t in _ROWS_READ.values():
        t.zero_()


def launch_counts() -> dict:
    return {k.__name__: k.launches for k in KERNELS}


def branch_counts() -> dict:
    """{kernel name: {branch: launches}} for K1, K2, K1b, K1l, K2l and
    K1bl."""
    return {k.__name__: dict(k.branch_launches) for k in BRANCHED}


def cluster_counts() -> dict:
    """{kernel name: {cluster size: launches}} for K1, K2, K1b, K1l, K2l
    and K1bl (1: one CTA): where the plans stepped down, it shows."""
    return {k.__name__: dict(sorted(k.cluster_launches.items()))
            for k in BRANCHED}



def shape_counts() -> dict:
    """{kernel name: {"K=<K> C=<C>": launches}} for K1l, K2l and K1bl and
    {"K=<K> S=<S>": launches} for K3l and K3bl: K rounded up to a power of
    two (the working-set bucket), C the cluster size of the launch's plan
    (1: one CTA a lane), S the lanes."""
    return {k.__name__: {f"K={K} {tag}": n for (K, tag), n in
                         sorted(k.shape_launches.items())} for k in SHAPED}


def gather_counts() -> dict:
    """K3g's launches by ws bucket: {"K=<K>": {"launches": n, "rows": the
    slots filled (S K summed), "distinct": the distinct rows read (U summed;
    on the card, read back from its counter: a host read)}}. U / rows is
    the share of the slots' rows that a gather of distinct rows reads."""
    read = {}
    for t in _ROWS_READ.values():
        for i, v in enumerate(t.tolist()):
            if v:
                read[1 << i] = read.get(1 << i, 0) + v
    return {f"K={kb}": dict(launches=n, rows=rows,
                            distinct=read.get(kb, 0))
            for kb, (n, rows) in sorted(ws_gather.bucket_rows.items())}


reset_launch_counts()
