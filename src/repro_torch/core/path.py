"""Regularization paths (paper Figure 1 / §E.5; port of the sequential
and gap-safe screened drivers of ``repro.core.path``).

Solves Problem (1) for a decreasing grid of lambdas with warm starts, on
one ``SolveEngine`` and one problem prepared once (the design, the target,
the weights, the Lipschitz constants). On the kernel route on a card each
outer step is a captured CUDA graph, and the penalty's hyper-parameters are
a bound input of it (``core/engine.py``), so the whole path captures each
working-set bucket once and replays it at every lambda, as the reference
compiles each bucket once because lambda is a pytree leaf.
``PathResult.captures`` is the engine's capture count per step key (the
counterpart of the reference's ``retraces``).

Two drivers:
  * sequential: lambda by lambda, each solve warm-started from the last.
  * screened (``screen="gap_safe"``, L1 + Quadratic): per lambda the
    gap-safe rule certifies zeros from the previous solution
    (``core/screening.py``), and the survivors' columns, padded to a
    power-of-two width with empty columns, are solved warm-started and
    scattered back. The column subset is written in place into the slot
    design of its width (``take_columns(..., out=)``), so its captured
    steps replay across lambdas; a subset wider than any slot, or larger
    than its slot's nnz capacity, takes a new slot, which replaces the
    slots no wider than it and their graphs (survivors grow as lambda
    falls), so a dense path holds at most X and one slot as wide as it.
    Each lambda reads the host once more, for the survivors' count and
    nnz.

  * chunked (``vmap_chunk = C > 1``): C lambdas at a time as the lanes of
    ``SolveEngine.chunk`` (one captured graph a bucket and lane count on
    the card: the outer loop on the device, one host read a dispatch);
    each chunk warm-starts every lane from the previous chunk's densest
    solution and escalates the shared bucket when a lane outgrows it. A
    multitask target ``y [n, T]`` runs multitask lanes (betas
    ``[C, p, T]``).

Grid driver: ``cross_val_path`` drives a fixed pool of S = n_folds *
vmap_chunk lanes through the same chunk dispatch. Every fold (or bootstrap
replicate) is a 0/1 (or count) sample-weight row on the same (X, y), so
all lanes share one shape and one captured graph a bucket; the lane
scheduler (``core/lanes.py``) retires converged lanes after each dispatch
and backfills their slots from the (fold, lambda) queue, each fold
warm-starting from its densest finished solution, and the held-out losses
reduce on the device from the lanes' full-row residuals. A multitask
target ``y [n, T]`` (``MultitaskQuadratic`` and a block penalty) runs the
grid on multitask lanes: betas ``[S, p, T]``, residuals ``[S, n, T]``.

``obs=``, ``mesh=`` and the grid's checkpoints are not ported yet and
raise, naming the slice of the port they come with.
"""
from __future__ import annotations

import dataclasses
import sys
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..bucketing import next_pow2
from .api import lambda_max
from .datafits import Quadratic
from .engine import as_design
from .lanes import LaneScheduler
from .penalties import L1
from .solver import (Problem, make_engine, normalize_weights, prepare_problem,
                     solve_problem)
from .working_set import BucketPolicy

__all__ = ["reg_path", "PathResult", "support_metrics", "cross_val_path",
           "GridResult"]

# working-set growth factor of the chunk dispatch's device loop: the host
# mirrors it to tell "a lane outgrew its bucket" from the read gcounts
_GROWTH = 2

# what each option that is not ported yet waits for
_LATER = {
    "obs": "observability is not ported yet: it comes with the port's obs/ "
           "slice",
    "mesh": "mesh mode is not ported yet: it comes with the port's mesh "
            "slice",
    "checkpoint": "grid checkpoints are not ported yet: they come with the "
                  "port's checkpoint/ slice",
}

_ENGINE_KW = ("M", "max_epochs", "accel", "use_fp_score", "use_gram",
              "use_kernels")

_now = time.perf_counter


@dataclass
class PathResult:
    """Result of one :func:`reg_path` sweep.

    ``lambdas`` is the decreasing grid; ``betas`` the solutions on the host,
    ``[n_lambdas, p]`` or ``[n_lambdas, p, T]`` (multitask); ``kkts``,
    ``nnzs``, ``n_epochs``, ``n_outer`` and ``times`` are per lambda (KKT
    violation, nonzero count, inner epochs, outer iterations, wall seconds
    spent on that lambda); ``metrics`` holds ``metric_fn``'s outputs.
    ``screened_fracs`` is the fraction of features screened per lambda
    (gap-safe runs only). ``captures`` is the engine's capture count per
    step key after the sweep (the counterpart of the reference's
    ``retraces``; a key holds the bucket, the design and the shapes, not
    lambda). ``n_host_syncs`` counts the sweep's blocking device-to-host
    reads: its solves' (one per outer step, one probe per warm start),
    lambda_max's when the path computed the grid, one per screened lambda
    and one for the betas at the end (``metric_fn``'s own reads are not
    counted). ``diagnostics`` holds the per-lambda curves (kkt, epochs,
    time_s), the host seconds of each capture of the sweep (capture_s)
    and, on a screened sweep, the solves that refilled a slot design in
    place (slot_refills) and the slot designs made (slots_made).
    """
    lambdas: np.ndarray
    betas: np.ndarray
    kkts: np.ndarray
    nnzs: np.ndarray
    n_epochs: np.ndarray
    metrics: List[dict] = field(default_factory=list)
    n_outer: Optional[np.ndarray] = None
    times: Optional[np.ndarray] = None
    screened_fracs: Optional[np.ndarray] = None
    captures: dict = field(default_factory=dict)
    n_host_syncs: int = 0
    diagnostics: dict = field(default_factory=dict)


def _with_lam(penalty, lam: float):
    return dataclasses.replace(penalty, lam=lam)


def _check_grid(lambdas):
    """Validate a lambda grid and return it sorted DECREASING (warm starts
    run from the sparsest problem down; ``PathResult.lambdas`` records the
    sorted grid the results follow)."""
    lambdas = np.asarray(lambdas, dtype=np.float64)
    if lambdas.ndim != 1 or lambdas.size == 0:
        raise ValueError(
            f"lambdas must be a non-empty 1-D grid, got shape "
            f"{lambdas.shape}")
    if not np.all(np.isfinite(lambdas)):
        raise ValueError("lambdas must be finite")
    if np.any(lambdas < 0):
        raise ValueError("lambdas must be non-negative")
    return np.sort(lambdas)[::-1].copy()


def reg_path(X, y, penalty, datafit=None, *, lambdas=None, n_lambdas=30,
             lambda_min_ratio=1e-2, tol=1e-6,
             metric_fn: Optional[Callable] = None, engine=None, vmap_chunk=1,
             screen=None, sample_weight=None, device=None, obs=None,
             mesh=None, **solve_kw) -> PathResult:
    """Warm-started path over a geometric lambda grid (lam_max ->
    ratio * lam_max), or over `lambdas`.

    Parameters follow ``repro.core.path.reg_path``. ``X`` is a dense
    array or tensor, a scipy sparse matrix or a design; it is moved to the
    engine's device once (``device=None`` means ``"cuda"`` and raises
    without a card; ``device="cpu"`` runs the plain torch versions).
    `penalty` is a template whose ``lam`` is replaced per grid point.
    ``engine`` (``make_engine``) keeps its captured steps across calls; a
    path that makes its own engine releases them at the end. ``screen=
    "gap_safe"`` pre-filters each lambda (L1 + Quadratic only; the rule is
    safe, so the solutions are unchanged). ``sample_weight`` is shared by
    every lambda. ``metric_fn(lam, beta)`` is recorded per lambda (beta on
    the device). ``vmap_chunk = C > 1`` sweeps C lambdas at a time as the
    lanes of one dispatch (``SolveEngine.chunk``; multitask lanes on a
    target ``y [n, T]``); it takes ``p0``, ``max_outer`` and
    ``eps_inner_frac`` and rejects other solve keywords. ``obs=`` and
    ``mesh=`` are
    not ported yet and raise. Other keywords go to the sequential solves
    (``max_outer``, ``p0``, ``use_ws``, ``eps_inner_frac``,
    ``bucket_policy``).

    Returns a :class:`PathResult`.
    """
    if obs is not None:
        raise NotImplementedError(f"reg_path(obs=...): {_LATER['obs']}")
    if mesh is not None:
        raise NotImplementedError(f"reg_path(mesh=...): {_LATER['mesh']}")
    datafit = Quadratic() if datafit is None else datafit
    eng_kw = {k: solve_kw.pop(k) for k in _ENGINE_KW if k in solve_kw}
    own_engine = engine is None
    if own_engine:
        engine = make_engine(penalty, datafit, device=device, **eng_kw)
    elif device is not None and torch.device(device).type != \
            engine.device.type:
        raise ValueError(f"reg_path(device={device!r}, engine=...): the "
                         f"engine runs on {engine.device}")
    n_tasks = y.shape[1] if getattr(y, "ndim", 1) == 2 else 0
    try:
        prob = prepare_problem(engine, X, y, datafit, penalty, n_tasks,
                               sample_weight)
        syncs = 0
        if lambdas is None:
            lmax = lambda_max(prob.design, prob.y, datafit,
                              sample_weight=sample_weight,
                              device=engine.device)
            syncs += 1
            lambdas = lmax * np.geomspace(1.0, lambda_min_ratio, n_lambdas)
        lambdas = _check_grid(lambdas)
        if screen is not None:
            _check_screen(screen, sample_weight, vmap_chunk, penalty,
                          datafit)
        n_captured = len(engine.capture_s)
        if vmap_chunk > 1:
            res = _chunked_path(engine, prob, penalty, datafit, lambdas, tol,
                                int(vmap_chunk), metric_fn, **solve_kw)
        else:
            driver = _screened_path if screen is not None \
                else _sequential_path
            res = driver(engine, prob, penalty, datafit, lambdas, tol,
                         metric_fn, **solve_kw)
    finally:
        if own_engine:
            engine.release_graphs()
    res.n_host_syncs += syncs
    res.captures = dict(engine.captures)
    res.diagnostics.update(
        kkt=res.kkts, epochs=res.n_epochs, time_s=res.times,
        capture_s=np.asarray(engine.capture_s[n_captured:]))
    return res


def _check_screen(screen, sample_weight, vmap_chunk, penalty, datafit):
    """The reference's rejections of a screened path, word for word (its
    mesh rejection has no counterpart: mesh mode raises at entry)."""
    if screen != "gap_safe":
        raise ValueError(f"unknown screening rule {screen!r}; "
                         f"supported: 'gap_safe'")
    if sample_weight is not None:
        raise ValueError("screen='gap_safe' does not support "
                         "sample_weight: the sphere-test certificate "
                         "assumes the unweighted quadratic datafit")
    if vmap_chunk > 1:
        raise ValueError("screen='gap_safe' requires the sequential "
                         "driver (vmap_chunk=1): the per-lambda survivor "
                         "sets have different widths")
    if not (isinstance(penalty, L1) and isinstance(datafit, Quadratic)):
        raise ValueError(
            "screen='gap_safe' needs a duality certificate: only the "
            "convex L1 + Quadratic pair is supported (non-convex "
            "penalties are exactly the case the paper's working sets "
            "handle instead)")


class _Sweep:
    """The per-lambda records of a sweep, and its result."""

    def __init__(self):
        self.betas, self.kkts, self.eps, self.outers = [], [], [], []
        self.times, self.metrics, self.syncs = [], [], 0

    def add(self, beta, res, t0, lam, metric_fn):
        """Record the lambda solved by `res` (None: nothing to solve, beta
        is zero) with its solution `beta` (on the device)."""
        self.betas.append(beta)
        self.kkts.append(res.kkt if res is not None else 0.0)
        self.eps.append(res.n_epochs if res is not None else 0)
        self.outers.append(res.n_outer if res is not None else 0)
        self.syncs += res.n_host_syncs if res is not None else 0
        self.times.append(_now() - t0)
        if metric_fn is not None:
            self.metrics.append(metric_fn(lam, beta))

    def result(self, lambdas, **extra):
        betas = torch.stack(self.betas).cpu().numpy()   # one read
        return PathResult(
            lambdas=lambdas, betas=betas, kkts=np.asarray(self.kkts),
            nnzs=np.asarray([int(np.sum(b != 0)) for b in betas]),
            n_epochs=np.asarray(self.eps), metrics=self.metrics,
            n_outer=np.asarray(self.outers), times=np.asarray(self.times),
            n_host_syncs=self.syncs + 1, **extra)


def _sequential_path(engine, prob, penalty, datafit, lambdas, tol,
                     metric_fn, **solve_kw):
    sweep, beta = _Sweep(), None
    for lam in lambdas:
        t0 = _now()
        res = solve_problem(engine, prob, datafit,
                            _with_lam(penalty, float(lam)), tol=tol,
                            beta0=beta, **solve_kw)
        beta = res.beta
        sweep.add(beta, res, t0, lam, metric_fn)
    return sweep.result(lambdas)


def _screened_path(engine, prob, penalty, datafit, lambdas, tol, metric_fn,
                   **solve_kw):
    """Sequential path with the gap-safe pre-filter (L1 + Quadratic).

    Per lambda: the mask from the previous solution's duality gap, one host
    read of the survivors' count and nnz, the survivors' columns written
    into the slot design of their power-of-two width (at least 16) in
    place, a solve warm-started from the previous solution, scattered back.
    """
    from .screening import gap_safe_mask_design

    design, y = prob.design, prob.y
    p = design.shape[1]
    dev, dtype = design.device, design.dtype
    csc = design.KIND == "csc"
    col_sq = design.col_sq_norms()
    # the nnz of each column (a CSC design's slots are sized by it)
    col_nnz = design.indptr[1:] - design.indptr[:-1] if csc \
        else torch.zeros(p, dtype=torch.int64, device=dev)
    slots: dict = {}                    # width -> its slot design
    refills = made = 0
    beta_full = torch.zeros(p, dtype=dtype, device=dev)
    sweep, fracs = _Sweep(), []
    for lam in lambdas:
        t0 = _now()
        mask = gap_safe_mask_design(design, y, beta_full, float(lam),
                                    use_kernels=engine.config.use_kernels,
                                    col_sq=col_sq)
        n_surv, surv_nnz = torch.stack([
            torch.sum(mask), torch.sum(torch.where(mask, col_nnz, 0))
        ]).tolist()                                      # the one read
        sweep.syncs += 1
        fracs.append(1.0 - n_surv / p)
        beta_full = torch.where(mask, beta_full, 0.0)
        if not n_surv:
            beta_full = torch.zeros_like(beta_full)
            sweep.add(beta_full, None, t0, lam, metric_fn)
            continue
        width = min(p, next_pow2(max(n_surv, 16)))
        # survivors first, in index order; -1 pads the width
        order = torch.argsort((~mask).to(torch.int8), stable=True)[:width]
        idx = torch.where(torch.arange(width, device=dev) < n_surv, order,
                          -1)
        valid, sel = idx >= 0, torch.clamp(idx, min=0)
        sub, refilled = _slot(slots, engine, design, idx, width, surv_nnz,
                              csc)
        refills += refilled
        made += not refilled
        sub_prob = Problem(sub, y, None,
                           torch.where(valid, prob.L[sel], 0.0),
                           torch.where(valid, prob.offset[sel], 0.0), 0)
        res = solve_problem(engine, sub_prob, datafit,
                            _with_lam(penalty, float(lam)), tol=tol,
                            beta0=torch.where(valid, beta_full[sel], 0.0),
                            **solve_kw)
        # scatter back; the padding's coefficients land in a spare slot p
        ext = torch.zeros(p + 1, dtype=dtype, device=dev)
        ext[torch.where(valid, idx, p)] = res.beta
        beta_full = ext[:p]
        sweep.add(beta_full, res, t0, lam, metric_fn)
        del sub, sub_prob      # a slot outgrown next lambda is freed then
    return sweep.result(lambdas, screened_fracs=np.asarray(fracs),
                        diagnostics=dict(slot_refills=refills,
                                         slots_made=made))


def _slot(slots, engine, design, idx, width, nnz, csc):
    """(the survivors' design, whether a slot was refilled): written in
    place into the slot of this width when it has room (a CSC slot's nnz
    capacity), else into a new slot (power-of-two capacity) that replaces
    every slot no wider than it, with their captured steps."""
    out = slots.get(width)
    if out is not None and (not csc or
                            out.capacity >= nnz + out.max_col_nnz):
        kw = dict(nnz=nnz) if csc else {}
        return design.take_columns(idx, out=out, **kw), True
    for w in [w for w in slots if w <= width]:
        engine.drop_graphs(slots.pop(w))
    slots[width] = design.take_columns(idx, nnz=nnz) if csc \
        else design.take_columns(idx)
    return slots[width], False


def _chunked_path(engine, prob, penalty, datafit, lambdas, tol, chunk,
                  metric_fn, *, p0=64, max_outer=50, eps_inner_frac=0.3,
                  **solve_kw):
    """Chunked sweep: C lambdas a dispatch with the warm-start handoff
    between chunks (the reference's ``_chunked_path``)."""
    if solve_kw:
        raise ValueError(
            f"vmap_chunk > 1 does not support solve kwargs "
            f"{sorted(solve_kw)}; use the sequential driver (vmap_chunk=1)")
    design, y, w, L, offset = prob.design, prob.y, prob.w, prob.L, \
        prob.offset
    p = design.shape[1]
    policy = BucketPolicy(p0=p0)
    bshape = (p, prob.n_tasks) if prob.n_tasks else (p,)
    beta_prev = torch.zeros(bshape, dtype=design.dtype, device=engine.device)
    Xb_prev = design.matvec(beta_prev)
    gcount_prev = 0
    reads0 = engine.n_chunk_reads
    betas, kkts, n_eps, outers, times = [], [], [], [], []
    for lo in range(0, len(lambdas), chunk):
        t_chunk = _now()
        lams_c = lambdas[lo:lo + chunk]
        C = len(lams_c)
        # every lane warm-starts from the previous chunk's densest solution
        betas0 = beta_prev.expand((C,) + bshape).contiguous()
        Xbs0 = Xb_prev.expand((C,) + tuple(Xb_prev.shape)).contiguous()
        bucket = policy.first_bucket(gcount_prev, p)
        iters_left, chunk_iters = max_outer, 0
        chunk_eps = np.zeros(C, np.int64)
        while True:
            out = engine.chunk(bucket, design, y, lams_c, betas0, Xbs0, L,
                               offset, datafit, penalty, tol, eps_inner_frac,
                               iters_left, growth=_GROWTH, w=w)
            iters_left -= out.n_outer
            chunk_iters += out.n_outer
            chunk_eps += out.n_eps
            if bool(np.all(out.kkts <= tol)) or bucket >= p or \
                    iters_left <= 0:
                break
            # a lane outgrew the bucket: escalate and resume from the
            # partially converged lanes
            bucket = max(policy.escalate(bucket, p),
                         policy.next_bucket(bucket, int(np.max(out.gcounts)),
                                            p))
            betas0, Xbs0 = out.betas, out.Xbs
        betas.extend(out.betas.unbind(0))
        kkts.extend(out.kkts.tolist())
        n_eps.extend(chunk_eps.tolist())
        outers.extend([chunk_iters] * C)
        # the lanes ran together: each lambda is stamped with its chunk's
        # duration
        times.extend([_now() - t_chunk] * C)
        beta_prev, Xb_prev = out.betas[-1], out.Xbs[-1]
        gcount_prev = int(out.gcounts[-1])
    metrics = [metric_fn(lam, b) for lam, b in zip(lambdas, betas)] \
        if metric_fn is not None else []
    betas_np = torch.stack(betas).cpu().numpy()            # one read
    return PathResult(
        lambdas=lambdas, betas=betas_np, kkts=np.asarray(kkts),
        nnzs=np.asarray([int(np.sum(b != 0)) for b in betas_np]),
        n_epochs=np.asarray(n_eps), metrics=metrics,
        n_outer=np.asarray(outers), times=np.asarray(times),
        n_host_syncs=engine.n_chunk_reads - reads0 + 1)


# --------------------------------------------------------------- grid driver
@dataclass
class GridResult:
    """Result of one :func:`cross_val_path` (fold x lambda) grid sweep.

    ``lambdas`` is the decreasing grid; ``betas`` the per-replicate
    solutions ``[n_folds, n_lambdas, p]`` (``[n_folds, n_lambdas, p, T]``
    multitask) on the host; ``cv_loss`` the
    held-out mean datafit loss per (fold, lambda) (the datafit's
    ``value``: half-MSE for quadratic losses, mean log-loss for logistic),
    NaN for a replicate without held-out rows; ``cv_mean`` / ``cv_std``
    its mean and standard deviation over the valid folds; ``best_index``
    and ``best_lambda`` the argmin of ``cv_mean``; ``kkts`` and
    ``n_epochs`` per (fold, lambda); ``fold_weights`` the raw train-weight
    matrix ``[n_folds, n]`` the grid solved. ``n_outer`` counts the outer
    steps of every dispatch; ``times`` and ``occupancy`` are per scheduler
    round (its seconds, and the fraction of the lane pool holding live
    work at its dispatch); ``n_rounds`` the rounds (= dispatches).
    ``captures`` is the engine's capture count per step key after the
    sweep (the counterpart of the reference's ``retraces``; a chunk key
    holds the bucket, the design, the lane count and the shapes) and
    ``capture_s`` the host seconds of this sweep's captures;
    ``n_dispatches`` and ``n_host_syncs`` the sweep's dispatches and
    blocking reads (one a dispatch on the kernel route on a card and on
    the CPU; ``capture=False`` on a card reads at every condition).
    ``diagnostics`` mirrors the sweep counters.
    """
    lambdas: np.ndarray
    betas: np.ndarray
    cv_loss: np.ndarray
    cv_mean: np.ndarray
    cv_std: np.ndarray
    best_index: int
    best_lambda: float
    kkts: np.ndarray
    n_epochs: np.ndarray
    fold_weights: np.ndarray
    n_outer: int = 0
    times: Optional[np.ndarray] = None
    occupancy: Optional[np.ndarray] = None
    n_rounds: int = 0
    captures: dict = field(default_factory=dict)
    capture_s: Optional[np.ndarray] = None
    n_dispatches: int = 0
    n_host_syncs: int = 0
    diagnostics: dict = field(default_factory=dict)


def heldout_losses(datafit, Xbs, y, H):
    """The lanes' held-out mean losses [S]: lane s's datafit value at its
    residual Xbs[s] [n] (or [n, T] multitask) under its held-out weight row
    H[s] [n] (weights normalized to mean 1 over the held-out rows)."""
    return torch.vmap(lambda x, h: datafit.value(x, y, h))(Xbs, H)


def _emit_progress(progress, **ev):
    """Deliver one grid-progress event: ``progress`` is a callable (gets the
    event dict) or any other truthy value (one stderr line per event)."""
    if not progress:
        return
    if callable(progress):
        progress(dict(ev))
        return
    print("[cross_val_path] "
          + " ".join(f"{k}={v}" for k, v in ev.items()), file=sys.stderr)


def cross_val_path(X, y, datafit=None, penalty=None, *, lambdas=None,
                   n_lambdas=30, lambda_min_ratio=1e-2, cv=5,
                   fold_weights=None, sample_weight=None, seed=0, tol=1e-6,
                   vmap_chunk=10, p0=64, max_outer=50, eps_inner_frac=0.3,
                   sync_every=8, checkpoint=None, resume=None, engine=None,
                   device=None, mesh=None, obs=None, progress=None,
                   **engine_kw) -> GridResult:
    """Solve a (fold x lambda) grid at once through the chunk dispatch.

    Parameters follow ``repro.core.cross_val_path``: every fold (or
    bootstrap replicate, ``fold_weights [n_replicates, n]``) is a sample
    weight row on the same (X, y) (its held-out rows are its zero-weight
    rows); a fixed pool of ``n_folds * vmap_chunk`` lanes runs the
    (fold, lambda) cells, at most ``sync_every`` outer steps a dispatch,
    one host read a dispatch, converged lanes retired and backfilled from
    the queue after each (``LaneScheduler``). ``X`` is dense, scipy sparse
    or a design, moved to the engine's device once (``device=None`` means
    ``"cuda"`` and raises without a card). ``engine`` keeps its captured
    steps across calls; a grid that makes its own engine releases them.
    ``progress`` (a callable, or True for stderr lines) receives one
    "bucket" event a dispatch and a "chunk" event on every round that
    retired lanes. ``**engine_kw`` is restricted to the engine's keys (M,
    max_epochs, accel, use_fp_score, use_gram, use_kernels). A target
    ``y [n, T]`` (``MultitaskQuadratic`` and ``BlockL1``/``BlockMCP``)
    runs multitask lanes. ``checkpoint=``/``resume=``, ``obs=`` and
    ``mesh=`` are not ported yet and raise.

    Returns a :class:`GridResult`.
    """
    for name, val in (("checkpoint", checkpoint), ("resume", resume)):
        if val is not None:
            raise NotImplementedError(
                f"cross_val_path({name}=...): {_LATER['checkpoint']}")
    if obs is not None:
        raise NotImplementedError(f"cross_val_path(obs=...): {_LATER['obs']}")
    if mesh is not None:
        raise NotImplementedError(
            f"cross_val_path(mesh=...): {_LATER['mesh']}")
    datafit = Quadratic() if datafit is None else datafit
    penalty = L1(1.0) if penalty is None else penalty
    unsupported = set(engine_kw) - set(_ENGINE_KW)
    if unsupported:
        raise ValueError(f"cross_val_path does not support kwargs "
                         f"{sorted(unsupported)}")
    own_engine = engine is None
    if own_engine:
        engine = make_engine(penalty, datafit, device=device, **engine_kw)
    elif device is not None and torch.device(device).type != \
            engine.device.type:
        raise ValueError(f"cross_val_path(device={device!r}, engine=...): "
                         f"the engine runs on {engine.device}")
    try:
        return _grid(engine, X, y, datafit, penalty, lambdas, n_lambdas,
                     lambda_min_ratio, cv, fold_weights, sample_weight, seed,
                     tol, vmap_chunk, p0, max_outer, eps_inner_frac,
                     sync_every, progress)
    finally:
        if own_engine:
            engine.release_graphs()


def _grid(engine, X, y, datafit, penalty, lambdas, n_lambdas,
          lambda_min_ratio, cv, fold_weights, sample_weight, seed, tol,
          vmap_chunk, p0, max_outer, eps_inner_frac, sync_every, progress):
    """The grid sweep of :func:`cross_val_path` on `engine`."""
    from ..data.folds import kfold_weights

    dev = engine.device
    design = as_design(X, dev, ell=engine.config.use_kernels)
    n, p = design.shape
    dtype = design.dtype
    y = torch.as_tensor(y, dtype=dtype, device=dev)
    # replicate weights: 0/1 k-fold membership or explicit counts
    if fold_weights is not None:
        W = np.asarray(fold_weights, np.float64)
        if W.ndim != 2 or W.shape[1] != n:
            raise ValueError(
                f"fold_weights must be [n_replicates, n={n}], got shape "
                f"{W.shape}")
        if not np.all(np.isfinite(W)) or np.any(W < 0):
            raise ValueError("fold_weights must be finite and non-negative")
    else:
        W = kfold_weights(n, cv, seed=seed)
    H = np.where(W == 0.0, 1.0, 0.0)          # held-out indicator per fold
    if sample_weight is not None:
        sw = normalize_weights(sample_weight, n, torch.float64,
                               "cpu").numpy()
        W = W * sw[None, :]
        H = H * sw[None, :]
    train_sums = W.sum(axis=1)
    if np.any(train_sums <= 0):
        raise ValueError("every fold/replicate needs at least one training "
                         "sample with positive weight")
    held_sums = H.sum(axis=1)
    valid_fold = held_sums > 0
    if not valid_fold.any():
        raise ValueError(
            "no replicate has any held-out rows (every fold_weights row is "
            "all-nonzero): there is nothing to cross-validate on — held-out "
            "rows are a replicate's zero-weight rows")
    if lambdas is None:
        lmax = lambda_max(design, y, datafit, sample_weight=sample_weight,
                          device=dev)
        lambdas = lmax * np.geomspace(1.0, lambda_min_ratio, n_lambdas)
    lambdas = _check_grid(lambdas)
    nlam = len(lambdas)
    n_tasks = y.shape[1] if y.ndim == 2 else 0
    engine.validate(datafit, penalty, n_tasks, weighted=True, design=design)

    # train weights normalized to sum n (the row-subset scaling), held-out
    # weights to mean 1 over the held-out rows
    Wd = torch.as_tensor(W * (n / train_sums)[:, None], dtype=dtype,
                         device=dev)
    Hd = torch.as_tensor(
        H * np.where(valid_fold, n / np.maximum(held_sums, 1e-300),
                     0.0)[:, None], dtype=dtype, device=dev)
    F = W.shape[0]
    # one weighted column-square pass a fold (K5s on a CSC design on the
    # kernel route)
    L_folds = torch.stack([
        design.lipschitz(datafit, Wd[f], use_kernels=engine.config.use_kernels)
        for f in range(F)])
    offset = datafit.grad_offset(p, dtype, dev)
    policy = BucketPolicy(p0=p0)
    chunk = max(1, min(int(vmap_chunk), nlam))
    S = F * chunk                          # the fixed lane pool
    sync_every = max(1, int(sync_every))
    sched = LaneScheduler(F, nlam, S, max_outer)

    # host lane maps, kept for dead slots too
    lams_l = np.zeros(S, np.float64)
    fold_host = np.zeros(S, np.int64)
    kkts_out = np.zeros((F, nlam))
    eps_out = np.zeros((F, nlam), np.int64)
    item_done = np.zeros((F, nlam), np.uint8)
    times, occupancy = [], []
    round_idx, total_outer = 0, 0
    dispatches0, reads0 = engine.n_dispatches, engine.n_chunk_reads
    n_captured = len(engine.capture_s)
    bshape = (p, n_tasks) if n_tasks else (p,)
    xshape = (n, n_tasks) if n_tasks else (n,)
    betas_l = torch.zeros((S,) + bshape, dtype=dtype, device=dev)
    Xbs_l = torch.zeros((S,) + xshape, dtype=dtype, device=dev)
    bank_b = torch.zeros((F,) + bshape, dtype=dtype, device=dev)
    bank_x = torch.zeros((F,) + xshape, dtype=dtype, device=dev)
    out_betas = torch.zeros((F, nlam) + bshape, dtype=dtype, device=dev)
    out_loss = torch.zeros((F, nlam), dtype=dtype, device=dev)
    for s, f, j in sched.fill():
        lams_l[s], fold_host[s] = lambdas[j], f
    bucket = policy.first_bucket(0, p)

    n_chunks = -(-nlam // chunk)        # nominal lower bound on rounds
    t0 = _now()
    dirty = True                        # lane tensors need gathering
    while not sched.done:
        t_round = _now()
        if dirty:
            fold_dev = torch.as_tensor(fold_host, device=dev)
            w_lanes = Wd[fold_dev]
            L_lanes = L_folds[fold_dev]
            H_lanes = Hd[fold_dev]
            dirty = False
        occupancy.append(sched.occupancy)
        mo = sched.dispatch_budget(sync_every)
        bucket_used = bucket
        out = engine.chunk(bucket, design, y, lams_l, betas_l, Xbs_l,
                           L_lanes, offset, datafit, penalty, tol,
                           eps_inner_frac, mo, growth=_GROWTH, w=w_lanes)
        betas_l, Xbs_l = out.betas, out.Xbs
        kkts_c, gcounts_c = out.kkts, out.gcounts
        total_outer += out.n_outer
        rep = sched.observe(kkts_c, gcounts_c, out.n_eps, out.n_outer, tol)
        if rep.retired:
            # harvest on the device: dead lanes never reach the outputs
            loss_l = heldout_losses(datafit, Xbs_l, y, H_lanes)
            sl = torch.as_tensor([r.slot for r in rep.retired], device=dev)
            fl = np.array([r.fold for r in rep.retired])
            jl = np.array([r.lam_idx for r in rep.retired])
            fl_d = torch.as_tensor(fl, device=dev)
            jl_d = torch.as_tensor(jl, device=dev)
            out_betas[fl_d, jl_d] = betas_l[sl]
            out_loss[fl_d, jl_d] = loss_l[sl]
            kkts_out[fl, jl] = kkts_c[[r.slot for r in rep.retired]]
            eps_out[fl, jl] = [r.n_epochs for r in rep.retired]
            item_done[fl, jl] = 1
        if rep.bank_updates:
            fb = torch.as_tensor([u[0] for u in rep.bank_updates],
                                 device=dev)
            sb = torch.as_tensor([u[1] for u in rep.bank_updates],
                                 device=dev)
            bank_b[fb] = betas_l[sb]
            bank_x[fb] = Xbs_l[sb]
        assigns = sched.fill()
        if assigns:
            sl_np = np.array([a[0] for a in assigns])
            fl = np.array([a[1] for a in assigns])
            jl = np.array([a[2] for a in assigns])
            sl = torch.as_tensor(sl_np, device=dev)
            fl_d = torch.as_tensor(fl, device=dev)
            betas_l[sl] = bank_b[fl_d]
            Xbs_l[sl] = bank_x[fl_d]
            lams_l[sl_np] = lambdas[jl]
            fold_host[sl_np] = fl
            dirty = True
        # the next dispatch's bucket: escalate when a continuing lane
        # outgrew it; a round where every lane retired may step down to
        # what the fresh warm starts need
        cont = rep.continuing
        if len(cont):
            if bucket < p and np.any(_GROWTH * gcounts_c[cont] > bucket):
                bucket = max(policy.escalate(bucket, p),
                             policy.next_bucket(
                                 bucket, int(np.max(gcounts_c[cont])), p))
            if assigns:
                bucket = max(bucket, max(
                    policy.first_bucket(int(sched.bank_gcount[f]), p)
                    for f in fl))
        elif assigns:
            bucket = max(policy.first_bucket(int(sched.bank_gcount[f]), p)
                         for f in fl)
        round_idx += 1
        times.append(_now() - t_round)
        elapsed = _now() - t0
        lambdas_done = int(np.sum(np.all(item_done == 1, axis=0)))
        ev = dict(chunk=round_idx - 1, n_chunks=n_chunks,
                  bucket=int(bucket_used),
                  lanes_converged=int(np.sum(kkts_c <= tol)), n_lanes=S,
                  lambdas_done=lambdas_done, n_lambdas=nlam,
                  elapsed_s=elapsed)
        _emit_progress(progress, event="bucket", **ev)
        if rep.retired:
            _emit_progress(progress, event="chunk", **ev,
                           eta_s=elapsed / max(lambdas_done, 1)
                           * (nlam - lambdas_done))

    betas_out = out_betas.cpu().numpy().astype(np.float64)
    loss_out = out_loss.cpu().numpy().astype(np.float64)
    loss_out[~valid_fold] = np.nan
    cv_mean = np.mean(loss_out[valid_fold], axis=0)
    cv_std = np.std(loss_out[valid_fold], axis=0)
    best = int(np.argmin(cv_mean)) if np.isfinite(cv_mean).any() else 0
    occ = np.asarray(occupancy)
    n_disp = engine.n_dispatches - dispatches0
    n_syncs = engine.n_chunk_reads - reads0
    return GridResult(
        lambdas=lambdas, betas=betas_out, cv_loss=loss_out, cv_mean=cv_mean,
        cv_std=cv_std, best_index=best, best_lambda=float(lambdas[best]),
        kkts=kkts_out, n_epochs=eps_out, fold_weights=W, n_outer=total_outer,
        times=np.asarray(times), occupancy=occ, n_rounds=round_idx,
        captures=dict(engine.captures),
        capture_s=np.asarray(engine.capture_s[n_captured:]),
        n_dispatches=n_disp, n_host_syncs=n_syncs,
        diagnostics={"grid.n_host_syncs": n_syncs,
                     "grid.n_dispatches": n_disp,
                     "grid.n_outer": total_outer,
                     "grid.n_rounds": round_idx,
                     "grid.lane_occupancy":
                         float(occ.mean()) if occ.size else 1.0})


def _np(a):
    return a.detach().cpu().numpy() if torch.is_tensor(a) else np.asarray(a)


def support_metrics(beta, beta_true, X=None, y=None):
    """F1 of support recovery + estimation/prediction errors (Figure 1);
    arrays or tensors (read to the host)."""
    beta = _np(beta)
    beta_true = _np(beta_true)
    s_hat = beta != 0
    s_true = beta_true != 0
    tp = int(np.sum(s_hat & s_true))
    prec = tp / max(int(np.sum(s_hat)), 1)
    rec = tp / max(int(np.sum(s_true)), 1)
    f1 = 2 * prec * rec / max(prec + rec, 1e-30)
    out = {
        "nnz": int(np.sum(s_hat)),
        "precision": prec, "recall": rec, "f1": f1,
        "exact_support": bool(np.array_equal(s_hat, s_true)),
        "est_err": float(np.linalg.norm(beta - beta_true)
                         / max(np.linalg.norm(beta_true), 1e-30)),
    }
    if X is not None and y is not None:
        resid = _np(y) - _np(X) @ beta
        out["pred_err"] = float(np.linalg.norm(resid) ** 2 / len(resid))
    return out
