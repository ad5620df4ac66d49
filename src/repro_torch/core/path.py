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

The chunked driver (``vmap_chunk > 1``: lanes of lambdas in one step) and
``cross_val_path`` belong to the next slice of the port and raise here, as
``obs=`` and ``mesh=`` do.
"""
from __future__ import annotations

import dataclasses
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..bucketing import next_pow2
from .api import lambda_max
from .datafits import Quadratic
from .penalties import L1
from .solver import Problem, make_engine, prepare_problem, solve_problem

__all__ = ["reg_path", "PathResult", "support_metrics"]

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
    the device). The chunked driver (``vmap_chunk > 1``), ``obs=`` and
    ``mesh=`` are not ported yet and raise. Other keywords go to the
    solves (``max_outer``, ``p0``, ``use_ws``, ``eps_inner_frac``,
    ``bucket_policy``).

    Returns a :class:`PathResult`.
    """
    if obs is not None:
        raise NotImplementedError("reg_path(obs=...): observability is not "
                                  "ported yet")
    if mesh is not None:
        raise NotImplementedError("reg_path(mesh=...): mesh mode is not "
                                  "ported yet")
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
        if vmap_chunk > 1:
            raise NotImplementedError(
                "reg_path(vmap_chunk > 1): the chunked driver (lanes of "
                "lambdas in one captured step) is not ported yet; it comes "
                "with cross_val_path in the next slice of the port")
        n_captured = len(engine.capture_s)
        driver = _screened_path if screen is not None else _sequential_path
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
