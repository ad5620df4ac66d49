"""The skglm solver: paper Algorithm 1 (working sets) + Algorithm 2
(Anderson-CD), port of ``repro.core.solver`` (single device, dense or CSC
designs).

The host loop over ``SolveEngine``: per outer iteration one
``engine.step`` (score pass, working-set selection, gather, inner
Anderson-CD solve, scatter) and one host read; on the kernel route on a
card the step is a replay of a captured CUDA graph with the inner loop on
the device. Quadratic datafits use the Gram inner solver,
general datafits the Xb inner solver. ``use_kernels`` switches the head and
the CD epochs to the CUDA kernels (K3 on dense designs, K5 on CSC ones, K1
or K2 inside, K5s for weighted sparse Lipschitz constants; K3b, K5b and K1b
for multitask targets ``y [n, T]``); on a CUDA device it defaults to them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import NamedTuple, Optional

import numpy as np
import torch

from .. import resolve_device
from .engine import EngineConfig, SolveEngine, as_design
from .working_set import BucketPolicy

__all__ = ["solve", "SolveResult", "make_engine", "normalize_weights",
           "Problem", "prepare_problem", "solve_problem"]


def normalize_weights(sample_weight, n, dtype, device):
    """Validate a sample-weight vector and rescale it to sum to n.

    Raises ``ValueError`` on wrong shape, negative or non-finite entries, or
    an all-zero vector. Returns a tensor of ``dtype`` on ``device``.
    """
    if torch.is_tensor(sample_weight):
        sample_weight = sample_weight.detach().cpu().numpy()
    w = np.asarray(sample_weight, dtype=np.float64)
    if w.ndim != 1 or w.shape[0] != n:
        raise ValueError(
            f"sample_weight must be a 1-D vector of length n={n}, got "
            f"shape {w.shape}")
    if not np.all(np.isfinite(w)):
        raise ValueError("sample_weight must be finite")
    if np.any(w < 0):
        raise ValueError("sample_weight must be non-negative")
    s = float(w.sum())
    if s <= 0.0:
        raise ValueError("sample_weight sums to zero: no effective samples")
    return torch.as_tensor(w * (n / s), dtype=dtype, device=device)


@dataclass
class SolveResult:
    """Result of one :func:`solve` call.

    ``beta`` stays on the solve's device. ``n_host_syncs`` counts every
    blocking device-to-host read of the solve, as the reference does: one
    per outer step (the step's one read of kkt, objective, |gsupp|, epochs
    and coverage), plus one probe for an unsized warm start. On the CPU the
    step's conditions are tested in host memory, which is no transfer; its
    one read at the end of the step is counted all the same. The plain
    route on a card (``use_kernels=False``) tests them on the host: one
    read more for the skip decision and for each inner Anderson block.
    ``diagnostics`` holds the per-outer curves (kkt, obj, ws_size, time_s)
    and the host seconds of each step the solve captured (capture_s).
    """
    beta: torch.Tensor
    kkt: float
    converged: bool
    n_outer: int
    n_epochs: int
    kkt_history: list = field(default_factory=list)
    ws_history: list = field(default_factory=list)
    obj_history: list = field(default_factory=list)
    time_history: list = field(default_factory=list)
    n_host_syncs: int = 0
    diagnostics: dict = field(default_factory=dict)


def make_engine(penalty, datafit, *, device=None, M=5, max_epochs=1000,
                accel=True, use_fp_score=None, use_gram="auto",
                use_kernels=None, capture=True):
    """Build a SolveEngine for a (datafit, penalty) family on `device`
    (``None`` means CUDA; raises without a card). ``use_kernels=None``
    means the kernels on a CUDA device and plain torch on the CPU.
    ``capture=False`` runs each step's inner loop on the host on a card
    too, reading its stopping test after every Anderson block: the oracle
    that the captured step is held to, not a path for fits."""
    device = resolve_device(device)
    if use_fp_score is None:
        use_fp_score = not penalty.HAS_SUBDIFF
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    gram = datafit.HAS_GRAM if use_gram == "auto" else bool(use_gram)
    cfg = EngineConfig(M=M, max_epochs=max_epochs, accel=accel,
                       use_fp_score=use_fp_score, gram=gram,
                       use_kernels=bool(use_kernels), capture=capture)
    return SolveEngine(cfg, device)


def solve(X, y, datafit, penalty, *, device=None, tol=1e-6, max_outer=50,
          max_epochs=1000, M=5, p0=64, use_gram="auto", use_fp_score=None,
          eps_inner_frac=0.3, beta0=None, gsupp0=None, n_tasks=None,
          accel=True, use_ws=True, use_kernels=None, engine=None,
          bucket_policy=None, sample_weight=None, obs=None, mesh=None):
    """Solve Problem (1): ``argmin_beta F(X beta) + sum_j g_j(beta_j)``.

    Parameters follow ``repro.core.solve``. ``X`` is a dense ``[n, p]``
    array or tensor, a :class:`DenseDesign`, a scipy sparse matrix or a
    ``repro_torch.sparse.CSCDesign``; ``device=None`` means ``"cuda"`` and
    raises without a card (pass ``device="cpu"`` for the plain torch
    versions). The dtype follows ``X``. ``use_kernels`` (default: on a CUDA
    device) runs the head kernel (K3 dense, K5 sparse) and the CD-epoch
    kernels K1/K2. K5 needs the ELL flag, as in the reference: a scipy
    ``X`` converts with it, a ``CSCDesign`` must have been built with
    ``CSCDesign.from_scipy(X, ell=True)``. A target ``y [n, T]`` (or
    ``n_tasks=T``) is a multitask solve: it needs ``MultitaskQuadratic``
    and a block penalty (``BlockL1``/``BlockMCP``), ``beta0`` and the
    result's ``beta`` are ``[p, T]``, and the kernel route runs the block
    kernels K3b/K5b and K1b. Observability and mesh mode are not ported
    yet and raise at entry.

    Returns a :class:`SolveResult`.
    """
    if obs is not None:
        raise NotImplementedError("solve(obs=...): observability is not "
                                  "ported yet")
    if mesh is not None:
        raise NotImplementedError("solve(mesh=...): mesh mode is not "
                                  "ported yet")
    if n_tasks is None:
        n_tasks = y.shape[1] if getattr(y, "ndim", 1) == 2 else 0
    own_engine = engine is None
    if own_engine:
        engine = make_engine(penalty, datafit, device=device, M=M,
                             max_epochs=max_epochs, accel=accel,
                             use_fp_score=use_fp_score, use_gram=use_gram,
                             use_kernels=use_kernels)
    prob = prepare_problem(engine, X, y, datafit, penalty, n_tasks,
                           sample_weight)
    try:
        return solve_problem(engine, prob, datafit, penalty, tol=tol,
                             max_outer=max_outer, p0=p0, use_ws=use_ws,
                             eps_inner_frac=eps_inner_frac, beta0=beta0,
                             gsupp0=gsupp0, bucket_policy=bucket_policy)
    finally:
        if own_engine:
            # a caller's engine keeps its captured steps for its next solves
            engine.release_graphs()


class Problem(NamedTuple):
    """A problem on the engine's device, as ``solve`` prepares it once:
    the design, the target, the normalized sample weights (or None), the
    per-coordinate Lipschitz constants, the datafit's gradient offset and
    the number of tasks (0: scalar coefficients). A path prepares it once
    for every lam."""
    design: object
    y: torch.Tensor
    w: Optional[torch.Tensor]
    L: torch.Tensor
    offset: torch.Tensor
    n_tasks: int


def prepare_problem(engine, X, y, datafit, penalty, n_tasks=0,
                    sample_weight=None) -> Problem:
    """Move and check a problem for `engine`: the design (``as_design``,
    with the ELL flag on the kernel route), y, the weights, L and the
    offset, after ``engine.validate``'s entry checks."""
    device = engine.device
    design = as_design(X, device, ell=engine.config.use_kernels)
    n_rows, p = design.shape
    y = torch.as_tensor(y, dtype=design.dtype, device=device)
    engine.validate(datafit, penalty, n_tasks,
                    weighted=sample_weight is not None, design=design)
    w = None if sample_weight is None \
        else normalize_weights(sample_weight, n_rows, design.dtype, device)
    L = design.lipschitz(datafit, w, use_kernels=engine.config.use_kernels)
    offset = datafit.grad_offset(p, design.dtype, device)
    return Problem(design, y, w, L, offset, n_tasks)


def solve_problem(engine, prob: Problem, datafit, penalty, *, tol=1e-6,
                  max_outer=50, p0=64, use_ws=True, eps_inner_frac=0.3,
                  beta0=None, gsupp0=None, bucket_policy=None) -> SolveResult:
    """The outer loop of :func:`solve` on a prepared problem (the engine
    keeps its captured steps)."""
    design, y, w, L, offset, n_tasks = prob
    device = engine.device
    p = design.shape[1]
    if not use_ws:
        p0 = p
    policy = bucket_policy or BucketPolicy(p0=p0)
    bshape = (p, n_tasks) if n_tasks else (p,)
    beta = torch.zeros(bshape, dtype=design.dtype, device=device) \
        if beta0 is None else \
        torch.as_tensor(beta0, dtype=design.dtype, device=device).clone()
    Xb = design.matvec(beta)

    res = SolveResult(beta=beta, kkt=float("inf"), converged=False,
                      n_outer=0, n_epochs=0)
    n_captured = len(engine.capture_s)
    t0 = time.perf_counter()
    # first-bucket sizing: cold starts have an empty generalized support;
    # warm starts probe it once (one read per solve)
    if beta0 is None:
        gcount = 0
    elif gsupp0 is not None:
        gcount = int(gsupp0)
    else:
        _, gcount, _ = engine.probe(design, y, beta, Xb, L, offset, datafit,
                                    penalty, w=w)
        res.n_host_syncs += 1
    bucket = policy.first_bucket(gcount, p)

    for t in range(max_outer):
        out = engine.step(bucket, design, y, beta, Xb, L, offset, datafit,
                          penalty, tol, eps_inner_frac, w=w)
        res.n_host_syncs += out.n_syncs
        if not out.covered:
            raise RuntimeError(
                "working-set selection dropped generalized-support "
                "coordinates (bucket too small for |gsupp| — "
                "bucket-policy invariant violated)")
        beta, Xb = out.beta, out.Xb
        res.kkt_history.append(out.kkt)
        res.obj_history.append(out.obj)
        res.time_history.append(time.perf_counter() - t0)
        if out.kkt <= tol:
            res.converged = True
            res.n_outer = t
            break
        res.ws_history.append(bucket)
        res.n_epochs += out.n_epochs
        res.n_outer = t + 1
        bucket = policy.next_bucket(bucket, out.gcount, p)

    res.beta = beta
    res.kkt = res.kkt_history[-1] if res.kkt_history else float("inf")
    res.diagnostics = {
        "kkt": np.asarray(res.kkt_history),
        "obj": np.asarray(res.obj_history),
        "ws_size": np.asarray(res.ws_history, dtype=np.int64),
        "time_s": np.asarray(res.time_history),
        # host seconds of each step captured into a CUDA graph in this solve
        "capture_s": np.asarray(engine.capture_s[n_captured:]),
    }
    return res
