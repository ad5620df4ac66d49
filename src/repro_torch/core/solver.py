"""The skglm solver: paper Algorithm 1 (working sets) + Algorithm 2
(Anderson-CD), port of ``repro.core.solver`` (single device, dense or CSC
designs).

The host loop over ``SolveEngine``: per outer iteration one
``engine.step`` (score pass, working-set selection, gather, inner
Anderson-CD solve, scatter). Quadratic datafits use the Gram inner solver,
general datafits the Xb inner solver. ``use_kernels`` switches the head and
the CD epochs to the CUDA kernels (K3 on dense designs, K5 on CSC ones, K1
or K2 inside, K5s for weighted sparse Lipschitz constants); on a CUDA
device it defaults to them.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from .. import resolve_device
from .engine import EngineConfig, SolveEngine, as_design
from .working_set import BucketPolicy

__all__ = ["solve", "SolveResult", "make_engine", "normalize_weights"]


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
    blocking device-to-host read of the solve: one per outer step head, one
    per inner Anderson block, plus one probe for an unsized warm start.
    ``diagnostics`` holds the per-outer curves (kkt, obj, ws_size, time_s).
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
                use_kernels=None):
    """Build a SolveEngine for a (datafit, penalty) family on `device`
    (``None`` means CUDA; raises without a card). ``use_kernels=None``
    means the kernels on a CUDA device and plain torch on the CPU."""
    device = resolve_device(device)
    if use_fp_score is None:
        use_fp_score = not penalty.HAS_SUBDIFF
    if use_kernels is None:
        use_kernels = device.type == "cuda"
    gram = datafit.HAS_GRAM if use_gram == "auto" else bool(use_gram)
    cfg = EngineConfig(M=M, max_epochs=max_epochs, accel=accel,
                       use_fp_score=use_fp_score, gram=gram,
                       use_kernels=bool(use_kernels))
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
    ``CSCDesign.from_scipy(X, ell=True)``. Observability, mesh mode and
    multitask targets are not ported yet and raise at entry.

    Returns a :class:`SolveResult`.
    """
    if obs is not None:
        raise NotImplementedError("solve(obs=...): observability is not "
                                  "ported yet")
    if mesh is not None:
        raise NotImplementedError("solve(mesh=...): mesh mode is not "
                                  "ported yet")
    if n_tasks or getattr(y, "ndim", 1) == 2:
        raise NotImplementedError("multitask (2-D) targets are not ported "
                                  "yet")
    if engine is None:
        engine = make_engine(penalty, datafit, device=device, M=M,
                             max_epochs=max_epochs, accel=accel,
                             use_fp_score=use_fp_score, use_gram=use_gram,
                             use_kernels=use_kernels)
    device = engine.device
    design = as_design(X, device, ell=engine.config.use_kernels)
    n_rows, p = design.shape
    y = torch.as_tensor(y, dtype=design.dtype, device=device)
    if not use_ws:
        p0 = p
    engine.validate(datafit, penalty, weighted=sample_weight is not None,
                    design=design)
    policy = bucket_policy or BucketPolicy(p0=p0)

    w = None if sample_weight is None \
        else normalize_weights(sample_weight, n_rows, design.dtype, device)
    L = design.lipschitz(datafit, w, use_kernels=engine.config.use_kernels)
    offset = datafit.grad_offset(p, design.dtype, device)
    beta = torch.zeros(p, dtype=design.dtype, device=device) \
        if beta0 is None else \
        torch.as_tensor(beta0, dtype=design.dtype, device=device).clone()
    Xb = design.matvec(beta)

    res = SolveResult(beta=beta, kkt=float("inf"), converged=False,
                      n_outer=0, n_epochs=0)
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
    }
    return res
