"""The solve engine, single-device (port of ``repro.core.engine``).

One outer iteration of Algorithm 1 is ``SolveEngine.step``: score pass,
working-set selection, gather, inner Anderson-CD solve, scatter. It runs
eagerly on the design's device.

Layering (bottom-up):

  SubproblemSolver      Algorithm 2 on a fixed-size working set: blocks of M
    GramSolver          cyclic CD epochs + guarded Anderson extrapolation.
    XbSolver            Gram form for quadratic datafits (state q = G beta),
                        Xb form for general datafits (state Xb). Each epoch
                        runs either plain torch (core/cd.py) or, with
                        ``use_kernels``, the kernel wrappers K1 / K2
                        (kernels/ops.py).
  SolveEngine           the outer step; with ``use_kernels`` its head is the
                        fused kernel K3 on a dense design (one pass over X
                        yields the scores, the gradient and the candidate
                        columns), and on a CSC design the sparse score
                        kernel K5 followed by the selection and the window
                        gather (the reference's two-pass sparse head).

Host reads: the reference runs the inner loop as a device ``while_loop``
and reads back once per outer iteration. Eager torch must read the inner
stopping test on the host, so a step costs one read for its head (kkt,
objective, support count, coverage flag, in one transfer) plus one per
inner Anderson block (that block's kkt and support count). Every such read
is counted in ``StepResult.n_syncs``.

Designs: ``DenseDesign`` keeps one feature-major copy of X (``Xt`` is a
contiguous [p, n] tensor, so the score pass, the kernels' per-feature dots
and the working-set gathers all read contiguous rows; ``X`` is its
transposed view). ``repro_torch.sparse.CSCDesign`` keeps the window-padded
CSC arrays and densifies only the working-set columns. Both offer
``score``, ``gather_ws`` (-> ``(Xt_ws [K, n], aux)``), ``update_xb``,
``matvec`` and ``lipschitz``; ``aux`` is None for a dense design and the
(rows, vals) column windows for a CSC one.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..kernels import ops as kops
from ..kernels.common import check_score_kernel_penalty, penalty_params
from .anderson import anderson_extrapolate
from .cd import cd_epoch_gram, cd_epoch_xb
from .working_set import (candidate_columns, scatter_ws, select_working_set,
                          violation_scores)

__all__ = ["EngineConfig", "SolveEngine", "SubproblemSolver", "GramSolver",
           "XbSolver", "KERNEL_DATAFIT_KINDS", "DenseDesign", "as_design",
           "WorkingSetContext", "StepResult", "PALLAS_SPARSE_ELL_ERROR"]


# datafit class name -> kernels/cd_epoch.py datafit kind (K2 hard-codes the
# raw-gradient formula per kind)
KERNEL_DATAFIT_KINDS = {
    "Quadratic": "quadratic",
    "Logistic": "logistic",
    "QuadraticSVC": "svc",
}

# the reference's rejection of a kernel solve on a sparse design without
# the ELL layout, word for word (repro.core.engine.PALLAS_SPARSE_ELL_ERROR)
PALLAS_SPARSE_ELL_ERROR = (
    "backend='pallas' on a sparse design requires the ELL score layout: "
    "build it with CSCDesign.from_scipy(X, ell=True); see the supported-path "
    "matrix in README.md (Pallas column) and DESIGN.md §8.4")


@dataclass(frozen=True)
class DenseDesign:
    """Dense design held feature-major: ``Xt`` is a contiguous [p, n]
    tensor and ``X`` ([n, p]) its transposed view."""
    Xt: torch.Tensor

    KIND = "dense"

    @classmethod
    def from_dense(cls, X, device):
        """Design of an [n, p] array or tensor, on `device`, dtype kept."""
        X = torch.as_tensor(X, device=device)
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D [n, p], got shape {tuple(X.shape)}")
        return cls(X.t().contiguous())

    @property
    def X(self):
        return self.Xt.T

    @property
    def shape(self):
        return (self.Xt.shape[1], self.Xt.shape[0])

    @property
    def dtype(self):
        return self.Xt.dtype

    @property
    def device(self):
        return self.Xt.device

    @property
    def n_rows(self):
        return self.Xt.shape[1]

    @property
    def width(self):
        return self.Xt.shape[0]

    def score(self, raw, use_kernels=False):
        """X.T @ raw (the dense kernel head is K3, in the engine)."""
        return self.Xt @ raw

    def gather_ws(self, ws):
        """Feature-major working-set columns (Xt[ws] [K, n], None)."""
        return self.Xt[ws], None

    def update_xb(self, Xb, Xt_ws, aux, delta):
        """Xb + X_ws @ delta."""
        return Xb + delta @ Xt_ws

    def matvec(self, beta):
        """X @ beta."""
        return self.Xt.T @ beta

    def lipschitz(self, datafit, w=None, use_kernels=False):
        return datafit.lipschitz(self.X) if w is None \
            else datafit.lipschitz(self.X, w)


def is_scipy_sparse(X) -> bool:
    """Structural check: scipy sparse without importing scipy."""
    return hasattr(X, "tocsc") and hasattr(X, "nnz")


def as_design(X, device, ell=False):
    """A design on `device`: designs pass through (moved if needed), scipy
    sparse matrices convert to a CSCDesign (with the ELL flag `ell`),
    anything else is a dense array."""
    if isinstance(X, DenseDesign):
        return X if X.device == device else DenseDesign(X.Xt.to(device))
    if getattr(X, "KIND", None) == "csc":
        return X if X.device == device else X.to(device)
    if is_scipy_sparse(X):
        from ..sparse.matrix import CSCDesign
        return CSCDesign.from_scipy(X, ell=ell, device=device)
    return DenseDesign.from_dense(X, device)


def _df_value(datafit, Xb, y, w):
    return datafit.value(Xb, y) if w is None else datafit.value(Xb, y, w)


def _df_raw(datafit, Xb, y, w):
    return datafit.raw_grad(Xb, y) if w is None \
        else datafit.raw_grad(Xb, y, w)


def _read(*vals):
    """One blocking device-to-host transfer of several 0-d tensors."""
    dtype = vals[0].dtype
    return torch.stack([v.to(dtype) for v in vals]).tolist()


@dataclass(frozen=True)
class EngineConfig:
    """Solver configuration."""
    M: int = 5
    max_epochs: int = 1000
    accel: bool = True
    use_fp_score: bool = False
    gram: bool = True
    use_kernels: bool = False       # K1-K3 (the counterpart of "pallas")

    @property
    def max_blocks(self) -> int:
        return max(1, math.ceil(self.max_epochs / self.M))


@dataclass(frozen=True)
class WorkingSetContext:
    """Gathered per-working-set tensors consumed by a SubproblemSolver."""
    Xt_ws: torch.Tensor              # [K, n] gathered design, feature-major
    y: torch.Tensor
    L_ws: torch.Tensor               # [K]
    offset_ws: torch.Tensor          # [K]
    datafit: object
    penalty: object
    G: torch.Tensor = None           # [K, K] column-major (Gram solvers only)
    c: torch.Tensor = None           # [K] (Gram solvers only)
    w: torch.Tensor = None           # per-sample weights (Xb solvers only;
                                     # the Gram form bakes w into G)
    Xb_base: torch.Tensor = None     # Xb0 - X_ws beta_ws0: residual of the
                                     # nonzero coordinates OUTSIDE ws (Xb
                                     # solvers; Box pins coords at C with
                                     # empty generalized support)


@dataclass
class InnerResult:
    beta: torch.Tensor
    aux: torch.Tensor
    n_epochs: int
    kkt: float
    gcount: int                      # |gsupp(beta)| of the returned beta
    n_syncs: int


class SubproblemSolver:
    """Algorithm 2 on a fixed working set: blocks of M cyclic CD epochs, one
    guarded Anderson extrapolation per block, loop until the restricted KKT
    violation drops under eps (one host read per block)."""

    def __init__(self, config: EngineConfig):
        self.config = config

    def prepare(self, ctx, beta0):
        raise NotImplementedError

    def refresh(self, ctx, beta):
        raise NotImplementedError

    def epoch(self, ctx, beta, aux):
        raise NotImplementedError

    def objective(self, ctx, beta, aux):
        raise NotImplementedError

    def gradient(self, ctx, beta, aux):
        raise NotImplementedError

    def solve(self, ctx, beta0, eps, aux0=None) -> InnerResult:
        cfg = self.config
        beta = beta0
        aux = self.prepare(ctx, beta0) if aux0 is None else aux0
        k, kkt, gcount = 0, math.inf, 0
        while k < cfg.max_blocks and kkt > eps:
            hist = [beta]
            for _ in range(cfg.M):
                beta, aux = self.epoch(ctx, beta, aux)
                hist.append(beta)
            if cfg.accel:
                be = ctx.penalty.prox(anderson_extrapolate(torch.stack(hist)),
                                      0.0)
                auxe = self.refresh(ctx, be)
                take = self.objective(ctx, be, auxe) < \
                    self.objective(ctx, beta, aux)
                beta = torch.where(take, be, beta)
                aux = torch.where(take, auxe, aux)
            grad = self.gradient(ctx, beta, aux)
            kkt_d = torch.max(violation_scores(
                ctx.penalty, beta, grad, ctx.L_ws,
                use_fixed_point=cfg.use_fp_score))
            gs = torch.sum(ctx.penalty.generalized_support(beta))
            kkt, gcount = _read(kkt_d, gs)
            gcount = int(gcount)
            k += 1
        return InnerResult(beta, aux, k * cfg.M, kkt, gcount, k)


class GramSolver(SubproblemSolver):
    """Quadratic datafits: state q = G beta stays K-sized (on chip for the
    whole epoch in K1)."""

    def prepare(self, ctx, beta0):
        return ctx.G @ beta0

    def refresh(self, ctx, beta):
        return ctx.G @ beta

    def epoch(self, ctx, beta, aux):
        if self.config.use_kernels:
            return kops.cd_epoch_gram(ctx.G, ctx.c, beta, aux, ctx.L_ws,
                                      type(ctx.penalty),
                                      penalty_params(ctx.penalty), epochs=1)
        return cd_epoch_gram(ctx.G, ctx.c, beta, aux, ctx.L_ws, ctx.penalty)

    def objective(self, ctx, beta, aux):
        return (0.5 * torch.dot(beta, aux) - torch.dot(ctx.c, beta)
                + ctx.penalty.value(beta))

    def gradient(self, ctx, beta, aux):
        return aux - ctx.c


class XbSolver(SubproblemSolver):
    """General datafits (Algorithm 3 verbatim): state Xb = X_ws beta
    (+ ctx.Xb_base, the constant contribution of nonzero coordinates outside
    the working set, so Anderson candidates rebuilt by `refresh` keep it)."""

    def _rebuild(self, ctx, beta):
        Xb = beta @ ctx.Xt_ws
        return Xb if ctx.Xb_base is None else ctx.Xb_base + Xb

    def prepare(self, ctx, beta0):
        return self._rebuild(ctx, beta0)

    def refresh(self, ctx, beta):
        return self._rebuild(ctx, beta)

    def epoch(self, ctx, beta, aux):
        if self.config.use_kernels:
            kind = KERNEL_DATAFIT_KINDS[type(ctx.datafit).__name__]
            return kops.cd_epoch_xb(ctx.Xt_ws, ctx.y, beta, aux, ctx.L_ws,
                                    ctx.offset_ws, type(ctx.penalty),
                                    penalty_params(ctx.penalty), kind,
                                    w=ctx.w, epochs=1)
        return cd_epoch_xb(ctx.Xt_ws, ctx.y, beta, aux, ctx.L_ws,
                           ctx.offset_ws, ctx.datafit, ctx.penalty, w=ctx.w)

    def objective(self, ctx, beta, aux):
        return (_df_value(ctx.datafit, aux, ctx.y, ctx.w)
                + torch.dot(ctx.offset_ws, beta) + ctx.penalty.value(beta))

    def gradient(self, ctx, beta, aux):
        return ctx.Xt_ws @ _df_raw(ctx.datafit, aux, ctx.y, ctx.w) + \
            ctx.offset_ws


@dataclass
class StepResult:
    """One outer iteration: the new iterate, the kkt/objective of the
    INCOMING iterate, |gsupp| of the new one, the inner epochs run, whether
    the working set covered the generalized support, and the host reads."""
    beta: torch.Tensor
    Xb: torch.Tensor
    kkt: float
    obj: float
    gcount: int
    n_epochs: int
    covered: bool
    n_syncs: int


class SolveEngine:
    """Outer iteration of Algorithm 1 on one device."""

    def __init__(self, config: EngineConfig, device):
        self.config = config
        self.device = torch.device(device)

    def _make_inner(self):
        cfg = self.config
        return GramSolver(cfg) if cfg.gram else XbSolver(cfg)

    def _objective(self, datafit, penalty, Xb, y, w, offset, beta):
        return _df_value(datafit, Xb, y, w) + torch.dot(offset, beta) + \
            penalty.value(beta)

    def _head(self, bucket, design, y, w, beta, Xb, L, offset, datafit,
              penalty):
        """score -> select -> gather. Returns (grad, ws, Xt_ws, aux, kkt,
        gsupp) as device tensors (aux: the design's gather windows)."""
        cfg = self.config
        raw = _df_raw(datafit, Xb, y, w)
        gsupp = penalty.generalized_support(beta)
        aux = None
        if cfg.use_kernels and design.KIND == "dense":
            # fused head K3: ONE pass over X yields the scores, the
            # offset-corrected gradient AND the candidate columns; the merge
            # is select_working_set on the emitted scores plus a
            # candidate-row lookup
            scores, grad, cand_idx, cand_cols = kops.fused_ws(
                design.Xt, raw, beta, L, offset, gsupp, type(penalty),
                penalty_params(penalty), bucket, use_fp=cfg.use_fp_score)
            ws = select_working_set(scores, gsupp, bucket)
            Xt_ws = candidate_columns(cand_idx, cand_cols, ws,
                                      design.width).T
        else:
            # two-pass head; on a CSC design with use_kernels the score
            # pass is K5
            grad = design.score(raw, use_kernels=cfg.use_kernels) + offset
            scores = violation_scores(penalty, beta, grad, L,
                                      use_fixed_point=cfg.use_fp_score)
            ws = select_working_set(scores, gsupp, bucket)
            Xt_ws, aux = design.gather_ws(ws)
        return grad, ws, Xt_ws, aux, torch.max(scores), gsupp

    def step(self, bucket, design, y, beta, Xb, L, offset, datafit, penalty,
             tol, eps_frac, w=None) -> StepResult:
        """One outer iteration: score -> select -> gather -> inner solve ->
        scatter. The inner solve is skipped when the incoming iterate
        already passes `tol`."""
        cfg = self.config
        grad, ws, Xt_ws, aux, kkt_d, gsupp = self._head(
            bucket, design, y, w, beta, Xb, L, offset, datafit, penalty)
        gcount0 = torch.sum(gsupp)
        obj_d = self._objective(datafit, penalty, Xb, y, w, offset, beta)
        cov_d = torch.sum(gsupp[ws]) == gcount0
        kkt, obj, gcount0, cov = _read(kkt_d, obj_d, gcount0, cov_d)
        covered = bool(cov)
        if kkt <= tol or not covered:
            return StepResult(beta, Xb, kkt, obj, int(gcount0), 0, covered, 1)

        L_ws, offset_ws = L[ws], offset[ws]
        beta_ws0, grad_ws0 = beta[ws], grad[ws]
        eps_in = max(eps_frac * kkt, 0.1 * tol)
        inner = self._make_inner()
        if cfg.gram:
            X_ws = Xt_ws.T
            G, _ = datafit.make_gram(X_ws, y) if w is None \
                else datafit.make_gram(X_ws, y, w)
            # column-major, so K1 reads each column G[:, j] contiguously
            G = G.t().contiguous().t()
            # linearize at the incoming iterate: grad_ws(b) = G (b - b0) +
            # grad0_ws, exact for quadratic datafits even when nonzero
            # coordinates live outside ws (Box pins coords at C with empty
            # generalized support)
            q0 = G @ beta_ws0
            c = q0 - grad_ws0
            ctx = WorkingSetContext(Xt_ws, y, L_ws, offset_ws, datafit,
                                    penalty, G=G, c=c)
            res = inner.solve(ctx, beta_ws0, eps_in, aux0=q0)
            # incremental residual: exact even when a nonzero coordinate
            # sits outside ws
            Xb_new = design.update_xb(Xb, Xt_ws, aux, res.beta - beta_ws0)
        else:
            # Xb_base carries the residual of nonzero coordinates OUTSIDE ws
            # so Anderson refresh cannot drop them
            ctx = WorkingSetContext(Xt_ws, y, L_ws, offset_ws, datafit,
                                    penalty, w=w,
                                    Xb_base=Xb - beta_ws0 @ Xt_ws)
            res = inner.solve(ctx, beta_ws0, eps_in, aux0=Xb)
            Xb_new = res.aux
        # coordinates outside ws are unchanged and (coverage) outside the
        # generalized support, so |gsupp(beta_new)| = |gsupp(beta_ws)|
        return StepResult(scatter_ws(beta, ws, res.beta), Xb_new, kkt, obj,
                          res.gcount, res.n_epochs, True, 1 + res.n_syncs)

    def probe(self, design, y, beta, Xb, L, offset, datafit, penalty,
              w=None):
        """(kkt, |gsupp|, obj) of an initial iterate, in one host read."""
        grad = design.score(_df_raw(datafit, Xb, y, w),
                            use_kernels=self.config.use_kernels) + offset
        scores = violation_scores(penalty, beta, grad, L,
                                  use_fixed_point=self.config.use_fp_score)
        kkt, gcount, obj = _read(
            torch.max(scores),
            torch.sum(penalty.generalized_support(beta)),
            self._objective(datafit, penalty, Xb, y, w, offset, beta))
        return kkt, int(gcount), obj

    def validate(self, datafit, penalty, weighted=False, design=None):
        """Static feasibility checks, raised at ``solve()`` entry with the
        reference's messages."""
        if weighted and not getattr(datafit, "SUPPORTS_WEIGHTS", False):
            raise NotImplementedError(
                f"sample_weight=...: datafit {type(datafit).__name__} "
                f"does not support sample weights (declare "
                f"SUPPORTS_WEIGHTS=True and accept w in "
                f"value/raw_grad/lipschitz/make_gram)")
        if self.config.use_kernels:
            if design is not None and design.KIND == "csc" and \
                    not design.has_ell:
                raise NotImplementedError(PALLAS_SPARSE_ELL_ERROR)
            check_score_kernel_penalty(type(penalty))
            penalty_params(penalty)       # raises on per-coordinate params
            if not self.config.gram and \
                    type(datafit).__name__ not in KERNEL_DATAFIT_KINDS:
                raise ValueError(
                    f"backend='pallas' has no Xb kernel for datafit "
                    f"{type(datafit).__name__}")
