"""The solve engine, single-device (port of ``repro.core.engine``).

One outer iteration of Algorithm 1 is ``SolveEngine.step``: score pass,
working-set selection, gather, inner Anderson-CD solve, scatter, on the
design's device.

Layering (bottom-up):

  SubproblemSolver      Algorithm 2 on a fixed-size working set: blocks of M
    GramSolver          cyclic CD epochs + guarded Anderson extrapolation.
    XbSolver            Gram form for quadratic datafits (state q = G beta),
                        Xb form for general datafits (state Xb). Each epoch
                        runs either plain torch (core/cd.py) or, with
                        ``use_kernels``, the kernel wrappers K1 / K2
                        (kernels/ops.py).
  SolveEngine           the outer step; with ``use_kernels`` its head is the
                        fused kernel K3 (K3b for blocks) on a dense design
                        (one pass over X yields the scores and the
                        gradient; the working set's rows are gathered, and
                        no candidate buffer exists), and on a CSC design
                        the sparse score kernel K5
                        followed by the selection and the window gather
                        (the reference's two-pass sparse head).

Multitask block coordinates (DESIGN.md §8): with MultitaskQuadratic and a
block penalty, beta is [p, T] and Xb, y are [n, T]; the same step runs on
rows of beta (scores, supports and selections stay [p]). The kernel route
then runs the block forms: K3b (dense head) or K5b (CSC score pass), and
K1b in the Gram inner solve. The Xb inner solve of a block problem runs
the plain block epoch on every route, as the reference runs its jax epoch
there: no kernel exists for it.

Host reads: the reference runs the step as one XLA program, its inner
solve under a ``lax.cond`` and its Anderson blocks in a
``lax.while_loop``, and reads back once per outer iteration. ``step``
writes the step once against a flow (``core/flow.py``) and ends in ONE
read of (kkt, objective, |gsupp|, epochs, coverage). On the kernel route
on a card the step is a CUDA graph, captured once per bucket and replayed:
the skip decision is an IF node and the blocks a WHILE node whose
condition the device sets, so nothing else reads the host. On the CPU the
same step tests its conditions in host memory, which is no device
transfer and is not counted. On a card with ``capture=False`` (the tests'
oracle) and on the plain route, the conditions are blocking reads, each
counted in ``StepResult.n_syncs``.

Lanes: ``SolveEngine.chunk`` runs the outer loop of S problems at once
(the chunked path's lambdas, the CV grid's (fold, lambda) cells), the
reference's ``vmap`` of the step under a device-side ``lax.while_loop``.
The lane step is written once against a flow, as the single step is: a
per-lane head (K3l over the shared X on the dense kernel route; the score
pass on R [n, S] and a per-lane selection elsewhere, K5b at T = S on a
CSC design), the per-lane decision ``run = (kkt > tol) & covered``, the
lanes' Gram formation, the lanes' inner Anderson-CD loop (K1l or K2l, an
active-lane mask freezing the lanes whose loop is done) until every lane
meets its eps, and the per-lane scatter. Multitask lanes (betas
[S, p, T], Xbs [S, n, T], a block penalty) run the same step on feature
rows: the lanes' raw gradients lie lane-major in R [n, S*T], the dense
kernel route's head is K3bl (K3b's product over the S*T columns, a block
lane epilogue, K3's select and merge with the lane on grid y), a CSC
design scores R with K5b at S*T columns, and the Gram epochs are K1bl
(K1b with the lane on grid y); their Xb epochs are the plain block epoch
on every route. A lane that does not run keeps
its state, as under the reference's vmap. Each lane's penalty is the
template's class bound to its own row of a ``[S, arity]`` codec vector,
and the datafit and penalty functions run lane by lane under
``torch.vmap``. On the kernel route on a card the whole dispatch (outer
loop, branch, inner loop) is one captured graph per key, replayed with
one host read of (kkts, gcounts, epochs, outer steps).

Designs: ``DenseDesign`` keeps one feature-major copy of X (``Xt`` is a
contiguous [p, n] tensor, so the score pass, the kernels' per-feature dots
and the working-set gathers all read contiguous rows; ``X`` is its
transposed view). ``repro_torch.sparse.CSCDesign`` keeps the window-padded
CSC arrays and densifies only the working-set columns. Both offer
``score``, ``gather_ws`` (-> ``(Xt_ws [K, n], aux)``), ``update_xb``,
``matvec``, ``lipschitz``, ``col_sq_norms`` and ``take_columns`` (a column
subset, or a refill in place of one); ``aux`` is None for a dense design
and the (rows, vals) column windows for a CSC one.
"""
from __future__ import annotations

import itertools
import math
import time
import weakref
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..kernels import ops as kops
from ..kernels.common import (PENALTY_FIELDS, SCALAR_COORD_PENALTIES,
                              bind_penalty, check_score_kernel_penalty,
                              penalty_params)
from .anderson import anderson_extrapolate, anderson_extrapolate_lanes
from .cd import cd_epoch_gram, cd_epoch_xb
from .flow import CapturedFlow, GraphPools, HostFlow
from .working_set import priorities, select_working_set, violation_scores

__all__ = ["EngineConfig", "SolveEngine", "SubproblemSolver", "GramSolver",
           "XbSolver", "KERNEL_DATAFIT_KINDS", "Design", "DenseDesign",
           "as_design", "WorkingSetContext", "StepResult", "ChunkResult",
           "lane_params", "PALLAS_SPARSE_ELL_ERROR"]


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


# the most of X a temporary covers (DenseDesign.from_dense, .lipschitz)
X_CHUNK_BYTES = 32 * 2**20


class Design:
    """Protocol of the design matrix X as the engine consumes it (the
    reference's ``Design``, single device): the score pass ``score``
    (X.T @ raw), the working-set gather ``gather_ws``, the residual update
    ``update_xb``, and the set-up helpers ``matvec``, ``lipschitz``,
    ``col_sq_norms`` and ``take_columns``, with ``shape``, ``dtype``,
    ``device``, ``n_rows``, ``width`` and ``KIND``. ``DenseDesign`` and
    ``repro_torch.sparse.CSCDesign`` implement it."""
    KIND = "abstract"

    def score(self, raw, use_kernels=False):
        raise NotImplementedError

    def gather_ws(self, ws):
        raise NotImplementedError

    def update_xb(self, Xb, Xt_ws, aux, delta):
        raise NotImplementedError

    def matvec(self, beta):
        raise NotImplementedError

    def lipschitz(self, datafit, w=None, use_kernels=False):
        raise NotImplementedError

    def col_sq_norms(self):
        raise NotImplementedError

    def take_columns(self, idx, out=None):
        raise NotImplementedError


@dataclass(frozen=True)
class DenseDesign(Design):
    """Dense design held feature-major: ``Xt`` is a contiguous [p, n]
    tensor and ``X`` ([n, p]) its transposed view."""
    Xt: torch.Tensor

    KIND = "dense"

    @classmethod
    def from_dense(cls, X, device):
        """Design of an [n, p] array or tensor, on `device`, dtype kept.
        A row-major X is moved in row chunks of at most X_CHUNK_BYTES,
        each transposed on `device` into its columns of Xt, so `device`
        holds X once and a chunk, never a copy of X beside it; an X whose
        transpose is contiguous is moved as it is."""
        X = torch.as_tensor(X)
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        if X.ndim != 2:
            raise ValueError(f"X must be 2-D [n, p], got shape {tuple(X.shape)}")
        if X.t().is_contiguous():
            return cls(X.t().to(device))
        n, p = X.shape
        Xt = torch.empty((p, n), dtype=X.dtype, device=device)
        rows = max(1, X_CHUNK_BYTES // max(1, p * X.element_size()))
        for i in range(0, n, rows):
            Xt[:, i:i + rows].copy_(X[i:i + rows].to(device).T)
        return cls(Xt)

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
        """Xb + X_ws @ delta (delta [K] or [K, T])."""
        return Xb + _apply_T(Xt_ws, delta)

    def matvec(self, beta):
        """X @ beta ([p] or [p, T] coefficients)."""
        return self.Xt.T @ beta

    def _chunks(self):
        """Xt in feature chunks of at most X_CHUNK_BYTES: a temporary as
        large as X (a square of X) would set the fits' peak memory."""
        rows = max(1, X_CHUNK_BYTES
                   // max(1, self.n_rows * self.Xt.element_size()))
        return torch.split(self.Xt, rows)

    def lipschitz(self, datafit, w=None, use_kernels=False):
        """The datafit's per-coordinate Lipschitz constants, taken over
        feature chunks."""
        return torch.cat([
            datafit.lipschitz(c.T) if w is None else datafit.lipschitz(c.T, w)
            for c in self._chunks()])

    def col_sq_norms(self):
        """Squared column norms ||x_j||^2 [p], over feature chunks."""
        return torch.cat([torch.sum(c * c, dim=1) for c in self._chunks()])

    def take_columns(self, idx, out=None):
        """The design of the columns `idx` (an int tensor or array on any
        device), an entry -1 giving a zero column (the screened path's
        power-of-two padding), gathered on this design's device. With
        `out`, a design of len(idx) columns and this one's rows and dtype,
        the columns are written into it in place and it is returned (the
        screened path refills one design a width, so its captured steps,
        which read the design in place, replay)."""
        idx = torch.as_tensor(idx, device=self.device).long()
        width = idx.shape[0]
        if out is None:
            out = DenseDesign(torch.empty((width, self.n_rows),
                                          dtype=self.dtype,
                                          device=self.device))
        elif out.shape != (self.n_rows, width) or out.dtype != self.dtype \
                or out.device != self.device:
            raise ValueError(f"take_columns: out must be a {self.n_rows} x "
                             f"{width} {self.dtype} design on {self.device}, "
                             f"got {out.shape} {out.dtype} on {out.device}")
        valid = idx >= 0
        torch.index_select(self.Xt, 0, torch.clamp(idx, min=0), out=out.Xt)
        out.Xt.masked_fill_(~valid[:, None], 0.0)
        return out


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


def _lin(offset, beta):
    """The linear term offset . beta, for scalar and block coefficients."""
    if beta.ndim == 2:
        return torch.sum(offset[:, None] * beta)
    return torch.dot(offset, beta)


def _vdot(a, b):
    """Sum of elementwise products of two equal-shape tensors."""
    return torch.dot(a.reshape(-1), b.reshape(-1))


def _apply_T(Xt_ws, beta):
    """X_ws @ beta given X stored feature-major [K, n]; beta [K] or
    [K, T]."""
    if beta.ndim == 2:
        return Xt_ws.T @ beta                      # [n, T]
    return beta @ Xt_ws


def _bcast(offset, like):
    """offset [p] shaped to add to a gradient like `like` ([p] or [p, T])."""
    return offset[:, None] if like.ndim == 2 else offset


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
    capture: bool = True            # on a card: captured steps; False runs
                                    # the host loop (the tests' oracle)

    @property
    def max_blocks(self) -> int:
        return max(1, math.ceil(self.max_epochs / self.M))


@dataclass(frozen=True)
class WorkingSetContext:
    """Gathered per-working-set tensors consumed by a SubproblemSolver."""
    Xt_ws: torch.Tensor              # [K, n] gathered design, feature-major
    y: torch.Tensor                  # [n] (or [n, T] multitask)
    L_ws: torch.Tensor               # [K]
    offset_ws: torch.Tensor          # [K]
    datafit: object
    penalty: object
    params: torch.Tensor = None      # the penalty's codec vector on the
                                     # design's device (kernel route only)
    G: torch.Tensor = None           # [K, K] column-major (Gram solvers only)
    c: torch.Tensor = None           # [K] or [K, T] (Gram solvers only)
    w: torch.Tensor = None           # per-sample weights (Xb solvers only;
                                     # the Gram form bakes w into G)
    Xb_base: torch.Tensor = None     # Xb0 - X_ws beta_ws0: residual of the
                                     # nonzero coordinates OUTSIDE ws (Xb
                                     # solvers; Box pins coords at C with
                                     # empty generalized support)


class SubproblemSolver:
    """Algorithm 2 on a fixed working set: blocks of M cyclic CD epochs, one
    guarded Anderson extrapolation per block, run while blocks are left and
    the restricted KKT violation is above eps. ``run`` drives the blocks
    under a flow (``core/flow.py``): a host loop, or a WHILE node of a
    captured graph."""

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

    def block(self, ctx, beta, aux):
        """One Anderson block: M epochs, the guarded extrapolation, and the
        restricted kkt of the kept iterate. Returns (beta, aux, kkt)."""
        cfg = self.config
        hist = [beta]
        for _ in range(cfg.M):
            beta, aux = self.epoch(ctx, beta, aux)
            hist.append(beta)
        if cfg.accel:
            be = ctx.penalty.prox(anderson_extrapolate(torch.stack(hist)), 0.0)
            auxe = self.refresh(ctx, be)
            take = self.objective(ctx, be, auxe) < \
                self.objective(ctx, beta, aux)
            beta = torch.where(take, be, beta)
            aux = torch.where(take, auxe, aux)
        grad = self.gradient(ctx, beta, aux)
        kkt = torch.max(violation_scores(ctx.penalty, beta, grad, ctx.L_ws,
                                         use_fixed_point=cfg.use_fp_score))
        return beta, aux, kkt

    def run(self, flow, ctx, beta, aux, blocks, eps):
        """Blocks on the carries `beta` and `aux` (updated in place) while
        ``blocks < max_blocks`` and the last block's kkt > `eps` (a 0-d
        tensor); `blocks` (0-d int64, in place) counts them. The first
        block always runs, as the reference's loop starts from kkt = inf."""
        go = torch.ones((), dtype=torch.bool, device=beta.device)

        def body():
            b, a, kkt = self.block(ctx, beta, aux)
            beta.copy_(b)
            aux.copy_(a)
            blocks.add_(1)
            go.copy_((blocks < self.config.max_blocks) & (kkt > eps))

        flow.loop(go, body)


class GramSolver(SubproblemSolver):
    """Quadratic datafits: state q = G beta stays K-sized (on chip for the
    whole epoch in K1)."""

    def prepare(self, ctx, beta0):
        return ctx.G @ beta0

    def refresh(self, ctx, beta):
        return ctx.G @ beta

    def epoch(self, ctx, beta, aux):
        if self.config.use_kernels:
            # K1 on scalar coordinates, K1b on blocks [K, T]
            kern = kops.cd_epoch_gram_block if beta.ndim == 2 \
                else kops.cd_epoch_gram
            return kern(ctx.G, ctx.c, beta, aux, ctx.L_ws, type(ctx.penalty),
                        ctx.params, epochs=1)
        return cd_epoch_gram(ctx.G, ctx.c, beta, aux, ctx.L_ws, ctx.penalty)

    def objective(self, ctx, beta, aux):
        return (0.5 * _vdot(beta, aux) - _vdot(ctx.c, beta)
                + ctx.penalty.value(beta))

    def gradient(self, ctx, beta, aux):
        return aux - ctx.c


class XbSolver(SubproblemSolver):
    """General datafits (Algorithm 3 verbatim): state Xb = X_ws beta
    (+ ctx.Xb_base, the constant contribution of nonzero coordinates outside
    the working set, so Anderson candidates rebuilt by `refresh` keep it)."""

    def _rebuild(self, ctx, beta):
        Xb = _apply_T(ctx.Xt_ws, beta)
        return Xb if ctx.Xb_base is None else ctx.Xb_base + Xb

    def prepare(self, ctx, beta0):
        return self._rebuild(ctx, beta0)

    def refresh(self, ctx, beta):
        return self._rebuild(ctx, beta)

    def epoch(self, ctx, beta, aux):
        # block coordinates have no Xb kernel: their plain epoch runs on
        # every route, as the reference runs its jax epoch there
        if self.config.use_kernels and beta.ndim == 1:
            kind = KERNEL_DATAFIT_KINDS[type(ctx.datafit).__name__]
            return kops.cd_epoch_xb(ctx.Xt_ws, ctx.y, beta, aux, ctx.L_ws,
                                    ctx.offset_ws, type(ctx.penalty),
                                    ctx.params, kind,
                                    w=ctx.w, epochs=1)
        return cd_epoch_xb(ctx.Xt_ws, ctx.y, beta, aux, ctx.L_ws,
                           ctx.offset_ws, ctx.datafit, ctx.penalty, w=ctx.w)

    def objective(self, ctx, beta, aux):
        return (_df_value(ctx.datafit, aux, ctx.y, ctx.w)
                + _lin(ctx.offset_ws, beta) + ctx.penalty.value(beta))

    def gradient(self, ctx, beta, aux):
        grad = ctx.Xt_ws @ _df_raw(ctx.datafit, aux, ctx.y, ctx.w)
        return grad + _bcast(ctx.offset_ws, grad)


@dataclass
class StepResult:
    """One outer iteration: the new iterate, the kkt/objective of the
    INCOMING iterate, |gsupp| of the new one, the inner epochs run, whether
    the working set covered the generalized support, and the blocking
    device-to-host reads the step made."""
    beta: torch.Tensor
    Xb: torch.Tensor
    kkt: float
    obj: float
    gcount: int
    n_epochs: int
    covered: bool
    n_syncs: int


class ChunkResult(NamedTuple):
    """One chunk dispatch (``SolveEngine.chunk``), the reference's tuple:
    the lanes' iterates (on the device), then, read back once, the kkt
    of each lane's last incoming iterate, its objective (on the device),
    |gsupp| of its new iterate, its inner epochs and the outer steps the
    dispatch ran."""
    betas: torch.Tensor
    Xbs: torch.Tensor
    kkts: np.ndarray
    objs: torch.Tensor
    gcounts: np.ndarray
    n_eps: np.ndarray
    n_outer: int


def lane_params(penalty, lams):
    """The ``[S, arity]`` float64 codec rows of `penalty` with its ``lam``
    replaced by each of `lams` (on the CPU)."""
    fields = PENALTY_FIELDS.get(type(penalty))
    if fields is None or "lam" not in fields:
        raise ValueError(f"lanes need a codec-registered penalty with a lam "
                         f"hyper-parameter, got {type(penalty).__name__}")
    lams = torch.as_tensor(np.asarray(lams, np.float64))
    rows = penalty_params(penalty).repeat(lams.shape[0], 1)
    rows[:, fields.index("lam")] = lams
    return rows


def _lanes_T(Xt_ws, beta):
    """Per lane X_ws @ beta: Xt_ws [S, K, n], beta [S, K] -> [S, n] (or
    [S, K, T] -> [S, n, T])."""
    if beta.ndim == 3:
        return Xt_ws.transpose(1, 2) @ beta
    return (beta[:, None, :] @ Xt_ws)[:, 0]


def _lanes_mv(A, v):
    """Per lane A @ v: A [S, a, b], v [S, b] -> [S, a] (or [S, b, T] ->
    [S, a, T])."""
    if v.ndim == 3:
        return A @ v
    return (A @ v[..., None])[..., 0]


def _lane_col(x, like):
    """A per-lane [S] tensor shaped to broadcast against `like` ([S, ...])."""
    return x.view((x.shape[0],) + (1,) * (like.ndim - 1))


def _rows(x, like):
    """A per-feature [S, K] (or [p]) tensor shaped to broadcast against
    block coefficients `like` ([S, K, T]); unchanged for scalar ones."""
    return x[..., None] if like.ndim == x.ndim + 1 else x


def _lane_sum(x):
    """Each lane's sum over its coefficients ([S, K] or [S, K, T] -> [S])."""
    return torch.sum(x, dim=tuple(range(1, x.ndim)))


class _Lanes:
    """The datafit and penalty functions of S lanes: each lane's penalty is
    `penalty_cls` bound to its row of `params` [S, arity]; y ([n], or
    [n, T] for multitask lanes) is shared and w is None, shared [n] or per
    lane [S, n]. Every function maps over the lanes with ``torch.vmap``;
    on multitask lanes the residuals are [S, n, T], the coefficients
    [S, p, T] and the penalty acts on rows, so the scores and supports stay
    [S, p]."""

    def __init__(self, datafit, penalty_cls, params, y, w, use_fp):
        self.datafit, self.cls, self.params = datafit, penalty_cls, params
        self.y, self.w, self.use_fp = y, w, use_fp
        self.w_dim = None if w is None or w.ndim == 1 else 0

    def _df(self, fn, *lanes):
        """fn(*lane_args, w_lane) over the lanes (w_lane None unweighted)."""
        if self.w is None:
            return torch.vmap(lambda *a: fn(*a, None))(*lanes)
        return torch.vmap(fn, in_dims=(0,) * len(lanes) + (self.w_dim,))(
            *lanes, self.w)

    def _pen(self, fn, *lanes):
        """fn(penalty_of_lane, *lane_args) over the lanes."""
        cls = self.cls
        return torch.vmap(lambda prm, *a: fn(bind_penalty(cls, prm), *a))(
            self.params, *lanes)

    def raw(self, Xb):
        return self._df(lambda x, w: _df_raw(self.datafit, x, self.y, w), Xb)

    def value(self, Xb):
        return self._df(lambda x, w: _df_value(self.datafit, x, self.y, w),
                        Xb)

    def gram(self, Xt_ws):
        """Each lane's Gram matrix of its working set [S, K, K] (the
        rows' Gram on multitask lanes too), each lane
        column-major (so K1l reads a column contiguously). Formed lane by
        lane into one buffer: a batched product would hold the weighted
        copy of every lane's X_ws and two [S, K, K] temporaries at once
        (~80 GB at S = 10, K = 16,384, n = 10,000)."""
        S, K, _ = Xt_ws.shape
        G = torch.empty((S, K, K), dtype=Xt_ws.dtype,
                        device=Xt_ws.device).transpose(1, 2)
        for s in range(S):
            X_ws = Xt_ws[s].T
            w = None if self.w is None else \
                (self.w if self.w.ndim == 1 else self.w[s])
            G[s].copy_((self.datafit.make_gram(X_ws, self.y) if w is None
                        else self.datafit.make_gram(X_ws, self.y, w))[0])
        return G

    def gsupp(self, beta):
        return self._pen(lambda pen, b: pen.generalized_support(b), beta)

    def pen_value(self, beta):
        return self._pen(lambda pen, b: pen.value(b), beta)

    def prox0(self, beta):
        return self._pen(lambda pen, b: pen.prox(b, 0.0), beta)

    def scores(self, beta, grad, L):
        return self._pen(lambda pen, b, g, l: violation_scores(
            pen, b, g, l, use_fixed_point=self.use_fp), beta, grad, L)

    def gram_epoch(self, G, c, beta, q, L):
        """The plain Gram epoch (core/cd.py) on every lane (scalar [S, K]
        or block [S, K, T] coefficients)."""
        return self._pen(lambda pen, *a: cd_epoch_gram(*a, pen), G, c, beta,
                         q, L)

    def xb_epoch(self, Xt_ws, beta, Xb, L, offset):
        """The plain Xb epoch (core/cd.py) on every lane (the block form on
        multitask lanes, which has no kernel)."""
        cls, datafit, y = self.cls, self.datafit, self.y

        def one(prm, Xt, b, x, l, o, w):
            return cd_epoch_xb(Xt, y, b, x, l, o, datafit,
                               bind_penalty(cls, prm), w=w)
        if self.w is None:
            return torch.vmap(lambda *a: one(*a, None))(
                self.params, Xt_ws, beta, Xb, L, offset)
        return torch.vmap(one, in_dims=(0,) * 6 + (self.w_dim,))(
            self.params, Xt_ws, beta, Xb, L, offset, self.w)


@dataclass(frozen=True)
class _LaneContext:
    """Gathered per-lane working-set tensors of the lanes' inner solve."""
    Xt_ws: torch.Tensor              # [S, K, n]
    L_ws: torch.Tensor               # [S, K]
    offset_ws: torch.Tensor          # [S, K]
    G: torch.Tensor = None           # [S, K, K], each lane column-major
    c: torch.Tensor = None           # [S, K] (or [S, K, T] multitask)
    Xb_base: torch.Tensor = None     # [S, n] (or [S, n, T]; Xb solvers)


class _LaneSolver:
    """Algorithm 2 on S lanes' working sets at once: the blocks of the
    single-lane ``SubproblemSolver`` (Gram or Xb form), each lane's
    Anderson acceptance decided on its own, under an active-lane mask
    ``go``: a lane whose loop is done keeps its state (the kernels freeze
    it) and its blocks stop counting."""

    def __init__(self, config, lanes: _Lanes):
        self.config, self.lanes = config, lanes

    def epoch(self, ctx, beta, aux, go):
        cfg, ln = self.config, self.lanes
        block = beta.ndim == 3
        if cfg.gram:
            if cfg.use_kernels:
                # K1l on scalar lanes, K1bl on blocks [S, K, T]
                kern = kops.cd_epoch_gram_block_lanes if block \
                    else kops.cd_epoch_gram_lanes
                return kern(ctx.G, ctx.c, beta, aux, ctx.L_ws, ln.cls,
                            ln.params, go)
            return ln.gram_epoch(ctx.G, ctx.c, beta, aux, ctx.L_ws)
        # block coordinates have no Xb kernel: their plain epoch runs on
        # every route, as the reference runs its jax epoch there
        if cfg.use_kernels and not block:
            kind = KERNEL_DATAFIT_KINDS[type(ln.datafit).__name__]
            return kops.cd_epoch_xb_lanes(ctx.Xt_ws, ln.y, beta, aux,
                                          ctx.L_ws, ctx.offset_ws, ln.cls,
                                          ln.params, go, kind, w=ln.w)
        return ln.xb_epoch(ctx.Xt_ws, beta, aux, ctx.L_ws, ctx.offset_ws)

    def refresh(self, ctx, beta):
        if self.config.gram:
            return _lanes_mv(ctx.G, beta)
        return ctx.Xb_base + _lanes_T(ctx.Xt_ws, beta)

    def objective(self, ctx, beta, aux):
        ln = self.lanes
        if self.config.gram:
            return (0.5 * _lane_sum(beta * aux) - _lane_sum(ctx.c * beta)
                    + ln.pen_value(beta))
        return (ln.value(aux) + _lane_sum(_rows(ctx.offset_ws, beta) * beta)
                + ln.pen_value(beta))

    def gradient(self, ctx, beta, aux):
        if self.config.gram:
            return aux - ctx.c
        grad = _lanes_mv(ctx.Xt_ws, self.lanes.raw(aux))
        return grad + _rows(ctx.offset_ws, grad)

    def block(self, ctx, beta, aux, go):
        """One Anderson block on every lane: M masked epochs, the guarded
        extrapolation, the restricted kkt [S] of each kept iterate."""
        cfg, ln = self.config, self.lanes
        hist = [beta]
        for _ in range(cfg.M):
            beta, aux = self.epoch(ctx, beta, aux, go)
            hist.append(beta)
        if cfg.accel:
            be = ln.prox0(anderson_extrapolate_lanes(torch.stack(hist, 1)))
            auxe = self.refresh(ctx, be)
            take = self.objective(ctx, be, auxe) < \
                self.objective(ctx, beta, aux)
            beta = torch.where(_lane_col(take, be), be, beta)
            aux = torch.where(_lane_col(take, auxe), auxe, aux)
        grad = self.gradient(ctx, beta, aux)
        kkt = torch.amax(ln.scores(beta, grad, ctx.L_ws), dim=1)
        return beta, aux, kkt

    def run(self, flow, ctx, beta, aux, blocks, eps, go, passes):
        """Blocks while some lane is active: lane s takes a block while
        ``go[s]`` (in place: blocks[s] < max_blocks and its last kkt above
        eps[s]); `blocks` [S] counts each lane's, `passes` (0-d) the
        loop's."""
        anygo = torch.any(go)

        def body():
            b, a, kkt = self.block(ctx, beta, aux, go)
            beta.copy_(torch.where(_lane_col(go, b), b, beta))
            aux.copy_(torch.where(_lane_col(go, a), a, aux))
            blocks.add_(go.to(blocks.dtype))
            passes.add_(1)
            go.copy_(go & (blocks < self.config.max_blocks) & (kkt > eps))
            anygo.copy_(torch.any(go))

        flow.loop(anygo, body)


class _StepGraph:
    """One captured outer step: the graph, its static inputs (``bind``
    copies a new tensor in; ``params``, the penalty's codec vector, among
    them), the design it reads in place (held while the graph lives), its
    outputs, and the kernel launches of the step (``head``) and of
    each conditional body (``scopes``)."""

    def __init__(self, inputs, design):
        self.inputs = inputs
        self.design = design
        self._bound = {}
        self.graph = torch.cuda.CUDAGraph()
        self.outputs = None
        self.head = []
        self.scopes = []

    def bind(self, name, tensor):
        """Copy `tensor` into the static input `name` unless it is the
        tensor last bound there (y, w, L, offset and params stay bound for
        a whole solve)."""
        if self._bound.get(name) is not tensor:
            self.inputs[name].copy_(tensor)
            self._bound[name] = tensor


class SolveEngine:
    """Outer iteration of Algorithm 1 on one device.

    On the kernel route on a card (``EngineConfig.capture``, the default)
    each outer step is captured once per (working-set bucket, design,
    shapes, datafit, penalty class, tol) into a CUDA graph and replayed,
    with the skip decision and the inner loop on the card
    (``core/flow.py``); ``captures`` counts the captures per key (the
    counterpart of the reference's ``engine.retraces``) and ``capture_s``
    their host seconds. The penalty's hyper-parameters are not in the key:
    on the kernel route the step runs on ``bind_penalty`` of its codec
    vector, a static input of the graph bound at each replay like y and L,
    so a regularization path replays one graph per bucket at every lam
    (the reference's pytree leaves). The graphs share the engine's memory
    pools and live until ``release_graphs`` (``solve`` calls it when it
    made the engine); ``drop_graphs(design)`` drops one design's."""

    def __init__(self, config: EngineConfig, device):
        self.config = config
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        self.device = device
        self.captures: dict = {}
        self.capture_s: list = []
        self._graphs: dict = {}
        self._retired: list = []        # graphs of dropped designs
        self._tags: dict = {}           # id(design) -> (weakref, serial)
        self._serials = itertools.count()
        self._pools = None
        self._params = (None, None)      # (penalty's key, its codec vector)
        self.n_dispatches = 0            # steps and chunks dispatched
        self.n_chunk_reads = 0           # blocking reads of the chunks

    def _make_inner(self):
        cfg = self.config
        return GramSolver(cfg) if cfg.gram else XbSolver(cfg)

    def _objective(self, datafit, penalty, Xb, y, w, offset, beta):
        return _df_value(datafit, Xb, y, w) + _lin(offset, beta) + \
            penalty.value(beta)

    def _head(self, bucket, design, y, w, beta, Xb, L, offset, datafit,
              penalty, params):
        """score -> select -> gather. Returns (grad, ws, Xt_ws, aux, kkt,
        gsupp) as device tensors (aux: the design's gather windows)."""
        cfg = self.config
        raw = _df_raw(datafit, Xb, y, w)
        gsupp = penalty.generalized_support(beta)
        aux = None
        if cfg.use_kernels and design.KIND == "dense":
            # fused head K3 (K3b for blocks): one pass over X yields the
            # scores and the offset-corrected gradient; it hands back the
            # working set and its K rows of X (no candidate buffer)
            head = kops.fused_ws_block if beta.ndim == 2 else kops.fused_ws
            scores, grad, _, ws, Xt_ws = head(
                design.Xt, raw, beta, L, offset, gsupp, type(penalty),
                params, bucket, use_fp=cfg.use_fp_score)
        else:
            # two-pass head; on a CSC design with use_kernels the score
            # pass is K5 (K5b for a raw gradient [n, T])
            grad = design.score(raw, use_kernels=cfg.use_kernels)
            grad = grad + _bcast(offset, grad)
            scores = violation_scores(penalty, beta, grad, L,
                                      use_fixed_point=cfg.use_fp_score)
            ws = select_working_set(scores, gsupp, bucket)
            Xt_ws, aux = design.gather_ws(ws)
        return grad, ws, Xt_ws, aux, torch.max(scores), gsupp

    def _step_core(self, flow, bucket, design, y, w, beta, Xb, L, offset,
                   datafit, penalty, params, tol, eps_frac):
        """The outer step, written once for every flow: score -> select ->
        gather, then, when the incoming iterate fails `tol` and the working
        set covers the generalized support, Gram formation -> inner
        Anderson-CD loop -> scatter. Returns (beta_new, Xb_new, rd); rd
        holds, in beta's dtype, the kkt and objective of the incoming
        iterate, |gsupp| of the new one, the inner epochs and the coverage
        flag: what the host reads back, once. On the kernel route
        `penalty` is bound to `params` (``bind_penalty``)."""
        cfg = self.config
        grad, ws, Xt_ws, aux, kkt, gsupp = self._head(
            bucket, design, y, w, beta, Xb, L, offset, datafit, penalty,
            params)
        gcount0 = torch.sum(gsupp)
        obj = self._objective(datafit, penalty, Xb, y, w, offset, beta)
        cov = torch.sum(gsupp[ws]) == gcount0
        # the reference's lax.cond and eps_in, on the device (an uncovered
        # step skips too: solve() raises on it)
        run = (kkt > tol) & cov
        eps_in = torch.clamp(eps_frac * kkt, min=0.1 * tol)
        # the skipped step's results, overwritten when the inner solve runs
        beta_new, Xb_new = beta.clone(), Xb.clone()
        gcount = gcount0.clone()
        blocks = torch.zeros((), dtype=torch.int64, device=beta.device)

        def inner():
            L_ws, offset_ws = L[ws], offset[ws]
            beta_ws0, grad_ws0 = beta[ws], grad[ws]
            if cfg.gram:
                X_ws = Xt_ws.T
                G, _ = datafit.make_gram(X_ws, y) if w is None \
                    else datafit.make_gram(X_ws, y, w)
                # column-major, so K1 reads each column G[:, j] contiguously
                G = G.t().contiguous().t()
                # linearize at the incoming iterate: grad_ws(b) = G (b - b0)
                # + grad0_ws, exact for quadratic datafits even when nonzero
                # coordinates live outside ws (Box pins coords at C with
                # empty generalized support)
                state = G @ beta_ws0
                ctx = WorkingSetContext(Xt_ws, y, L_ws, offset_ws, datafit,
                                        penalty, params, G=G,
                                        c=state - grad_ws0)
            else:
                # Xb_base carries the residual of nonzero coordinates
                # OUTSIDE ws so Anderson refresh cannot drop them
                ctx = WorkingSetContext(
                    Xt_ws, y, L_ws, offset_ws, datafit, penalty, params, w=w,
                    Xb_base=Xb - _apply_T(Xt_ws, beta_ws0))
                state = Xb.clone()
            beta_ws = beta_ws0.clone()
            self._make_inner().run(flow, ctx, beta_ws, state, blocks, eps_in)
            if cfg.gram:
                # incremental residual: exact even when a nonzero coordinate
                # sits outside ws
                state = design.update_xb(Xb, Xt_ws, aux, beta_ws - beta_ws0)
            Xb_new.copy_(state)
            beta_new[ws] = beta_ws
            # coordinates outside ws are unchanged and (coverage) outside
            # the generalized support, so |gsupp(beta_new)| = |gsupp(beta_ws)|
            gcount.copy_(torch.sum(penalty.generalized_support(beta_ws)))

        flow.branch(run, inner)
        rd = torch.stack([v.to(beta.dtype) for v in
                          (kkt, obj, gcount, blocks * cfg.M, cov)])
        return beta_new, Xb_new, rd

    @property
    def captured(self) -> bool:
        """Whether steps run as captured graphs: the kernel route on a
        card. The plain route's epochs are Python loops over the working
        set (a graph of them takes longer to capture than to run), so on a
        card it tests its conditions on the host, as ``capture=False``
        does."""
        return self.device.type == "cuda" and self.config.capture and \
            self.config.use_kernels

    def step(self, bucket, design, y, beta, Xb, L, offset, datafit, penalty,
             tol, eps_frac, w=None) -> StepResult:
        """One outer iteration, ending in the step's one blocking read: a
        replay of the captured step on the kernel route on a card, the same
        step under a host flow elsewhere (on a card that flow reads once
        more per condition: the plain route, and the eager oracle of
        ``capture=False``). On the kernel route the step runs on the
        penalty bound to its codec vector on the device, captured or not,
        so the captured step and the eager oracle take the same ops."""
        self.n_dispatches += 1
        params = None
        if self.config.use_kernels:
            params = self._device_params(penalty)
        if self.captured:
            return self._replay(bucket, design, y, w, beta, Xb, L, offset,
                                datafit, penalty, params, tol, eps_frac)
        if params is not None:
            penalty = bind_penalty(type(penalty), params)
        flow = HostFlow()
        beta_new, Xb_new, rd = self._step_core(
            flow, bucket, design, y, w, beta, Xb, L, offset, datafit,
            penalty, params, tol, eps_frac)
        kkt, obj, gcount, n_ep, cov = rd.tolist()
        return StepResult(beta_new, Xb_new, kkt, obj, int(gcount), int(n_ep),
                          bool(cov), 1 + flow.reads)

    # ------------------------------------------------------------ lanes
    def chunk(self, bucket, design, y, lams, betas, Xbs, L, offset, datafit,
              penalty, tol, eps_frac, max_outer, growth=2, w=None):
        """One device-resident dispatch of S lanes (the reference's
        ``engine.chunk``): lane s solves the `penalty` template at
        ``lam = lams[s]`` from (betas[s], Xbs[s]) on the shared bucket,
        with `w` None, a shared [n] or per-lane [S, n] weights and `L` the
        matching [p] or [S, p] Lipschitz constants; multitask lanes carry
        betas [S, p, T] and Xbs [S, n, T] with y [n, T]. The outer steps run
        while ``it < max_outer``, some lane's kkt is above `tol` and (below
        bucket p) no such lane's |gsupp| outgrew ``bucket / growth``; on
        the kernel route on a card as one captured graph (key: bucket,
        design, lane count and shapes, weights' form, datafit, penalty
        class, tol), elsewhere under the host flow. Ends in one blocking
        read. Returns a ``ChunkResult``."""
        self.n_dispatches += 1
        S = betas.shape[0]
        params = lane_params(penalty, lams)
        if self.device.type == "cuda":
            params = params.pin_memory().to(self.device, non_blocking=True)
        budget = torch.tensor(int(max_outer), dtype=torch.int64)
        if self.device.type == "cuda":
            budget = budget.pin_memory().to(self.device, non_blocking=True)
        args = (bucket, design, y, w, betas, Xbs, L, offset, datafit,
                type(penalty), params, float(tol), float(eps_frac), budget,
                int(growth))
        if self.captured:
            out = self._chunk_replay(*args)
            reads = 1
        else:
            flow = HostFlow()
            out = self._chunk_core(flow, *args)
            reads = 1 + flow.reads
        b, x, objs, rd = out
        vals = rd.tolist()                          # the dispatch's read
        self.n_chunk_reads += reads
        kkts = np.asarray(vals[:S])
        gcounts = np.asarray(vals[S:2 * S], np.int64)
        n_eps = np.asarray(vals[2 * S:3 * S], np.int64)
        it, branches, passes = (int(v) for v in vals[3 * S:])
        if self.captured:
            g = self._graphs[self._chunk_key(*args)]
            for kind, depth, launches in g.scopes:
                kops.add_launches(launches, {1: it, 2: branches,
                                             3: passes}[depth])
        return ChunkResult(b, x, kkts, objs, gcounts, n_eps, it)

    def _chunk_core(self, flow, bucket, design, y, w, betas, Xbs, L, offset,
                    datafit, penalty_cls, params, tol, eps_frac, budget,
                    growth):
        """The chunk dispatch, written once for every flow: the outer loop
        over the lane step (``_lane_step``) with the reference's condition
        (``engine._chunk_loop``). Returns (betas, Xbs, objs, rd): rd holds,
        in the lanes' dtype, the kkts, gcounts and epochs [S] and the outer
        steps, branch runs and inner loop passes of the dispatch, what the
        host reads back once."""
        S, p = betas.shape[0], design.shape[1]
        dev, dtype = betas.device, betas.dtype
        betas, Xbs = betas.clone(), Xbs.clone()
        kkts = torch.full((S,), torch.inf, dtype=dtype, device=dev)
        objs = torch.zeros((S,), dtype=dtype, device=dev)
        gcounts = torch.zeros((S,), dtype=torch.int64, device=dev)
        n_eps = torch.zeros((S,), dtype=torch.int64, device=dev)
        counts = torch.zeros((3,), dtype=torch.int64, device=dev)
        go = torch.empty((), dtype=torch.bool, device=dev)

        def cond():
            unconverged = kkts > tol
            live = (counts[0] < budget) & torch.any(unconverged)
            if bucket < p:
                # hand back to the host for bucket escalation; at bucket p
                # the working set covers every feature
                live = live & ~torch.any(unconverged &
                                         (growth * gcounts > bucket))
            go.copy_(live)

        def body():
            b, x, kkt, obj, gc, d_ep = self._lane_step(
                flow, bucket, design, y, w, betas, Xbs, L, offset, datafit,
                penalty_cls, params, tol, eps_frac, counts)
            betas.copy_(b)
            Xbs.copy_(x)
            kkts.copy_(kkt)
            objs.copy_(obj)
            gcounts.copy_(gc)
            n_eps.add_(d_ep)
            counts[0] += 1
            cond()

        cond()
        flow.loop(go, body)
        rd = torch.cat([kkts, gcounts.to(dtype), n_eps.to(dtype),
                        counts.to(dtype)])
        return betas, Xbs, objs, rd

    def _lane_step(self, flow, bucket, design, y, w, betas, Xbs, L, offset,
                   datafit, penalty_cls, params, tol, eps_frac, counts):
        """One outer step of every lane (the reference's vmapped
        ``_step_body``): per-lane head, ``run = (kkt > tol) & covered``,
        then, when some lane runs, the lanes' Gram formation, their
        inner loop and the per-lane scatter. Returns (betas, Xbs, kkt, obj,
        gcount, epochs), each [S] but the iterates; counts[1] and counts[2]
        count the branch's runs and the inner loop's passes."""
        cfg = self.config
        S, p = betas.shape[:2]
        n = design.n_rows
        block = betas.ndim == 3
        ln = _Lanes(datafit, penalty_cls, params, y, w, cfg.use_fp_score)
        raw = ln.raw(Xbs)
        gsupp = ln.gsupp(betas)
        L_l = L if L.ndim == 2 else L.expand(S, p)
        off = offset[:, None] if block else offset
        # the lanes' raw gradients a column each ([n, S]), or lane-major
        # T columns each on multitask lanes ([n, S*T])
        R = raw.permute(1, 0, 2).reshape(n, -1) if block \
            else raw.T.contiguous()
        if cfg.use_kernels and design.KIND == "dense":
            # K3l (K3bl on blocks): X read once for every lane; the lanes'
            # working sets and their K rows each
            head = kops.fused_ws_block_lanes if block else kops.fused_ws_lanes
            scores, grad, _, ws, Xt_ws = head(
                design.Xt, R, betas, L_l, offset, gsupp, penalty_cls, params,
                bucket, use_fp=cfg.use_fp_score)
        else:
            # the score pass on the lanes' raw gradients (K5b at S (or S*T)
            # columns on a CSC design on the kernel route), then each
            # lane's selection
            grad = design.score(R, use_kernels=cfg.use_kernels)
            grad = (grad.reshape(p, S, -1).permute(1, 0, 2) if block
                    else grad.T) + off
            scores = ln.scores(betas, grad, L_l)
            ws = torch.sort(priorities(scores, gsupp), dim=1,
                            descending=True, stable=True).indices[:, :bucket]
            Xt_ws = design.gather_ws(ws.reshape(-1))[0].reshape(S, bucket, n)
        kkt = torch.amax(scores, dim=1)
        gcount0 = torch.sum(gsupp, dim=1)
        obj = ln.value(Xbs) + _lane_sum(off * betas) + ln.pen_value(betas)
        cov = torch.sum(torch.gather(gsupp, 1, ws), dim=1) == gcount0
        run = (kkt > tol) & cov
        eps_in = torch.clamp(eps_frac * kkt, min=0.1 * tol)
        beta_new, Xb_new = betas.clone(), Xbs.clone()
        gcount = gcount0.clone()
        blocks = torch.zeros((S,), dtype=torch.int64, device=betas.device)
        # the working set's entries of the coefficients (its rows on blocks)
        ws_c = ws[..., None].expand(-1, -1, betas.shape[2]) if block else ws

        def inner():
            counts[1] += 1
            L_ws = torch.gather(L_l, 1, ws)
            offset_ws = offset[ws]
            beta_ws0 = torch.gather(betas, 1, ws_c)
            grad_ws0 = torch.gather(grad, 1, ws_c)
            if cfg.gram:
                G = ln.gram(Xt_ws)
                state = _lanes_mv(G, beta_ws0)
                ctx = _LaneContext(Xt_ws, L_ws, offset_ws, G=G,
                                   c=state - grad_ws0)
            else:
                ctx = _LaneContext(Xt_ws, L_ws, offset_ws,
                                   Xb_base=Xbs - _lanes_T(Xt_ws, beta_ws0))
                state = Xbs.clone()
            beta_ws = beta_ws0.clone()
            _LaneSolver(cfg, ln).run(flow, ctx, beta_ws, state, blocks,
                                     eps_in, run.clone(), counts[2])
            if cfg.gram:
                state = Xbs + _lanes_T(Xt_ws, beta_ws - beta_ws0)
            Xb_new.copy_(torch.where(_lane_col(run, Xbs), state, Xbs))
            beta_new.scatter_(1, ws_c, beta_ws)
            gcount.copy_(torch.where(run, torch.sum(ln.gsupp(beta_ws), dim=1),
                                     gcount0))

        flow.branch(torch.any(run), inner)
        return beta_new, Xb_new, kkt, obj, gcount, blocks * cfg.M

    def _chunk_key(self, bucket, design, y, w, betas, Xbs, L, offset, datafit,
                   penalty_cls, params, tol, eps_frac, budget, growth):
        wkind = None if w is None else w.ndim
        # betas' shape holds the task count: a multitask dispatch never
        # replays a scalar one's graph, nor one of another T
        return ("chunk", bucket, self._design_tag(design), betas.shape[0],
                tuple(y.shape), wkind, L.ndim, tuple(betas.shape),
                betas.dtype, datafit, penalty_cls, tol, eps_frac, growth)

    def _chunk_replay(self, *args):
        key = self._chunk_key(*args)
        (bucket, design, y, w, betas, Xbs, L, offset, datafit, penalty_cls,
         params, tol, eps_frac, budget, growth) = args
        g = self._graphs.get(key)
        if g is None:
            g = self._chunk_capture(key, *args)
        for name, t in (("y", y), ("w", w), ("L", L), ("offset", offset)):
            if t is not None:
                g.bind(name, t)
        for name, t in (("params", params), ("budget", budget),
                        ("betas", betas), ("Xbs", Xbs)):
            g.inputs[name].copy_(t)
        g.graph.replay()
        b, x, objs, rd = g.outputs
        # copies: a later replay of this or another graph of the engine
        # reuses the outputs' memory
        return b.clone(), x.clone(), objs.clone(), rd

    def _chunk_capture(self, key, bucket, design, y, w, betas, Xbs, L,
                       offset, datafit, penalty_cls, params, tol, eps_frac,
                       budget, growth):
        """Capture the chunk dispatch for `key` into a graph on the
        engine's pools (the design is read in place; the rest, the lanes'
        parameter rows and the outer budget among them, through static
        inputs)."""
        t0 = time.perf_counter()
        if self._pools is None:
            self._pools = GraphPools(self.device)
        named = {"betas": betas, "Xbs": Xbs, "y": y, "w": w, "L": L,
                 "offset": offset, "params": params, "budget": budget}
        g = _StepGraph({k: torch.empty_like(t) for k, t in named.items()
                        if t is not None}, design)
        ins = g.inputs
        flow = CapturedFlow(self.device, self._pools)
        with torch.cuda.stream(flow.capture_stream), \
                kops.deferred_launches() as head:
            g.graph.capture_begin(pool=self._pools.ids[0],
                                  capture_error_mode="thread_local")
            try:
                g.outputs = self._chunk_core(
                    flow, bucket, design, ins["y"], ins.get("w"),
                    ins["betas"], ins["Xbs"], ins["L"], ins["offset"],
                    datafit, penalty_cls, ins["params"], tol, eps_frac,
                    ins["budget"], growth)
            finally:
                g.graph.capture_end()
        if head:
            raise RuntimeError("chunk capture: a kernel launched outside the "
                               "outer loop")
        g.head, g.scopes = head, flow.scopes
        self._graphs[key] = g
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s.append(time.perf_counter() - t0)
        return g

    def _device_params(self, penalty):
        """The penalty's codec vector on the engine's device, made once
        for each new value (a solve makes it at its first step; its
        replays bind it without a copy)."""
        key = (type(penalty), tuple(penalty_params(penalty).tolist()))
        if self._params[0] != key:
            self._params = (key, penalty_params(penalty, self.device))
        return self._params[1]

    def _design_tag(self, design):
        """A serial naming `design` in the step keys: unlike its id, never
        taken again by a later design once this one is freed (the screened
        path frees the slot designs it outgrows)."""
        ref, tag = self._tags.get(id(design), (None, None))
        if ref is None or ref() is not design:
            tag = next(self._serials)
            self._tags[id(design)] = (weakref.ref(design), tag)
        return tag

    def _replay(self, bucket, design, y, w, beta, Xb, L, offset, datafit,
                penalty, params, tol, eps_frac):
        key = (bucket, self._design_tag(design), tuple(y.shape), w is None,
               tuple(beta.shape), beta.dtype, datafit, type(penalty),
               float(tol), float(eps_frac))
        g = self._graphs.get(key)
        if g is None:
            g = self._capture(key, bucket, design, y, w, beta, Xb, L, offset,
                              datafit, type(penalty), params, tol, eps_frac)
        for name, t in (("y", y), ("w", w), ("L", L), ("offset", offset),
                        ("params", params)):
            if t is not None:
                g.bind(name, t)
        g.inputs["beta"].copy_(beta)
        g.inputs["Xb"].copy_(Xb)
        g.graph.replay()
        beta_out, Xb_out, rd = g.outputs
        # copies: a later replay of this or another graph of the engine
        # reuses the outputs' memory
        beta_new, Xb_new = beta_out.clone(), Xb_out.clone()
        kkt, obj, gcount, n_ep, cov = rd.tolist()      # the one host read
        blocks = int(n_ep) // self.config.M
        kops.add_launches(g.head)
        for kind, _, launches in g.scopes:
            kops.add_launches(launches,
                              blocks if kind == "loop" else int(blocks > 0))
        return StepResult(beta_new, Xb_new, kkt, obj, int(gcount), int(n_ep),
                          bool(cov), 1)

    def _capture(self, key, bucket, design, y, w, beta, Xb, L, offset,
                 datafit, penalty_cls, params, tol, eps_frac):
        """Capture the step for `key` into a graph on the engine's pools
        (the design is read in place; the other tensors, the penalty's
        codec vector among them, through static inputs: the step runs on
        the `penalty_cls` penalty bound to the static vector)."""
        t0 = time.perf_counter()
        if self._pools is None:
            self._pools = GraphPools(self.device)
        named = {"beta": beta, "Xb": Xb, "y": y, "w": w, "L": L,
                 "offset": offset, "params": params}
        g = _StepGraph({k: torch.empty_like(t) for k, t in named.items()
                        if t is not None}, design)
        ins = g.inputs
        flow = CapturedFlow(self.device, self._pools)
        with torch.cuda.stream(flow.capture_stream), \
                kops.deferred_launches() as head:
            g.graph.capture_begin(pool=self._pools.ids[0],
                                  capture_error_mode="thread_local")
            try:
                g.outputs = self._step_core(
                    flow, bucket, design, ins["y"], ins.get("w"),
                    ins["beta"], ins["Xb"], ins["L"], ins["offset"], datafit,
                    bind_penalty(penalty_cls, ins["params"]), ins["params"],
                    tol, eps_frac)
            finally:
                g.graph.capture_end()
        g.head, g.scopes = head, flow.scopes
        self._graphs[key] = g
        self.captures[key] = self.captures.get(key, 0) + 1
        self.capture_s.append(time.perf_counter() - t0)
        return g

    def drop_graphs(self, design):
        """Retire the captured steps that read `design`, so that it is
        freed with its last reference. A retired graph is never replayed
        again; it lives on without its design and tensors until
        ``release_graphs``, because the graphs' pool is freed with its last
        graph and a capture into a freed pool fails."""
        tag = self._design_tag(design)
        for key in [k for k in self._graphs if k[1] == tag]:
            self._retired.append(self._graphs.pop(key).graph)

    def release_graphs(self):
        """Drop the captured steps and hand their memory back."""
        self._graphs.clear()
        self._retired.clear()
        if self._pools is not None:
            self._pools.release()
            self._pools = None

    def probe(self, design, y, beta, Xb, L, offset, datafit, penalty,
              w=None):
        """(kkt, |gsupp|, obj) of an initial iterate, in one host read."""
        grad = design.score(_df_raw(datafit, Xb, y, w),
                            use_kernels=self.config.use_kernels)
        grad = grad + _bcast(offset, grad)
        scores = violation_scores(penalty, beta, grad, L,
                                  use_fixed_point=self.config.use_fp_score)
        kkt, gcount, obj = _read(
            torch.max(scores),
            torch.sum(penalty.generalized_support(beta)),
            self._objective(datafit, penalty, Xb, y, w, offset, beta))
        return kkt, int(gcount), obj

    def validate(self, datafit, penalty, n_tasks=0, weighted=False,
                 design=None):
        """Static feasibility checks, raised at ``solve()`` entry with the
        reference's messages. ``n_tasks > 0`` marks a multitask solve
        (2-D coefficients), which needs a block penalty on every route."""
        if weighted and not getattr(datafit, "SUPPORTS_WEIGHTS", False):
            raise NotImplementedError(
                f"sample_weight=...: datafit {type(datafit).__name__} "
                f"does not support sample weights (declare "
                f"SUPPORTS_WEIGHTS=True and accept w in "
                f"value/raw_grad/lipschitz/make_gram)")
        if n_tasks and type(penalty) in SCALAR_COORD_PENALTIES:
            raise NotImplementedError(
                f"multitask (2-D coefficients) solves need a block "
                f"penalty (BlockL1/BlockMCP): "
                f"{type(penalty).__name__} scores coordinates "
                f"elementwise and cannot rank feature rows; see the "
                f"supported-path matrix in README.md")
        if self.config.use_kernels:
            if design is not None and design.KIND == "csc" and \
                    not design.has_ell:
                raise NotImplementedError(PALLAS_SPARSE_ELL_ERROR)
            check_score_kernel_penalty(type(penalty))
            penalty_params(penalty)       # raises on per-coordinate params
            if not self.config.gram and n_tasks == 0 and \
                    type(datafit).__name__ not in KERNEL_DATAFIT_KINDS:
                raise ValueError(
                    f"backend='pallas' has no Xb kernel for datafit "
                    f"{type(datafit).__name__}")
