#!/usr/bin/env python3
"""Drive the PyTorch port (``src/repro_torch``) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which must pass (any failure exits non-zero):

1. device: the card's name and power limit (nvidia-smi); TF32 off.
2. build: nvcc builds every kernel source of ``src/repro_torch/csrc`` at
   first use; the ptxas register / shared-memory report is printed.
3. dense kernels: K1 (``cd_epoch_gram``), K2 (``cd_epoch_xb``), K3
   (``fused_ws``) and K4 (``ws_score``) on the card against their plain
   torch versions on the same inputs, at main-path shapes, float64.
   Tolerances are those of the reference's kernel tests: |err| <=
   1e-12 + 1e-5 |ref| for K1, 1e-11 + 1e-8 |ref| for K2 (also at
   n = 50,000, its global-memory branch), 1e-12 + 1e-11 |ref| (scores) and
   1e-12 + 1e-10 |ref| (grad) for K3, whose working set must be identical
   and whose gathered columns must be bit-exact, and the K3 score bound for
   K4 (7 penalties x fixed-point x weights).
4. dense main path: four fits through the estimators at full width, each
   on the kernel route (the estimators' default arguments on the card;
   launch counts reset just before, read just after; each of its kernels
   must have launched) and on the plain-torch route (``use_kernels=False``)
   on the same card; each must converge at tol 1e-6 and the two routes
   must agree to 1e-6 on the coefficients.
5. sparse path: the repo's full-size sparse configuration (``sparse_fig2``
   "small" of ``benchmarks/bench_engine.py``: n = 50,000, p = 200,000,
   density 1e-3), built on the host once as a CSC design with the ELL
   flag. K5 (``csc_score``) and K5s (``csc_weighted_col_sq``) against their
   plain versions within 1e-12 + 1e-12 |ref|, run twice (the kernel must
   be deterministic), on it and on a small design with empty columns and
   columns at the window cap. Then, on both routes with the checks of
   phase 4, a Lasso at lambda_max/10 and a weighted sparse logistic
   regression at lambda_max/3, the same two at lambda_max/300 and
   lambda_max/30 (working sets of 2048 and 4096 columns), and a LinearSVC
   on a scipy sparse X (label-signed Z^T converted by the estimator): the
   kernel route must launch K5 on every outer head, K5s once in each
   weighted fit, K1 (Lasso, SVC) or K2 (logistic), and never K3.
6. times: each kernel at main-path shapes (CUDA events, warm), its plain
   version, its bound (bytes over 3.35 TB/s or operations over 67 TF/s
   float64, the larger) and, where one PyTorch call computes the same
   function (or a part of it), that call's time.

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout holding ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12           # H100 SXM HBM3 (data sheet)
F64_OPS_PER_S = 67e12               # H100 SXM float64 tensor-core peak
TOL = 1e-6
PENALTY_SPECS = [("L1", (0.11,)), ("L1L2", (0.11, 0.6)), ("MCP", (0.11, 3.0)),
                 ("SCAD", (0.11, 3.7)), ("L05", (0.05,)), ("L23", (0.05,)),
                 ("Box", (0.8,))]
FULL = dict(k1_sizes=(256, 1024), k2_K=512, k2_n=10_000, k2_big_n=50_000,
            k3_n=10_000, k3_p=20_000, k3_ws=(64, 1024), reg_n=10_000,
            reg_p=20_000, reg_nnz=150, svc_n=2000, svc_p=1000, svc_nnz=100,
            sparse=dict(n=50_000, p=200_000, density=1e-3, n_nonzero=200,
                        seed=0, snr=5.0),
            sparse_small=dict(n=2000, p=8000, density=5e-3, n_nonzero=40,
                              seed=1),
            sparse_lam=((10, 3), (300, 30)),  # lambda_max / (Lasso, logistic)
            reps=20)


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def close(a, b, atol, rtol):
    """(ok, max |a - b|) under |a - b| <= atol + rtol |b|."""
    import torch
    d = torch.abs(a - b)
    return bool(torch.all(d <= atol + rtol * torch.abs(b))), \
        float(torch.max(d)) if d.numel() else 0.0


def time_ms(fn, dev, reps):
    """Mean ms of one call, warm: CUDA events around `reps` calls."""
    import torch
    fn()
    if dev.type != "cuda":
        t = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t) * 1e3 / reps
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def bound(nbytes, nops):
    t_b, t_o = nbytes / HBM_BYTES_PER_S, nops / F64_OPS_PER_S
    return (max(t_b, t_o) * 1e3, "bytes" if t_b >= t_o else "operations")


def penalties():
    from repro_torch.core import penalties as P
    return [getattr(P, name)(*args) for name, args in PENALTY_SPECS]


# ------------------------------------------------------------------ inputs
def gram_inputs(K, dev, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = 3 * K
    X = torch.randn(n, K, generator=g, dtype=torch.float64).to(dev)
    y = torch.randn(n, generator=g, dtype=torch.float64).to(dev)
    G = (X.T @ X / n).t().contiguous().t()      # column-major, as the engine
    c = X.T @ y / n
    beta0 = (0.1 * torch.randn(K, generator=g, dtype=torch.float64)).to(dev)
    return G, c, beta0, G @ beta0, torch.diagonal(G).contiguous()


def xb_inputs(K, n, kind, dev, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    Xt = torch.randn(K, n, generator=g, dtype=torch.float64).to(dev)
    y = torch.sign(torch.randn(n, generator=g, dtype=torch.float64)).to(dev)
    w = (2.0 * torch.rand(n, generator=g, dtype=torch.float64)).to(dev)
    w = w * (n / w.sum())
    beta0 = (0.05 * torch.randn(K, generator=g, dtype=torch.float64)).to(dev)
    L = torch.sum(Xt * Xt, dim=1)
    L = L / n if kind == "quadratic" else L / (4 * n) if kind == "logistic" \
        else L
    off = -torch.ones(K, dtype=torch.float64, device=dev) if kind == "svc" \
        else torch.zeros(K, dtype=torch.float64, device=dev)
    return Xt, y, w, beta0, beta0 @ Xt, L, off


def fused_inputs(n, p, dev, seed, ties=False):
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    if ties:
        # integer design with every column twice: exact dots, exact ties
        half = torch.randint(-3, 4, (p // 2, n), generator=g, device=dev)
        Xt = torch.cat([half, half]).to(torch.float64)
        r = torch.randint(-2, 3, (n,), generator=g,
                          device=dev).to(torch.float64)
        beta = torch.randint(-1, 2, (p,), generator=g, device=dev) * \
            (torch.rand(p, generator=g, device=dev) < 0.01)
        beta = beta.to(torch.float64)
    else:
        Xt = torch.randn(p, n, generator=g, device=dev, dtype=torch.float64)
        r = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
        beta = torch.randn(p, generator=g, device=dev, dtype=torch.float64) \
            * (torch.rand(p, generator=g, device=dev) < 0.3)
    L = torch.clamp(torch.sum(Xt * Xt, dim=1) / n, min=1e-12)
    return Xt, r, beta, L, torch.zeros(p, dtype=torch.float64, device=dev)


# ----------------------------------------------------------- kernel checks
def check_kernels(dev, cfg):
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              cd_epoch_xb_plain)
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.fused_ws import fused_ws_plain
    from repro_torch.core.working_set import (candidate_columns,
                                              select_working_set)
    from repro_torch.core.penalties import L1, L1L2, MCP, Box
    errs, fails = {"cd_epoch_gram": 0.0, "cd_epoch_xb": 0.0,
                   "fused_ws": 0.0}, []

    for K in cfg["k1_sizes"]:
        G, c, beta0, q0, L = gram_inputs(K, dev, seed=K)
        for pen in penalties():
            for epochs in (1, 5):
                args = (G, c, beta0, q0, L, type(pen), penalty_params(pen))
                bk, qk = ops.cd_epoch_gram(*args, epochs=epochs)
                br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
                for a, b in ((bk, br), (qk, qr)):
                    ok, e = close(a, b, 1e-12, 1e-5)
                    errs["cd_epoch_gram"] = max(errs["cd_epoch_gram"], e)
                    if not ok:
                        fails.append(f"K1 K={K} {type(pen).__name__} "
                                     f"epochs={epochs} err={e:.3e}")

    K, n = cfg["k2_K"], cfg["k2_n"]
    for kind, pens in (("quadratic", (L1(0.07), MCP(0.07, 3.0))),
                       ("logistic", (L1(0.07), MCP(0.07, 3.0))),
                       ("svc", (Box(0.9),))):
        Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, kind, dev, seed=7)
        for pen in pens:
            for wt in ((None,) if kind == "svc" else (None, w)):
                args = (Xt, y, beta0, Xb0, L, off, type(pen),
                        penalty_params(pen), kind)
                bk, xk = ops.cd_epoch_xb(*args, w=wt, epochs=2)
                br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=2)
                for a, b in ((bk, br), (xk, xr)):
                    ok, e = close(a, b, 1e-11, 1e-8)
                    errs["cd_epoch_xb"] = max(errs["cd_epoch_xb"], e)
                    if not ok:
                        fails.append(f"K2 {kind} {type(pen).__name__} "
                                     f"w={wt is not None} err={e:.3e}")
        del Xt

    n, p = cfg["k3_n"], cfg["k3_p"]
    for ties in (False, True):
        Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=3, ties=ties)
        cases = [(pen, fp) for pen in penalties() for fp in (False, True)]
        if ties:
            # penalties whose score arithmetic is exact on integer data
            cases = [(L1(0.5), False), (L1L2(0.5, 0.5), False),
                     (Box(0.8), False)]
        for pen, fp in cases:
            gs = pen.generalized_support(beta)
            for ws_size in cfg["k3_ws"]:
                args = (Xt, r, beta, L, off, gs, type(pen),
                        penalty_params(pen), ws_size)
                sk, gk, ik, ck = ops.fused_ws(*args, use_fp=fp)
                sr, gr, _, _ = fused_ws_plain(*args, use_fp=fp)
                ok1, e1 = close(sk, sr, 1e-12, 1e-11)
                ok2, e2 = close(gk, gr, 1e-12, 1e-10)
                ws_k = select_working_set(sk, gs, ws_size)
                ws_r = select_working_set(sr, gs, ws_size)
                same_ws = bool(torch.equal(ws_k, ws_r))
                cols = candidate_columns(ik, ck, ws_k, p)
                exact = bool(torch.equal(cols, Xt[ws_k].T))
                if ties:
                    same_ws = same_ws and bool(torch.equal(sk, sr))
                errs["fused_ws"] = max(errs["fused_ws"], e1, e2)
                if not (ok1 and ok2 and same_ws and exact):
                    fails.append(
                        f"K3 {type(pen).__name__} fp={fp} ws={ws_size} "
                        f"ties={ties} scores={e1:.3e} grad={e2:.3e} "
                        f"same_ws={same_ws} exact_cols={exact}")
                del ck, cols
        del Xt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return errs, fails


def check_k2_big_and_k4(dev, cfg, errs):
    """K2 at n = 50,000 (its global-memory branch) and K4 against their
    plain versions; updates `errs`, returns the failures."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_plain
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.ws_score import ws_score_plain
    fails = []
    errs.update(ws_score=0.0)

    K, n = cfg["k2_K"], cfg["k2_big_n"]
    Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, "logistic", dev, seed=9)
    args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.002)),
            "logistic")
    for wt in (None, w):
        bk, xk = ops.cd_epoch_xb(*args, w=wt, epochs=2)
        br, xr = cd_epoch_xb_plain(*args, w=wt, epochs=2)
        moved = int(torch.sum(bk != beta0))
        for a, b in ((bk, br), (xk, xr)):
            ok, e = close(a, b, 1e-11, 1e-8)
            errs["cd_epoch_xb"] = max(errs["cd_epoch_xb"], e)
            if not ok:
                fails.append(f"K2 n={n} logistic w={wt is not None} "
                             f"err={e:.3e}")
        log(f"  K2 at K={K}, n={n}, w={wt is not None}: {moved} "
            f"coordinates moved")
    del Xt

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    w = 2.0 * torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    for pen in penalties():
        for fp in (False, True):
            for wt in (None, w):
                args = (Xt, r, beta, L, off, type(pen), penalty_params(pen))
                sk = ops.ws_score(*args, w=wt, use_fp=fp)
                sr = ws_score_plain(*args, w=wt, use_fp=fp)
                ok, e = close(sk, sr, 1e-12, 1e-11)
                errs["ws_score"] = max(errs["ws_score"], e)
                if not ok:
                    fails.append(f"K4 {type(pen).__name__} fp={fp} "
                                 f"w={wt is not None} err={e:.3e}")
    del Xt
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return fails


def check_k5(dev, designs, errs):
    """K5 and K5s against their plain versions (and K5 against the ELL
    reference), twice each to check that the kernel is deterministic;
    updates `errs`, returns the failures."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.csc_score import csc_score_plain
    fails = []
    errs.update(csc_score=0.0, csc_weighted_col_sq=0.0)
    for label, d in designs:
        g = torch.Generator(device=dev).manual_seed(11)
        raw = torch.randn(d.n_rows, generator=g, device=dev,
                          dtype=torch.float64)
        w = torch.rand(d.n_rows, generator=g, device=dev,
                       dtype=torch.float64) + 0.5
        args = (d.data, d.indices, d.col_ids, d.indptr)
        for name, tag, v, square in (("csc_score", "K5", raw, False),
                                     ("csc_weighted_col_sq", "K5s", w,
                                      True)):
            fn = getattr(ops, name)
            k = fn(*args, v)
            ok, e = close(k, csc_score_plain(*args, v, square=square),
                          1e-12, 1e-12)
            same = bool(torch.equal(k, fn(*args, v)))
            if not square:
                ok2, e2 = close(k, d.score_ell_reference(v), 1e-12, 1e-12)
                ok, e = ok and ok2, max(e, e2)
            errs[name] = max(errs[name], e)
            if not (ok and same):
                fails.append(f"{tag} {label} err={e:.3e} "
                             f"deterministic={same}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return fails


# --------------------------------------------------------------- main path
def _fit(make, design, y, dev, kernels, sample_weight=None):
    import torch
    from repro_torch.kernels import ops
    # the kernel route is the estimators' default on the card
    est = make(tol=TOL) if kernels else make(use_kernels=False, tol=TOL)
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    est.fit(design, y, sample_weight=sample_weight, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = ops.launch_counts()
    res = est.result_
    peak = torch.cuda.max_memory_allocated() / 2**30 \
        if dev.type == "cuda" else float("nan")
    log(f"  {'kernels' if kernels else 'plain  '}: wall {wall:.3f} s, "
        f"converged {res.converged}, kkt {res.kkt:.3e}, outer "
        f"{res.n_outer}, epochs {res.n_epochs}, ws {res.ws_history}, "
        f"host syncs "
        f"{res.n_host_syncs} ({res.n_host_syncs / max(1, len(res.kkt_history)):.1f} "
        f"per outer), peak mem {peak:.2f} GiB, launches {counts}")
    return est, counts


def fit_both(label, make, design, y, dev, total, fails, needs, *,
             sample_weight=None, exact=None, per_head=None):
    """One fit on the kernel route and on the plain route. Fails unless
    both converge, the coefficients agree to TOL, each kernel in `needs`
    launched, each in `exact` launched exactly that often, and `per_head`
    launched at least once per outer head. Adds the kernel route's launch
    counts to `total`."""
    import numpy as np
    log(f"fit {label}")
    ek, counts = _fit(make, design, y, dev, True, sample_weight)
    ep, _ = _fit(make, design, y, dev, False, sample_weight)
    for k in total:
        total[k] += counts[k]
    heads = len(ek.result_.kkt_history)
    diff = float(np.max(np.abs(ek.coef_ - ep.coef_)))
    ok = (ek.converged_ and ep.converged_ and diff <= TOL
          and np.all(np.isfinite(ek.coef_))
          and all(counts[k] > 0 for k in needs)
          and all(counts[k] == v for k, v in (exact or {}).items())
          and (per_head is None or counts[per_head] >= heads))
    log(f"  max |coef kernels - coef plain| = {diff:.3e}, "
        f"nnz {int(np.sum(ek.coef_ != 0))}, outer heads {heads}, ok {ok}")
    if not ok:
        fails.append(f"{label}: converged {ek.converged_}/"
                     f"{ep.converged_}, diff {diff:.3e}, heads {heads}, "
                     f"launches {counts}")
    return ek


def main_path(dev, cfg):
    """The four dense fits; returns (launch counts summed over the
    kernel-route fits, failures)."""
    import torch
    from repro_torch.core import (Lasso, LinearSVC, Logistic, MCPRegression,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.core.api import lasso_gap
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_classification, make_correlated_design
    from repro_torch.kernels import ops
    total = dict.fromkeys(ops.launch_counts(), 0)
    fails = []

    def run(label, make, design, y, needs):
        return fit_both(label, make, design, y, dev, total, fails, needs)

    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, y, device=dev)
    est = run("Lasso(lmax/20)", lambda **k: Lasso(alpha=lmax / 20, **k),
              design, y, ("fused_ws", "cd_epoch_gram"))
    gap, primal = lasso_gap(design.X, y, est.coef_, lmax / 20, device=dev)
    log(f"  Lasso duality gap {gap:.3e} (primal {primal:.6f})")
    run("MCPRegression(lmax/10, gamma=3)",
        lambda **k: MCPRegression(alpha=lmax / 10, gamma=3.0, **k),
        design, y, ("fused_ws", "cd_epoch_gram"))
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    X, y, _ = make_classification(n=cfg["reg_n"], p=cfg["reg_p"],
                                  n_nonzero=cfg["reg_nnz"], seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, y, Logistic(), device=dev)
    run("SparseLogisticRegression(lmax/3)",
        lambda **k: SparseLogisticRegression(alpha=lmax / 3, **k),
        design, y, ("fused_ws", "cd_epoch_xb"))
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    X, y, _ = make_classification(n=cfg["svc_n"], p=cfg["svc_p"],
                                  n_nonzero=cfg["svc_nnz"], seed=0)
    run("LinearSVC(C=1)", lambda **k: LinearSVC(C=1.0, max_outer=100, **k),
        X, y, ("fused_ws", "cd_epoch_gram"))
    return total, fails


def sparse_designs(dev, cfg):
    """The full-size sparse problem (a CSC design with the ELL flag, built
    on the host and moved to `dev`, and its target) and a small design with
    empty columns and columns at the window cap."""
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_design
    from repro_torch.sparse import CSCDesign
    t = time.perf_counter()
    X, y, _ = make_sparse_design(**cfg["sparse"])
    t_gen = time.perf_counter() - t
    t = time.perf_counter()
    d = CSCDesign.from_scipy(X, ell=True, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    col = np.diff(X.indptr)
    n, p = X.shape
    csc_b = X.nnz * 12 + (p + 1) * 8
    ell_b = p * d.max_col_nnz * 12
    log(f"sparse design {cfg['sparse']}: nnz {X.nnz}, max column nnz "
        f"{d.max_col_nnz}, median {int(np.median(col))}, generated in "
        f"{t_gen:.1f} s, CSC design (ELL flag) built and moved in "
        f"{time.perf_counter() - t:.1f} s; CSC arrays {csc_b / 1e6:.1f} MB "
        f"on the card, the ELL layout would hold {ell_b / 1e6:.1f} MB (not "
        f"stored)")
    Xs = make_sparse_design(**cfg["sparse_small"])[0].tolil()
    Xs[:, 3:9] = 0.0                              # six empty columns
    Xs = Xs.tocsc()
    Xs.eliminate_zeros()
    small = CSCDesign.from_scipy(Xs, ell=True, device=dev)
    cap = int(cfg["sparse_small"]["n"] * 0.02)
    log(f"small sparse design: {Xs.shape}, nnz {Xs.nnz}, empty columns "
        f"{int(np.sum(np.diff(Xs.indptr) == 0))}, columns at the cap "
        f"({cap}) {int(np.sum(np.diff(Xs.indptr) == cap))}")
    return d, y, small


def sparse_path(dev, cfg, d, y):
    """The sparse fits: Lasso and weighted logistic on the full-size design
    at two depths each, and LinearSVC on a scipy sparse X; returns (launch
    counts summed over the kernel-route fits, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (Lasso, LinearSVC, Logistic,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.data import make_sparse_design
    from repro_torch.kernels import ops
    total = dict.fromkeys(ops.launch_counts(), 0)
    fails = []
    # which columns set lambda_max (plain score, not counted)
    corr = torch.abs(d.score(torch.as_tensor(y, device=dev))) / d.n_rows
    top = torch.argsort(corr, descending=True)[:5]
    nnz = (d.indptr[1:] - d.indptr[:-1])[top]
    lmax = lambda_max(d, y, device=dev)
    log(f"sparse lambda_max {lmax:.6f}: set by columns {top.tolist()} of "
        f"nnz {nnz.tolist()}; columns with |X_j^T y|/n >= lambda_max/k: "
        + ", ".join(f"k={k}: {int(torch.sum(corr >= lmax / k))}"
                    for k, _ in cfg["sparse_lam"]))
    ys = np.sign(y)
    w = np.random.default_rng(1).uniform(0.5, 1.5, d.n_rows)
    lmax_log = lambda_max(d, ys, Logistic(), sample_weight=w, device=dev)
    for k_lasso, k_log in cfg["sparse_lam"]:
        fit_both(f"sparse Lasso(lmax/{k_lasso})",
                 lambda **k: Lasso(alpha=lmax / k_lasso, **k),
                 d, y, dev, total, fails, ("csc_score", "cd_epoch_gram"),
                 exact={"fused_ws": 0, "csc_weighted_col_sq": 0},
                 per_head="csc_score")
        fit_both(f"sparse SparseLogisticRegression(lmax/{k_log}, weighted)",
                 lambda **k: SparseLogisticRegression(alpha=lmax_log / k_log,
                                                      **k),
                 d, ys, dev, total, fails, ("csc_score", "cd_epoch_xb"),
                 sample_weight=w,
                 exact={"fused_ws": 0, "csc_weighted_col_sq": 1},
                 per_head="csc_score")
    Xs, ysvc, _ = make_sparse_design(**cfg["sparse_small"])
    fit_both(f"sparse LinearSVC(C=1) on scipy X {Xs.shape}",
             lambda **k: LinearSVC(C=1.0, max_outer=100, **k), Xs,
             np.sign(ysvc), dev, total, fails,
             ("csc_score", "cd_epoch_gram"),
             exact={"fused_ws": 0, "csc_weighted_col_sq": 0},
             per_head="csc_score")
    return total, fails


# ------------------------------------------------------------------- times
def kernel_times(dev, cfg, launches, errs, card, sparse_design):
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              cd_epoch_xb_plain)
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.fused_ws import fused_ws_plain, pick_bp
    reps = cfg["reps"]
    pen = L1(0.11)
    prm = penalty_params(pen)
    rows = []

    K = max(cfg["k1_sizes"])
    G, c, beta0, q0, L = gram_inputs(K, dev, seed=K)
    args = (G, c, beta0, q0, L, L1, prm)
    ms = time_ms(lambda: ops.cd_epoch_gram(*args), dev, reps)
    plain = time_ms(lambda: cd_epoch_gram_plain(*args), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_gram(*args)[0] != beta0))
    b = bound(8 * (moved * K + 6 * K), 2 * moved * K)
    rows.append(dict(name="cd_epoch_gram", route="cuda",
                     source="src/repro_torch/csrc/cd_epoch.cu",
                     replaces="src/repro/kernels/cd_epoch.py:52",
                     launches=launches["cd_epoch_gram"],
                     max_abs_err=errs["cd_epoch_gram"], ms=ms,
                     plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                     library_ms=None,
                     shape=f"K={K}, epochs=1, L1, {moved} coordinates moved"))
    del G

    K, n = cfg["k2_K"], cfg["k2_n"]
    Xt, y, _, beta0, Xb0, L, off = xb_inputs(K, n, "logistic", dev, seed=7)
    args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.07)),
            "logistic")
    ms = time_ms(lambda: ops.cd_epoch_xb(*args), dev, reps)
    plain = time_ms(lambda: cd_epoch_xb_plain(*args), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_xb(*args)[0] != beta0))
    b = bound(8 * (K * n + 3 * n + 5 * K), K * n * 8 + moved * 2 * n)
    rows.append(dict(name="cd_epoch_xb", route="cuda",
                     source="src/repro_torch/csrc/cd_epoch.cu",
                     replaces="src/repro/kernels/cd_epoch.py:128",
                     launches=launches["cd_epoch_xb"],
                     max_abs_err=errs["cd_epoch_xb"], ms=ms,
                     plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                     library_ms=None,
                     shape=f"K={K}, n={n}, logistic, epochs=1, L1, "
                           f"{moved} coordinates moved"))
    del Xt

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=3)
    gs = pen.generalized_support(beta)
    for ws_size in cfg["k3_ws"]:
        args = (Xt, r, beta, L, off, gs, L1, prm, ws_size)
        ms = time_ms(lambda: ops.fused_ws(*args), dev, reps)
        plain = time_ms(lambda: fused_ws_plain(*args), dev, 3)
        lib = time_ms(lambda: torch.mv(Xt, r), dev, reps)
        bp = pick_bp(p)
        C = -(-p // bp) * min(bp, ws_size)
        b = bound(8 * (p * n + n + 4 * p + 2 * p + C * n) + 4 * C, 2 * p * n)
        row = dict(name="fused_ws", route="cuda",
                   source="src/repro_torch/csrc/fused_ws.cu",
                   replaces="src/repro/kernels/fused_ws.py:125",
                   launches=launches["fused_ws"],
                   max_abs_err=errs["fused_ws"], ms=ms, plain_ms=plain,
                   bound_ms=b[0], bound_by=b[1], library_ms=lib,
                   library_call="torch.mv(Xt, r): the gradient part only",
                   shape=f"n={n}, p={p}, ws={ws_size}, bp={bp}, C={C}, L1")
        if ws_size == max(cfg["k3_ws"]):
            rows.append(row)
        else:
            log(f"K3 at ws={ws_size}: {json.dumps(row)}")
    rows += sparse_times(dev, cfg, launches, errs, sparse_design)
    for row in rows:
        log(f"time {row['name']} [{row['shape']}] on {card}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}), library "
            f"{row['library_ms']}")
    log("K1 and K2 are bound by the chain of dependent coordinate steps "
        "(one barrier-separated prox per coordinate), not by bytes: their "
        "bound_ms is the byte/operation floor only.")
    return rows


def sparse_times(dev, cfg, launches, errs, d):
    """The rows of K4 (dense, n x p of K3, weighted), K5 and K5s (the
    full-size sparse design); also logs K2's time at n = 50,000."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_plain
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.csc_score import csc_score_plain
    from repro_torch.kernels.ws_score import ws_score_plain
    reps = cfg["reps"]
    rows = []

    K, n = cfg["k2_K"], cfg["k2_big_n"]
    Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, "logistic", dev, seed=9)
    args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.002)),
            "logistic")
    ms = time_ms(lambda: ops.cd_epoch_xb(*args, w=w), dev, 3)
    plain = time_ms(lambda: cd_epoch_xb_plain(*args, w=w), dev, 1)
    log(f"time cd_epoch_xb at K={K}, n={n}, logistic, weighted, 1 epoch "
        f"(global-memory branch): kernel {ms:.4f} ms, plain {plain:.4f} ms")
    del Xt

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    w = 2.0 * torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    prm = penalty_params(L1(0.11))
    args = (Xt, r, beta, L, off, L1, prm)
    ms = time_ms(lambda: ops.ws_score(*args, w=w), dev, reps)
    plain = time_ms(lambda: ws_score_plain(*args, w=w), dev, reps)
    lib = time_ms(lambda: torch.mv(Xt, r * w), dev, reps)
    b = bound(8 * (p * n + 2 * n + 4 * p), 2 * p * n + n)
    rows.append(dict(name="ws_score", route="cuda",
                     source="src/repro_torch/csrc/fused_ws.cu",
                     replaces="src/repro/kernels/ws_score.py:57",
                     launches=launches["ws_score"],
                     max_abs_err=errs["ws_score"], ms=ms, plain_ms=plain,
                     bound_ms=b[0], bound_by=b[1], library_ms=lib,
                     library_call="torch.mv(Xt, r * w): the gradient part "
                                  "only",
                     shape=f"n={n}, p={p}, L1, weighted"))
    del Xt

    n, p = d.shape
    nnz = d.nnz
    g = torch.Generator(device=dev).manual_seed(11)
    raw = torch.randn(n, generator=g, device=dev, dtype=torch.float64)
    w = torch.rand(n, generator=g, device=dev, dtype=torch.float64) + 0.5
    cargs = (d.data, d.indices, d.col_ids, d.indptr)
    nbytes = nnz * 12 + (p + 1) * 8 + n * 8 + p * 8
    ell = bound(p * d.max_col_nnz * 12 + n * 8 + p * 8, 2 * p * d.max_col_nnz)
    log(f"K5 byte bound with the ELL layout (m={d.max_col_nnz}): "
        f"{ell[0]:.4f} ms")
    for name, v, square, nops in (("csc_score", raw, False, 2 * nnz),
                                  ("csc_weighted_col_sq", w, True,
                                   3 * nnz)):
        fn = getattr(ops, name)
        ms = time_ms(lambda: fn(*cargs, v), dev, reps)
        plain = time_ms(lambda: csc_score_plain(*cargs, v, square=square),
                        dev, reps)
        # a yardstick only, never a route; a failure fails the run
        lib, call = None, "torch.sparse_csr_tensor(X^T) @ v (cuSPARSE)"
        if dev.type == "cuda":
            vals = d.data[:nnz] * d.data[:nnz] if square else d.data[:nnz]
            A = torch.sparse_csr_tensor(d.indptr.to(torch.int32),
                                        d.indices[:nnz], vals, size=(p, n),
                                        check_invariants=True)
            lib = time_ms(lambda: A @ v, dev, reps)
            del A, vals
        b = bound(nbytes, nops)
        rows.append(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/csc_score.cu",
                         replaces="src/repro/sparse/ops.py:156" if not square
                         else "src/repro/sparse/ops.py:201",
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                         library_ms=lib, library_call=call,
                         shape=f"n={n}, p={p}, nnz={nnz}, CSC walk"
                               + (", square" if square else "")))
    return rows


def run(dev, cfg):
    """All phases on `dev`; returns (kernels rows, failures)."""
    import torch
    from repro_torch.kernels._build import BUILD
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    if dev.type == "cuda":
        t = time.perf_counter()
        BUILD.build_all()
        log(f"build: {time.perf_counter() - t:.1f} s")
        for name, text in BUILD.logs.items():
            for line in text.splitlines():
                if any(k in line for k in ("registers", "spill", "error",
                                           "Compiling entry")):
                    log(f"  [{name}] {line.strip()}")

    def report(what, t, fails, kernels):
        log(f"{what} vs plain ({time.perf_counter() - t:.1f} s): "
            + json.dumps({k: {"ok": not any(f.startswith(tag + " ")
                                            for f in fails),
                              "max_abs_err": errs[k]}
                          for k, tag in kernels}))
        for f in fails:
            log(f"  FAIL {f}")

    t = time.perf_counter()
    errs, fails = check_kernels(dev, cfg)
    fails += check_k2_big_and_k4(dev, cfg, errs)
    failures += fails
    report("dense kernels", t, fails,
           (("cd_epoch_gram", "K1"), ("cd_epoch_xb", "K2"),
            ("fused_ws", "K3"), ("ws_score", "K4")))

    t = time.perf_counter()
    launches, fails = main_path(dev, cfg)
    failures += fails
    log(f"dense main path ({time.perf_counter() - t:.1f} s): launches "
        f"{launches}")

    design, y, small = sparse_designs(dev, cfg)
    t = time.perf_counter()
    fails = check_k5(dev, (("sparse_fig2", design), ("small", small)), errs)
    failures += fails
    report("sparse kernels", t, fails,
           (("csc_score", "K5"), ("csc_weighted_col_sq", "K5s")))
    del small
    t = time.perf_counter()
    sparse_launches, fails = sparse_path(dev, cfg, design, y)
    failures += fails
    log(f"sparse main path ({time.perf_counter() - t:.1f} s): launches "
        f"{sparse_launches}")
    for k in launches:
        launches[k] += sparse_launches[k]

    rows = kernel_times(dev, cfg, launches, errs, card, design)
    return rows, failures


def main() -> int:
    here = Path(__file__).resolve().parent
    if not (here / "src" / "repro_torch").is_dir():
        print("chip_smoke: run from a checkout holding src/repro_torch",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(here / "src"))
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    rows, failures = run(dev, FULL)
    log(f"total {time.perf_counter() - t0:.1f} s")
    if failures:
        for f in failures:
            print(f"chip_smoke FAILED: {f}", file=sys.stderr)
        return 1
    print(json.dumps({"kernels": rows}))
    print(card_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
