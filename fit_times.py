#!/usr/bin/env python3
"""Time the kernel route of the small-K fits of ``chip_smoke.py`` several
times on one CUDA card, to compare two trees of the port.

    python3 fit_times.py [--deep] [--sparse] [--path] [SRC]
    python3 fit_times.py --pool LOG [LOG ...]

SRC is the ``src`` directory whose ``repro_torch`` is timed (default: this
checkout's). The fits are those of ``chip_smoke.py`` at its full sizes: the
M/EEG MultiTaskLasso and MultiTaskMCP(gamma=3) at lambda_max/10, the dense
MultiTaskLasso at lambda_max/10, the dense Lasso at lambda_max/20 and
MCPRegression(gamma=3) at lambda_max/10 on the ``cv_fig`` design
(n = 10,000, p = 20,000: the fits that run K3 most), the dense
SparseLogisticRegression at lambda_max/3, and the two fits whose time is
mostly K1's Gram epochs: the dense LinearSVC(C=1) at the fig. 9 size
(n = 2000, p = 1000) and the LinearSVC(C=1) on the scipy sparse X of
``sparse_small`` (2000 x 8000).
``--deep`` adds the deep weighted sparse logistic regression of
``chip_smoke.py`` (``sparse_fig2`` at lambda_max/30, K2 at K = 4096;
3 repeats). ``--sparse`` times only the two fits that run the sparse
score pass most, on ``sparse_fig2`` (n = 50,000, p = 200,000): the Lasso
at lambda_max/300 (K5 on every outer head) and the MultiTaskLasso at
lambda_max/300 on T = 20 tasks of ``chip_smoke.py``'s multitask phase (K5b
on every head), 5 repeats each. Each is fitted once to warm up and then ``REPS`` times; the
wall times (synchronized), with their median, the outer steps, the host
reads, the peak allocated device memory of a fit, the peak reserved
memory of the warm-up fit (the allocator's cache emptied before it) and
the host seconds of the CUDA graph captures (a tree without them reports
none) are printed as one JSON line.

``--path`` times only the regularization path (a) of ``chip_smoke.py``:
30 lambdas of a dense Lasso on the ``cv_fig`` design from lambda_max to
lambda_max/100 at tol 1e-6, ``PATH_REPS`` times after a warm-up, each on a
new engine. A tree whose ``repro_torch.core`` has ``reg_path`` runs it
("path"); on every tree the loop that users write without it runs too
("loop": warm-started ``solve(engine=...)`` per lambda on one engine,
which on a tree that keys its captured steps by the penalty's values
captures once per (lambda, bucket)). Each gives the wall times, the
captures and their seconds, the host reads and the peak allocated and
reserved memory of the sweep (the allocator's cache emptied before each).

``--pool`` reads the JSON lines of several such runs (one process each,
alternating between two trees in one call) and prints, for each tree (its
``src``) and fit, the median and interquartile range of all its walls and
the range of the per-process medians.
"""
from __future__ import annotations

import json
import statistics
import sys
import time
from pathlib import Path

import chip_smoke as cs

REPS = 7
PATH_REPS = 3
DEEP = False
SPARSE = False
PATH = False


def pool(paths) -> int:
    runs = {}
    for path in paths:
        line = Path(path).read_text().strip().splitlines()[-1]
        rec = json.loads(line)
        for label, fit in rec["fits"].items():
            runs.setdefault(rec["src"], {}).setdefault(label, []).append(fit)
    for src, fits in runs.items():
        print(src)
        for label, procs in fits.items():
            walls = sorted(w for p in procs for w in p["walls"])
            q1, med, q3 = statistics.quantiles(walls, n=4)
            meds = [statistics.median(p["walls"]) for p in procs]
            mem = [(p["peak_bytes"], p.get("reserved_bytes", 0))
                   for p in procs]
            print(f"  {label}: {len(procs)} processes, median "
                  f"{1e3 * med:.1f} ms (IQR {1e3 * q1:.1f}-{1e3 * q3:.1f}), "
                  f"process medians {1e3 * min(meds):.1f}-"
                  f"{1e3 * max(meds):.1f} ms, peak allocated "
                  f"{max(a for a, _ in mem) / 2**30:.3f} GiB, peak "
                  f"reserved {max(r for _, r in mem) / 2**30:.3f} GiB")
    return 0


def main() -> int:
    global DEEP, SPARSE, PATH
    if sys.argv[1:2] == ["--pool"]:
        return pool(sys.argv[2:])
    args = sys.argv[1:]
    DEEP = "--deep" in args
    SPARSE = "--sparse" in args
    PATH = "--path" in args
    args = [a for a in args if a not in ("--deep", "--sparse", "--path")]
    here = Path(__file__).resolve().parent
    src = Path(args[0]).resolve() if args else here / "src"
    sys.path.insert(0, str(src))
    import torch
    if not torch.cuda.is_available():
        print("fit_times: no CUDA device", file=sys.stderr)
        return 2
    import numpy as np
    from repro_torch.core import (Lasso, LinearSVC, Logistic,
                                  MCPRegression, MultiTaskLasso,
                                  MultiTaskMCP, MultitaskQuadratic,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import (make_classification,
                                  make_correlated_design, make_leadfield,
                                  make_multitask, make_sparse_design)
    from repro_torch.kernels import ops
    from repro_torch.sparse import CSCDesign
    dev = torch.device("cuda")
    cfg = cs.FULL
    out = dict(src=str(src), card=cs.card_line(), fits={})

    def timed(label, make, X, Y, sample_weight=None, reps=REPS):
        walls, peaks = [], []
        for i in range(reps + 1):
            est = make()
            torch.cuda.synchronize()
            if not i:
                torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            ops.reset_launch_counts()
            t = time.perf_counter()
            est.fit(X, Y, sample_weight=sample_weight, device=dev)
            torch.cuda.synchronize()
            if i:
                walls.append(time.perf_counter() - t)
                peaks.append(torch.cuda.max_memory_allocated())
            else:
                reserved = torch.cuda.max_memory_reserved()
        res = est.result_
        capture = res.diagnostics.get("capture_s", [])
        out["fits"][label] = dict(
            walls=walls, median=statistics.median(walls),
            converged=bool(est.converged_),
            outer_steps=len(res.kkt_history), host_reads=res.n_host_syncs,
            peak_bytes=max(peaks), reserved_bytes=reserved,
            captures=len(capture),
            capture_s=[float(c) for c in capture],
            launches={k: v for k, v in ops.launch_counts().items() if v})
        cs.log(f"{label}: median {statistics.median(walls):.4f} s, walls "
               f"{[round(w, 4) for w in walls]}, outer steps "
               f"{len(res.kkt_history)}, host reads {res.n_host_syncs}, "
               f"peak {max(peaks) / 2**30:.3f} GiB, reserved "
               f"{reserved / 2**30:.3f} GiB, captures "
               f"{[round(float(c), 4) for c in capture]} s")

    if SPARSE:
        sparse_fits(cfg, dev, timed)
        print(json.dumps(out))
        return 0
    if PATH:
        path_sweeps(cfg, dev, out)
        print(json.dumps(out))
        return 0

    m = cfg["meeg"]
    X, Y, _, _ = make_leadfield(**m)
    lmax = lambda_max(X, Y, MultitaskQuadratic(), device=dev)
    frac = cfg["meeg_frac"]
    timed("M/EEG MultiTaskLasso",
          lambda: MultiTaskLasso(alpha=lmax / frac, tol=cs.TOL), X, Y)
    timed("M/EEG MultiTaskMCP",
          lambda: MultiTaskMCP(alpha=lmax / frac, gamma=3.0, tol=cs.TOL),
          X, Y)

    X, Y, _ = make_multitask(**cfg["mt_dense"])
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, Y, MultitaskQuadratic(), device=dev)
    frac = cfg["mt_dense_frac"]
    timed("dense MultiTaskLasso",
          lambda: MultiTaskLasso(alpha=lmax / frac, tol=cs.TOL), design, Y)
    del design
    torch.cuda.empty_cache()

    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, y, device=dev)
    timed("dense Lasso", lambda: Lasso(alpha=lmax / 20, tol=cs.TOL),
          design, y)
    timed("dense MCPRegression",
          lambda: MCPRegression(alpha=lmax / 10, gamma=3.0, tol=cs.TOL),
          design, y)
    del design
    torch.cuda.empty_cache()

    X, y, _ = make_classification(n=cfg["reg_n"], p=cfg["reg_p"],
                                  n_nonzero=cfg["reg_nnz"], seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, y, Logistic(), device=dev)
    timed("dense SparseLogisticRegression",
          lambda: SparseLogisticRegression(alpha=lmax / 3, tol=cs.TOL),
          design, y)
    del design
    torch.cuda.empty_cache()

    X, y, _ = make_classification(n=cfg["svc_n"], p=cfg["svc_p"],
                                  n_nonzero=cfg["svc_nnz"], seed=0)
    timed("dense LinearSVC", lambda: LinearSVC(C=1.0, max_outer=100,
                                               tol=cs.TOL), X, y)
    Xs, ys, _ = make_sparse_design(**cfg["sparse_small"])
    timed("sparse LinearSVC", lambda: LinearSVC(C=1.0, max_outer=100,
                                                tol=cs.TOL), Xs, np.sign(ys))
    if DEEP:
        # the deep weighted sparse logistic fit (K2 at K = 4096)
        X, y, _ = make_sparse_design(**cfg["sparse"])
        d = CSCDesign.from_scipy(X, ell=True, device=dev)
        del X
        ys = np.sign(y)
        w = np.random.default_rng(1).uniform(0.5, 1.5, d.n_rows)
        lmax = lambda_max(d, ys, Logistic(), sample_weight=w, device=dev)
        k_log = cfg["sparse_lam"][-1][1]
        timed(f"sparse SparseLogisticRegression(lmax/{k_log}, weighted)",
              lambda: SparseLogisticRegression(alpha=lmax / k_log,
                                               tol=cs.TOL),
              d, ys, sample_weight=w, reps=3)
    print(json.dumps(out))
    return 0


def sparse_fits(cfg, dev, timed):
    """The sparse Lasso and the sparse MultiTaskLasso (T = 20) at
    lambda_max/300 on ``sparse_fig2``, as ``chip_smoke.py`` builds them,
    both on one CSC design built once (so no fit converts X)."""
    import numpy as np
    import torch
    from repro_torch.core import (Lasso, MultiTaskLasso, MultitaskQuadratic,
                                  lambda_max)
    from repro_torch.data import make_sparse_design
    from repro_torch.sparse import CSCDesign
    X, y, beta_true = make_sparse_design(**cfg["sparse"])
    d = CSCDesign.from_scipy(X, ell=True, device=dev)
    k_lasso = cfg["sparse_lam"][-1][0]
    lmax = lambda_max(d, y, device=dev)
    timed(f"sparse Lasso(lmax/{k_lasso})",
          lambda: Lasso(alpha=lmax / k_lasso, tol=cs.TOL), d, y, reps=5)
    torch.cuda.empty_cache()
    T = cfg["mt_sparse_T"]
    rng = np.random.default_rng(0)
    supp = np.flatnonzero(beta_true)
    W = np.zeros((X.shape[1], T))
    W[supp] = rng.standard_normal((len(supp), T))
    signal = np.asarray(X @ W)
    noise = rng.standard_normal(signal.shape)
    noise *= np.linalg.norm(signal) / (5.0 * np.linalg.norm(noise))
    Y = signal + noise
    frac = cfg["mt_sparse_frac"]
    lmax = lambda_max(d, Y, MultitaskQuadratic(), device=dev)
    timed(f"sparse MultiTaskLasso(lmax/{frac}, T={T})",
          lambda: MultiTaskLasso(alpha=lmax / frac, tol=cs.TOL), d, Y,
          reps=5)


def path_sweeps(cfg, dev, out):
    """Path (a) of ``chip_smoke.py`` through ``reg_path`` where the tree
    has it, and the warm-started loop of ``solve`` calls on one engine."""
    import numpy as np
    import torch
    import repro_torch.core as core
    from repro_torch.core import L1, Quadratic, lambda_max, make_engine
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_correlated_design
    a = cfg["path_a"]
    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    y = torch.as_tensor(y, device=dev)
    lmax = lambda_max(design, y, device=dev)
    grid = lmax * np.geomspace(1.0, a["ratio"], a["n_lambdas"])

    def loop(eng):
        beta, reads, outer, conv = None, 0, 0, 0
        for lam in grid:
            res = core.solve(design, y, Quadratic(), L1(float(lam)),
                             tol=a["tol"], beta0=beta, engine=eng)
            beta = res.beta
            reads += res.n_host_syncs
            outer += len(res.kkt_history)
            conv += res.converged
        return dict(host_reads=reads, outer_steps=outer, converged=conv)

    def path(eng):
        res = core.reg_path(design, y, L1(1.0), lambdas=grid, tol=a["tol"],
                            engine=eng)
        return dict(host_reads=res.n_host_syncs,
                    outer_steps=int(np.sum(res.n_outer + (res.kkts
                                                          <= a["tol"]))),
                    converged=int(np.sum(res.kkts <= a["tol"])))

    runs = [("loop", loop)]
    if hasattr(core, "reg_path"):
        runs.insert(0, ("path", path))
    for label, sweep in runs:
        walls, peaks, reserved, caps = [], [], [], []
        for i in range(PATH_REPS + 1):
            eng = make_engine(L1(1.0), Quadratic(), device=dev)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            t = time.perf_counter()
            rec = sweep(eng)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            if i:
                walls.append(wall)
                peaks.append(torch.cuda.max_memory_allocated())
                reserved.append(torch.cuda.max_memory_reserved())
                caps.append([float(c) for c in eng.capture_s])
            eng.release_graphs()
            del eng
        out["fits"][f"path (a) {label}"] = dict(
            walls=walls, median=statistics.median(walls),
            peak_bytes=max(peaks), reserved_bytes=max(reserved),
            captures=len(caps[-1]), capture_s=caps[-1], **rec)
        cs.log(f"path (a) {label}: median {statistics.median(walls):.4f} s, "
               f"walls {[round(w, 4) for w in walls]}, {rec}, captures "
               f"{len(caps[-1])} ({sum(caps[-1]):.3f} s), peak "
               f"{max(peaks) / 2**30:.3f} GiB, reserved "
               f"{max(reserved) / 2**30:.3f} GiB")


if __name__ == "__main__":
    sys.exit(main())
