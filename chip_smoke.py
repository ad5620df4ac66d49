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
   1e-12 + 1e-5 |ref| for K1 (at K = 256, and at the blocked
   kernel's edges K = 1, 31, 33, 1023, 1025, 2049, 4096: one block and
   many, ragged and whole, one CTA and the cluster, all seven penalties
   up to K = 1025 and L1, MCP and SCAD at 2049 and 4096,
   epochs 1 and 3, G column-major and row-major, each launched twice and
   equal bit for bit on its plan's branch; the global-memory branches,
   forced, at K = 2049; a block with L = 0 and a level at which nothing
   moves at K = 1025), 1e-11 + 1e-8 |ref| for K2 (at n = 10,000,
   at the sparse fits' n = 50,000 with K = 512 and the deep fit's 4096, at
   n = 1000 and at n = 160,003, where the slices leave shared memory: each
   branch of its plan, each launched twice and equal bit for bit;
   K1 at K = 1024, K1b at K = 1024, T = 20 and K2 at (512, 10,000) at
   each cluster size the plans step down through, 1, 2, 4, 8 and 16: K1
   and K1b bit for bit, K2 within its bound),
   1e-12 + 1e-11 |ref| (scores) and
   1e-12 + 1e-10 |ref| (grad) for K3 (7 penalties x fixed-point x ws 64
   and 1024, and tied integer data at ws 64, 1024, 8192 and p, where the
   merge launch keeps its lists in global memory), whose cand_idx must be
   exact, whose working set must equal ``select_working_set`` of the plain
   scores and whose gathered rows must be bit-exact against
   ``candidate_columns`` of the plain four outputs, and
   the K3 score bound for K4 (7 penalties x fixed-point x weights).
4. dense main path: four fits through the estimators at full width, each
   on the kernel route (the estimators' default arguments on the card;
   launch counts reset just before, read just after; each of its kernels
   must have launched) and on the plain-torch route (``use_kernels=False``)
   on the same card; each must converge at tol 1e-6 and the two routes
   must agree to 1e-6 on the coefficients. Every kernel-route fit (here
   and in phases 5 and 7) must read the host once per outer step
   (``n_host_syncs == len(kkt_history)``: each step a replayed CUDA
   graph). The Lasso, the MCP and the LinearSVC (the dual's Gram epochs)
   must launch K1 once for every inner epoch. Each of the four runs again
   with its inner loop on the host (``make_engine(capture=False)``, the
   eager oracle), whose coefficients and epochs the captured fit must
   equal bit for bit; the LinearSVC again with a placement test that
   refuses 16 CTAs: its plans must step down to 8 (``ops.cluster_counts``)
   and the fit equal the 16-CTA one bit for bit.
4b. large dense design: the kernel route of ``solve(X, y, Quadratic(),
   L1(lambda_max/10))`` at tol 1e-6 on a design that takes at least 55%
   of the card's memory (n = 10,000, p from ``mem_get_info``, ~596,000 on
   an 80 GB card), made on the card from a seed; no plain route. Its
   plain-torch KKT violation, recomputed over X in chunks, must be <= tol
   and agree with the solver's kkt, and the peak of allocated memory, less
   X's bytes, must stay <= 10% of X's bytes: K3 copies no candidate rows,
   so the dense path holds X once.
5. sparse path: the repo's full-size sparse configuration (``sparse_fig2``
   "small" of ``benchmarks/bench_engine.py``: n = 50,000, p = 200,000,
   density 1e-3), built on the host once as a CSC design with the ELL
   flag. K5 (``csc_score``) and K5s (``csc_weighted_col_sq``) against their
   plain versions within 1e-12 + 1e-12 |ref|, every SM's shared memory
   NaN-filled before the first launch, run twice (the kernel must be
   deterministic), on it and on a small design with empty columns and
   columns at the window cap, where each must also equal the torch
   emulation of its summation order (``csc_score.emulate``) bit for bit.
   Then, on both routes with the checks of
   phase 4, a Lasso at lambda_max/10 and a weighted sparse logistic
   regression at lambda_max/3, the same two at lambda_max/300 and
   lambda_max/30 (working sets of 2048 and 4096 columns), and a LinearSVC
   on a scipy sparse X (label-signed Z^T converted by the estimator): the
   kernel route must launch K5 on every outer head, K5s once in each
   weighted fit, K1 (Lasso, SVC: once for every inner epoch) or K2
   (logistic, on a cluster), and never K3. The deep logistic fit is held
   to its eager oracle bit for bit; the shallow one is run with 16 CTAs
   refused (K2 on 8, within 1e-6 of the 16-CTA fit).
6. block kernels: K3b (``fused_ws_block``) over BlockL1 and BlockMCP x
   fixed-point at n = 10,000, p = 20,000, T = 20, ws = 512, at an odd
   n with a ragged last feature tile (n = 10,001, p = 4963) and at the
   leadfield's n = 305, p = 7498, T = 50, ws = 1024 (the wide product),
   every SM's
   shared memory set to NaN before each launch (scores within 1e-12 +
   1e-12 |ref|, gradient within 1e-12 + 1e-10 |ref|, cand_idx exact, an
   identical working set, its rows of X bit for bit those that
   ``candidate_columns`` recovers from the plain candidate buffer), K1b
   (``cd_epoch_gram_block``) at
   (K, T) = (64, 50), (256, 20), (2049, 1), (2048, 20), (4096, 20) and
   (2048, 240) (one CTA, a cluster with q's rows in shared memory and in
   global memory), within the K1 bound and twice, bit for bit, and K5b
   (``csc_score_block``) on the full-size
   sparse design and the small one with raw [n, 20], within the K5 bound and
   deterministic (on the small design also the emulation of its order,
   bit for bit; shared memory NaN-filled before the first launch); all
   against their plain versions.
7. multitask path, each fit on both routes with the checks of phase 4:
   MultiTaskLasso and MultiTaskMCP(gamma=3) at lambda_max/10 on the M/EEG
   leadfield at the width of a real MEG forward model (n = 305 sensors,
   p = 7498 sources, T = 50; whether each fit finds one source per
   hemisphere is printed), the same Lasso with ``use_gram=False`` (its
   inner epochs are the plain block Xb epoch on both routes: no kernel
   exists for it), a dense MultiTaskLasso at lambda_max/10 on
   ``make_multitask(n=10000, p=20000, n_tasks=20)`` (working set >= 512)
   and a sparse MultiTaskLasso at lambda_max/300 on the scipy X of the
   full-size sparse design with Y = X W + noise, T = 20 (working set
   >= 1024), unweighted and with weights in [0.5, 1.5]. The kernel route
   must launch K3b (dense) or K5b (sparse) on every outer head, K1b on
   every Gram epoch (on a cluster in the sparse fits), K5s once per
   weighted fit, and no scalar K1/K3/K5. The dense MultiTaskLasso is held
   to its eager oracle bit for bit, and run with 16 CTAs refused (K1b on
   8, bit for bit).
7b. regularization paths (``reg_path``), each on a design built once,
   with its wall time, outer steps, epochs, host reads, captures and their
   seconds and peak allocated / reserved memory printed, and its
   kernel-route launches joining the counts: (a) a dense Lasso path on
   ``cv_fig`` (30 lambdas from lambda_max to lambda_max/100, tol 1e-6) on
   the kernel route, equal bit for bit (betas, epochs, outer steps) to the
   same path with ``capture=False``, each step key captured once and no
   more keys than ``BucketPolicy(p0=64).ladder(p)`` has rungs, and its
   first 8 lambdas on the plain route within 1e-6; (b) Figure 1 at its
   paper size (n = 1000, p = 2000, 200 nonzeros, rho = 0.6, SNR 5): L1,
   L1L2(rho=0.5), MCP(gamma=3) and SCAD(gamma=3.7), 15 lambdas to
   lambda_max/100 at tol 1e-7 with ``support_metrics`` on a held-out set
   on the kernel route, equal on all its lambdas bit for bit to
   ``capture=False`` with each step key captured once, its first 3
   lambdas on the plain route within 1e-6 (the plain route's
   per-coordinate Python epochs take 4-5 minutes a penalty for the whole
   grid on an H100), each penalty's best F1 printed; (c) a gap-safe
   screened Lasso path on the full ``sparse_fig2`` design (6 lambdas to
   lambda_max/20, tol 1e-9) within 1e-7 of the unscreened one, its
   screened fractions printed (their maximum above 0.1) and each (bucket,
   slot design) key captured once, then the same on a grid of 20
   lambdas, where survivors keep their power-of-two width from one lambda
   to the next and their slot designs must be refilled in place; (d) a
   MultiTaskLasso path on the M/EEG leadfield (8 lambdas to
   lambda_max/10) equal bit for bit to ``capture=False``. Every lambda must converge.
7c. lane kernels and CV grids: K1l (``cd_epoch_gram_lanes``) at S = 1,
   10 and 50 lanes and K = 31, 256, 1024 and 4096, all seven penalties
   with a parameter row a lane and every third lane frozen by the mask,
   bit for bit per lane against K1 on that lane's inputs, frozen lanes
   unchanged, within K1's bound of its plain version at S = 10 (every
   penalty up to K = 256, L1 above); K1l at S = 10 and K = 1024 and 4096
   forced to each cluster size its lane plan can choose (16, 8, 4, 2), L1
   and MCP, bit for bit per lane against K1, frozen lanes unchanged, with
   the plan it takes there, the clusters the card runs at once and the
   waves printed; K1's and K1l's registers and local bytes a thread
   (``cudaFuncGetAttributes``, every penalty, one CTA and the cluster): a
   K1l instance with more local memory than K1's fails;
   K2l (``cd_epoch_xb_lanes``) at S = 10, K = 512,
   n = 10,000, weighted logistic with a weight row a lane, bit for bit per
   lane against K2 and within K2's bound; K3l (``fused_ws_lanes``) at S =
   10 on the K3 shapes, ws 64 and 1024, random and tied-integer data,
   within K3's bounds (equal on the integers), cand_idx exact, each lane's
   working set ``select_working_set`` of its plain scores and its rows bit
   for bit, and at S = 50 (the (g4) lanes: the wide product) on random
   data at ws 1024 within 1e-12 + 1e-12 |ref| (scores) and 1e-12 + 1e-10
   |ref| (gradient), cand_idx, working sets and rows exact. Then the
   grids at full width on the kernel route, each with
   its wall time, rounds, occupancy, dispatches, outer steps, captures and
   their seconds, peak memory, alpha_ and launches printed, held to
   ``capture=False`` bit for bit (betas, cv_loss, kkts), every item at kkt
   <= tol, each step key captured once, one read a dispatch: (g1)
   ``LassoCV(cv=5, n_alphas=30, eps=1e-2, vmap_chunk=2)`` on ``cv_fig``
   (10 lanes, 150 items, K3l + K1l), its folds 0 and 1 within 1e-5 of the
   sequential path on their row subsets, and its BIC selection (the
   chunked path, 2 lanes) bit for bit; (g2) ``LassoCV(cv=5, n_alphas=10,
   eps=0.1, vmap_chunk=2)`` on ``sparse_fig2`` (K5b at T = 10, K1l, K5s
   once a fold); (g3) ``SparseLogisticRegressionCV(cv=5, n_alphas=10,
   eps=1/3, vmap_chunk=2)`` on ``make_classification(n=10000, p=20000)``
   (K3l + K2l); (g4) the reference's acceptance grid (n = 200, p = 400,
   5 x 30, 50 lanes, tol 1e-8) with its budget contract (one lane count,
   dispatches = reads <= outer steps, an interior minimum), a second grid
   on the same engine and design capturing nothing, and the plain route
   within 1e-6. Each grid's kernels must have launched. The lane epochs'
   launches over the grids are printed by shape (K rounded up to a power
   of two, cluster size), here and after 7d.
7d. multitask lanes: K3bl (``fused_ws_block_lanes``) at S*T = 200
   (n = 10,000, p = 20,000), 500 (the leadfield), an odd 91 (odd n,
   ragged tile) and 25 (one column past 24), BlockL1 and BlockMCP, a
   parameter row a lane: scores and gradient within K3b's bounds, cand_idx
   exact, each lane's working set ``select_working_set`` of its plain
   scores and its rows bit for bit, and a second launch (shared memory
   NaN-filled again) equal to the first bit for bit;
   K1bl (``cd_epoch_gram_block_lanes``) at (S, K, T) = (10, 64, 50),
   (10, 256, 20), (50, 512, 5), (10, 1024, 20) and (4, 2048, 240) (one
   CTA, a cluster with q's rows in shared and in global memory), every
   third lane frozen, bit for bit lane by lane against K1b and within K1's
   bound of its plain version; K5b at 100 and 500 columns bit for bit
   against its emulation; K1bl at those shapes and K1b at its one-CTA
   shapes of phase 6, BlockL1 and BlockMCP, 2 epochs, every third lane
   frozen, a row with L = 0, shared memory NaN-filled, bit for bit
   against ``emulate_block_epoch`` (the kernels' arithmetic order). Then,
   on the kernel route, each held to ``capture=False``
   bit for bit with one read a dispatch and its keys captured once, with
   K3bl/K1bl (or K5b/K1bl) launched and no scalar or single-lane head or
   epoch: (m1) ``cross_val_path(MultitaskQuadratic(), BlockL1 |
   BlockMCP, cv=5, n_lambdas=10, lambda_min_ratio=0.1, vmap_chunk=2)`` on
   the M/EEG leadfield at MEG width (10 lanes, S*T = 500), folds 0 and 1
   within 1e-5 of the sequential multitask path on their rows; (m2) a
   chunked MultiTaskLasso path (10 lambdas to lambda_max/10,
   ``vmap_chunk=5``) on ``make_multitask(10000, 20000, 20)`` within 1e-6
   of the sequential path; (m3) a multitask grid on ``sparse_fig2`` with
   T = 20 (cv=5, 6 lambdas, ``vmap_chunk=1``: K5b at 100 columns, K5s
   once a fold), unweighted and weighted; (m4) a small BlockL1 grid (n =
   200, p = 400, T = 5, 5 x 10, 50 lanes, tol 1e-8), its plain route
   within 1e-6.
8. times: each kernel at main-path shapes (CUDA events, warm), its plain
   version, its bound (bytes over 3.35 TB/s or operations over 67 TF/s
   float64, the larger) and, where one PyTorch call computes the same
   function (or a part of it), that call's time. K3's row splits the head
   into its score launch, select launch, merge launch and gather (and the
   stable sort the merge replaced), each launched and as a replayed CUDA
   graph. The sparse rows (K5, K5s, K5b) keep their HBM byte bound and
   print beside it the floor of their design, a walk of CSC columns that
   gathers raw's rows from L2: ``l2_gather_probe`` timed on nnz gathers
   of raw's rows (8 bytes, a 32-byte sector, for K5/K5s; T values for
   K5b). It is not a bound of the function. K1 has rows at K = 1024
   and 2048, K2 at (K, n) = (512, 10,000), (512, 50,000) and (4096,
   50,000), K1b at K = 1024, 2048 and 4096 (T = 20) and on one CTA at
   (K, T) = (64, 50) and (256, 20) (also replayed from a graph), each
   with its plan's branch, cluster size, threads, launches by branch, and
   chain floor (K1: K chain steps of a shuffle and a multiply-add with a
   handoff every 32, measured by a launch of that chain alone; K2, K1b on
   a cluster: K cluster-barrier round trips on its cluster, measured by a
   launch of barriers alone; K1b on one CTA: K steps of a T-wide norm by
   its shuffle tree, a sqrt and a divide with its named-barrier hand-off,
   measured by a launch of that chain alone).
   The lane rows: K1l (S = 10, K = 1024, on its lane plan, with the
   clusters the card runs at once, the waves and its launches by shape;
   beside it K1l at S = 10, K = 256 and 4096 and S = 50, K = 256 and 1024,
   each with one K1 launch at its K), K2l (S = 10, K = 512, n =
   10,000, weighted logistic) and K3l (S = 10, ws = 1024, with torch.mm
   of X by the lanes' raw gradients as its library call), each beside S
   single-lane launches of its kernel on the same inputs; K3bl (S = 10,
   T = 20, K3b's shape, and at the leadfield's S*T = 500) beside ten K3b
   heads, with its product launches a call (counted by torch.profiler
   over one call) and its scratch bytes, and K3b alone at the leadfield's
   T = 50 (the wide product); K1bl at (S, K, T) = (10, 64, 50) and (50,
   512, 5) (one CTA a lane, where the grids launch it most; also replayed
   from a graph) and (10, 1024, 20), each beside S K1b launches.

It prints one ``{"kernels": [...]}`` JSON line, the card's name and power
limit, and as its last line ``{"ok": true, "device": {...}}``. Without a
CUDA device, or outside a checkout holding ``src/repro_torch``, it exits
non-zero and prints no result.
"""
from __future__ import annotations

import functools
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
FULL = dict(k1_sizes=(256,),
            k1_blocked=(1, 31, 33, 1023, 1025, 2049, 4096), k1_frozen_K=1025, k1_time_K=(1024, 2048),
            k1_all_pens_K=1025, k1_large_pens=("L1", "MCP", "SCAD"),
            k2_K=512, k2_n=10_000,
            k2_big=((512, 50_000), (4096, 50_000), (512, 1000),
                    (128, 160_003)),
            k2_time=((512, 50_000), (4096, 50_000)),
            k3_n=10_000, k3_p=20_000, k3_ws=(64, 1024),
            k3_ws_merge=(8192, 20_000), reg_n=10_000,
            reg_p=20_000, reg_nnz=150, svc_n=2000, svc_p=1000, svc_nnz=100,
            sparse=dict(n=50_000, p=200_000, density=1e-3, n_nonzero=200,
                        seed=0, snr=5.0),
            sparse_small=dict(n=2000, p=8000, density=5e-3, n_nonzero=40,
                              seed=1),
            sparse_lam=((10, 3), (300, 30)),  # lambda_max / (Lasso, logistic)
            k3b=dict(n=10_000, p=20_000, T=20, ws=512),
            # K3b wider than 24 columns: the leadfield fits' T = 50
            k3b_wide=dict(n=305, p=7498, T=50, ws=1024),
            k1b_shapes=((64, 50), (256, 20), (2049, 1), (2048, 20),
                        (4096, 20), (2048, 240)),
            k1b_T=20, k1b_time_K=(1024, 2048, 4096), k5b_T=20,
            # K1b's one-CTA rows: the leadfield fits' K = 64, T = 50 and the
            # largest one-CTA shape of the T = 20 fits
            k1b_onecta_time=((64, 50), (256, 20)),
            meeg=dict(n=305, p_per_hemi=3749, T=50, seed=0), meeg_frac=10,
            mt_dense=dict(n=10_000, p=20_000, n_tasks=20, n_nonzero=150,
                          seed=0),
            mt_dense_frac=10, mt_dense_min_ws=512,
            large=dict(n=10_000, frac=0.56, headroom=8 * 2**30, seed=0,
                       n_nonzero=150, snr=5.0, frac_lambda=10,
                       cpu_bytes=2**27),
            mt_sparse_T=20, mt_sparse_frac=300, mt_sparse_min_ws=1024,
            path_a=dict(n_lambdas=30, ratio=1e-2, tol=1e-6, plain_lambdas=8),
            fig1=dict(n=1000, p=2000, n_nonzero=200, n_lambdas=15, tol=1e-7,
                      plain_lambdas=3),
            screen=dict(n_lambdas=6, ratio=0.05, tol=1e-9, fine_lambdas=20),
            path_mt=dict(n_lambdas=8, ratio=0.1),
            k1l_S=(1, 10, 50), k1l_K=(31, 256, 1024, 4096),
            k1l_plain_S=10, k1l_plain_K=256,
            # K1l forced to each cluster size its lane plan can choose
            k1l_sizes=dict(S=10, K=(1024, 4096)),
            k2l=dict(S=10, K=512, n=10_000),
            k3l=dict(S=10, ws=(64, 1024), wide_S=50),
            lane_time=dict(S=10, K1=1024,
                           k1l_other=((10, 256), (50, 256), (50, 512),
                                      (50, 1024), (10, 4096))),
            g1=dict(cv=5, n_alphas=30, eps=1e-2, vmap_chunk=2, folds=2),
            g2=dict(cv=5, n_alphas=10, eps=0.1, vmap_chunk=2),
            g3=dict(n=10_000, p=20_000, cv=5, n_alphas=10, eps=1 / 3,
                    vmap_chunk=2),
            g4=dict(n=200, p=400, n_nonzero=15, seed=1, n_lambdas=30, cv=5,
                    vmap_chunk=10, tol=1e-8),
            # multitask lanes: K3bl (S, T, n, p, ws), K1bl (S, K, T), K5b at
            # the lanes' widths, the rows, the grids and the path
            k3bl=((10, 20, 10_000, 20_000, 512), (10, 50, 305, 7498, 1024),
                  (7, 13, 10_001, 4963, 256), (5, 5, 10_000, 20_000, 512)),
            k1bl=((10, 64, 50), (10, 256, 20), (50, 512, 5), (10, 1024, 20),
                  (4, 2048, 240)),
            k5b_lane_T=(100, 500),
            mt_lane_time=dict(S=10, T=20, ws=512),
            # K1bl's rows: where the grids launch it most ((m1)'s leadfield
            # lanes on one CTA, (m4)'s 50 lanes at K = 512, T = 5) and on
            # the cluster
            k1bl_time=((10, 64, 50), (50, 512, 5), (10, 1024, 20)),
            m1=dict(cv=5, n_lambdas=10, ratio=0.1, vmap_chunk=2, folds=2),
            m2=dict(n_lambdas=10, ratio=0.1, vmap_chunk=5),
            m3=dict(cv=5, n_lambdas=6, ratio=0.1, vmap_chunk=1),
            m4=dict(n=200, p=400, T=5, n_nonzero=15, seed=1, cv=5,
                    n_lambdas=10, vmap_chunk=10, tol=1e-8),
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


def graph_ms(fn, dev, reps):
    """Mean ms of one replay of `fn` captured into a CUDA graph, warm: the
    device time without the host's launch cost, as the captured outer step
    runs it (None without a card)."""
    import torch
    if dev.type != "cuda":
        return None
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = time_ms(graph.replay, dev, reps)
    del graph
    return ms


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
def check_epoch(name, tag, args, kw, plain, atol, rtol, errs, fails):
    """K2 or K1b (`name`, the ops wrapper) against its plain version, and
    a second launch bit for bit equal to the first (a race between the
    CTAs of a cluster would show as a difference). On the card the launch
    must count on the branch its shape's plan names. Returns (the kernel's
    output, the branch)."""
    import torch
    from repro_torch.kernels import ops
    fn = getattr(ops, name)
    before = ops.branch_counts()[name]
    out = fn(*args, **kw)
    again = fn(*args, **kw)
    after = ops.branch_counts()[name]
    moved = {b for b in after if after[b] != before[b]}
    branch = moved.pop() if len(moved) == 1 else "cpu"
    same = all(torch.equal(a, b) for a, b in zip(out, again))
    ref = plain(*args, **kw)
    err = 0.0
    ok = same and (branch != "cpu" or out[0].device.type == "cpu")
    for a, b in zip(out, ref):
        ok_i, e = close(a, b, atol, rtol)
        ok, err = ok and ok_i, max(err, e)
    errs[name] = max(errs[name], err)
    if not ok:
        fails.append(f"{tag} err={err:.3e} repeat_equal={same} "
                     f"branch={branch}")
    return out, branch


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

    t = time.perf_counter()
    for K in cfg["k1_sizes"]:
        G, c, beta0, q0, L = gram_inputs(K, dev, seed=K)
        for pen in penalties():
            for epochs in (1, 5):
                args = (G, c, beta0, q0, L, type(pen), penalty_params(pen, dev))
                bk, qk = ops.cd_epoch_gram(*args, epochs=epochs)
                br, qr = cd_epoch_gram_plain(*args, epochs=epochs)
                for a, b in ((bk, br), (qk, qr)):
                    ok, e = close(a, b, 1e-12, 1e-5)
                    errs["cd_epoch_gram"] = max(errs["cd_epoch_gram"], e)
                    if not ok:
                        fails.append(f"K1 K={K} {type(pen).__name__} "
                                     f"epochs={epochs} err={e:.3e}")

    log(f"  K1 checks: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    K, n = cfg["k2_K"], cfg["k2_n"]
    for kind, pens in (("quadratic", (L1(0.07), MCP(0.07, 3.0))),
                       ("logistic", (L1(0.07), MCP(0.07, 3.0))),
                       ("svc", (Box(0.9),))):
        Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, kind, dev, seed=7)
        for pen in pens:
            for wt in ((None,) if kind == "svc" else (None, w)):
                args = (Xt, y, beta0, Xb0, L, off, type(pen),
                        penalty_params(pen, dev), kind)
                check_epoch("cd_epoch_xb", f"K2 {kind} {type(pen).__name__}"
                            f" w={wt is not None}", args,
                            dict(w=wt, epochs=2), cd_epoch_xb_plain, 1e-11,
                            1e-8, errs, fails)
        del Xt
    log(f"  K2 checks at n={n}: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
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
            # on ties also the merge's working sets in global memory
            for ws_size in dict.fromkeys(min(w, p) for w in cfg["k3_ws"] + (
                    cfg["k3_ws_merge"] if ties else ())):
                args = (Xt, r, beta, L, off, gs, type(pen),
                        penalty_params(pen, dev), ws_size)
                sk, gk, ik, wk, xk = ops.fused_ws(*args, use_fp=fp)
                sr, gr, ir, cr = fused_ws_plain(*args, use_fp=fp)
                ok1, e1 = close(sk, sr, 1e-12, 1e-11)
                ok2, e2 = close(gk, gr, 1e-12, 1e-10)
                same_idx = bool(torch.equal(ik, ir))
                same_ws = bool(torch.equal(
                    wk, select_working_set(sr, gs, ws_size)))
                exact = bool(torch.equal(
                    xk, candidate_columns(ir, cr, wk, p).T))
                if ties:
                    same_ws = same_ws and bool(torch.equal(sk, sr))
                errs["fused_ws"] = max(errs["fused_ws"], e1, e2)
                if not (ok1 and ok2 and same_idx and same_ws and exact):
                    fails.append(
                        f"K3 {type(pen).__name__} fp={fp} ws={ws_size} "
                        f"ties={ties} scores={e1:.3e} grad={e2:.3e} "
                        f"cand_idx={same_idx} same_ws={same_ws} "
                        f"exact_rows={exact}")
                del cr, xk
        del Xt
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  K3 checks: {time.perf_counter() - t:.1f} s")
    return errs, fails


def k1_inputs(K, dev, seed):
    """K1 inputs made on the card: the Gram of a 3K x K Gaussian design
    plus a small non-symmetric part (a transposed read of G would show),
    column-major as the engine keeps G; half of beta0 zero."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    X = torch.randn(3 * K, K, **f64)
    G = X.T @ X / (3 * K) + 0.01 * torch.randn(K, K, **f64)
    del X
    G = G.t().contiguous().t()
    beta0 = 0.1 * torch.randn(K, **f64) * (torch.rand(K, **f64) < 0.5)
    c = torch.randn(K, **f64) / 3
    L = torch.clamp(torch.diagonal(G), min=1e-3).contiguous()
    return G, c, beta0, G @ beta0, L


def check_k1_blocked(dev, cfg, errs):
    """K1 at the blocked kernel's edges against its plain version (epochs
    1 and 3 from one plain run of 3 epochs), each launched twice through
    the counted wrapper (on the branch its plan names) and equal bit for
    bit, with G column-major and row-major, every SM's shared memory filled
    with NaN before each launch (a read of a staged tile's unwritten part
    would show); then a block with L = 0 and a level at which nothing moves,
    where the kernel's outputs must keep the frozen values bit for bit.
    Updates `errs`, returns the failures."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              fill_shared_memory_cuda,
                                              gram_plan)
    from repro_torch.kernels.common import penalty_params
    fails = []
    f64 = torch.float64

    def refs_of(args):
        out, st = {}, args[2:4]
        for e in (1, 2):
            st = cd_epoch_gram_plain(args[0], args[1], *st, *args[4:],
                                     epochs=e)
            out[1 if e == 1 else 3] = st
        return out

    def launch(args, epochs):
        if dev.type == "cuda":
            fill_shared_memory_cuda(dev)
        return ops.cd_epoch_gram(*args, epochs=epochs)

    def check(tag, args, refs):
        """The kernel's (beta, q) for each number of epochs in `refs`."""
        outs = {}
        for epochs, ref in refs.items():
            before = ops.branch_counts()["cd_epoch_gram"]
            got = launch(args, epochs)
            again = launch(args, epochs)
            after = ops.branch_counts()["cd_epoch_gram"]
            want = gram_plan(args[0].shape[0], f64).branch
            counted = dev.type != "cuda" or after[want] == before[want] + 2
            outs[epochs] = got
            same = all(torch.equal(a, b) for a, b in zip(got, again))
            ok, err = same and counted, 0.0
            for a, b in zip(got, ref):
                ok_i, e = close(a, b, 1e-12, 1e-5)
                ok, err = ok and ok_i, max(err, e)
            errs["cd_epoch_gram"] = max(errs["cd_epoch_gram"], err)
            if not ok:
                fails.append(f"K1 {tag} epochs={epochs} err={err:.3e} "
                             f"repeat_equal={same} counted={counted}")
        return outs

    for K in cfg["k1_blocked"]:
        t = time.perf_counter()
        G, c, beta0, q0, L = k1_inputs(K, dev, seed=K)
        Grow = G.contiguous()
        # past k1_all_pens_K, the penalties with the most prox branches
        # (the plain epochs there take ~7-15 s a penalty)
        pens = penalties() if K <= cfg["k1_all_pens_K"] else [
            p for p in penalties()
            if type(p).__name__ in cfg["k1_large_pens"]]
        for pen in pens:
            prm = penalty_params(pen, dev)
            args = (G, c, beta0, q0, L, type(pen), prm)
            refs = refs_of(args)
            name = type(pen).__name__
            check(f"K={K} {name} col-major", args, refs)
            check(f"K={K} {name} row-major", (Grow,) + args[1:], refs)
        log(f"  K1 at K={K}: branch {gram_plan(K, f64).branch} "
            f"({time.perf_counter() - t:.1f} s)")
        del G, Grow

    K = cfg["k1_frozen_K"]
    G, c, beta0, _, L = k1_inputs(K, dev, seed=9)
    L = L.clone()
    L[32:64] = 0.0
    for pen, b0 in ((L1(0.11), beta0), (L1(1e6), torch.zeros_like(beta0))):
        args = (G, c, b0, G @ b0, L, L1, penalty_params(pen, dev))
        refs = refs_of(args)
        outs = check(f"K={K} L=0 on rows 32..63, L1({pen.lam})", args, refs)
        # the kernel's outputs, not the plain version's
        kept = all(torch.equal(b[32:64], b0[32:64]) for b, _ in outs.values())
        if pen.lam > 1:
            kept = kept and all(torch.equal(b, b0) and torch.equal(q, args[3])
                                for b, q in outs.values())
        if not kept:
            fails.append(f"K1 K={K} L1({pen.lam}): a frozen coordinate moved")
    del G
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return fails


def check_k2_big_and_k4(dev, cfg, errs):
    """K2 at the sparse fits' n = 50,000 (K = 512 and the deep fit's
    K = 4096), at n = 1000 and past the cluster's shared memory
    (n = 160,003), weighted and not, and K4 against their plain versions;
    updates `errs`, returns the failures."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_plain
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.ws_score import ws_score_plain
    fails = []
    errs.update(ws_score=0.0)

    for K, n in cfg["k2_big"]:
        t = time.perf_counter()
        Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, "logistic", dev,
                                                 seed=9)
        args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.002), dev),
                "logistic")
        for wt in (None, w):
            (bk, _), branch = check_epoch(
                "cd_epoch_xb", f"K2 K={K} n={n} logistic w={wt is not None}",
                args, dict(w=wt, epochs=2), cd_epoch_xb_plain, 1e-11, 1e-8,
                errs, fails)
            log(f"  K2 at K={K}, n={n}, w={wt is not None}: "
                f"{int(torch.sum(bk != beta0))} coordinates moved, branch "
                f"{branch} ({time.perf_counter() - t:.1f} s with the inputs)")
        del Xt, args
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    w = 2.0 * torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    for pen in penalties():
        for fp in (False, True):
            for wt in (None, w):
                args = (Xt, r, beta, L, off, type(pen), penalty_params(pen, dev))
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


def check_step_down(dev, cfg, errs):
    """K1 (K = 1024), K2 (K = 512, n = 10,000, weighted logistic) and K1b
    (K = 1024, T = 20) at each cluster size a plan steps down through
    (1, 2, 4, 8, 16), against their plain versions: K1 and K1b bit for bit
    (each row takes its updates in the same order at every size), K2
    within its bound (its partial sums follow the ranks). Returns the
    failures."""
    import torch
    from repro_torch.core.penalties import L1, BlockL1
    from repro_torch.kernels.cd_epoch import (
        STEP_DOWN, cd_epoch_gram_block_cuda, cd_epoch_gram_cuda,
        cd_epoch_gram_plain, cd_epoch_xb_cuda, cd_epoch_xb_plain,
        gram_block_plan, gram_plan, xb_plan)
    from repro_torch.kernels.common import penalty_params
    f64 = torch.float64
    fails = []
    t = time.perf_counter()
    G, c, beta0, q0, L = gram_inputs(1024, dev, seed=3)
    k1 = (G, c, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
    G, cb, bb, qb, Lb = gram_block_inputs(1024, cfg["k1b_T"], dev, seed=4)
    k1b = (G, cb, bb, qb, Lb, BlockL1, penalty_params(BlockL1(0.11), dev))
    Xt, y, w, b2, xb, L2, off = xb_inputs(cfg["k2_K"], cfg["k2_n"],
                                          "logistic", dev, seed=5)
    k2 = (Xt, y, b2, xb, L2, off, L1, penalty_params(L1(0.002), dev),
          "logistic")
    refs = (cd_epoch_gram_plain(*k1), cd_epoch_gram_plain(*k1b),
            cd_epoch_xb_plain(*k2, w=w))
    for C in STEP_DOWN:
        got = (cd_epoch_gram_cuda(*k1, plan=gram_plan(1024, f64, cluster=C)),
               cd_epoch_gram_block_cuda(*k1b, plan=gram_block_plan(
                   1024, cfg["k1b_T"], f64, cluster=C)),
               cd_epoch_xb_cuda(*k2, w=w, plan=xb_plan(cfg["k2_n"], True, f64,
                                                       cluster=C)))
        for name, (bk, sk), (br, sr) in zip(
                ("cd_epoch_gram", "cd_epoch_gram_block", "cd_epoch_xb"),
                got, refs):
            if name == "cd_epoch_xb":
                ok1, e1 = close(bk, br, 1e-11, 1e-8)
                ok2, e2 = close(sk, sr, 1e-11, 1e-8)
                ok = ok1 and ok2
            else:
                ok = bool(torch.equal(bk, br) and torch.equal(sk, sr))
                e1, e2 = close(bk, br, 0, 0)[1], close(sk, sr, 0, 0)[1]
            errs[name] = max(errs.get(name, 0.0), e1, e2)
            if not ok:
                fails.append(f"{name} at C={C}: err {max(e1, e2):.3e}"
                             f"{'' if name == 'cd_epoch_xb' else ' (not bit for bit)'}")
    log(f"  K1 / K1b / K2 at C = {STEP_DOWN} against plain "
        f"({time.perf_counter() - t:.1f} s): {len(fails)} failures")
    return fails


def check_k5(dev, designs, errs):
    """K5 and K5s against their plain versions (and K5 against the ELL
    reference), twice each to check that the kernel is deterministic, every
    SM's shared memory NaN-filled before the first launch, and on the small
    design bit for bit against the emulation of the kernel's order;
    updates `errs`, returns the failures."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import fill_shared_memory_cuda
    from repro_torch.kernels.csc_score import csc_score_plain, emulate
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
            if dev.type == "cuda":
                fill_shared_memory_cuda(dev)
            k = fn(*args, v)
            ok, e = close(k, csc_score_plain(*args, v, square=square),
                          1e-12, 1e-12)
            same = bool(torch.equal(k, fn(*args, v)))
            if label == "small":
                same = same and bool(torch.equal(k, emulate(
                    d.data, d.indices, d.indptr, v, square=square)))
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
def all_counts():
    """The launch counts of every kernel, and those of K1, K2 and K1b by
    branch under "<kernel>/<branch>"."""
    from repro_torch.kernels import ops
    counts = ops.launch_counts()
    for k, per in ops.branch_counts().items():
        counts.update({f"{k}/{b}": v for b, v in per.items()})
    return counts


def cluster_launches(counts, kernel):
    return counts[f"{kernel}/cluster-shared"] + \
        counts[f"{kernel}/cluster-global"]


def _fit(make, design, y, dev, kernels, sample_weight=None, capture=True):
    import torch
    from repro_torch.core import make_engine
    from repro_torch.kernels import ops
    # the kernel route is the estimators' default on the card; without
    # `capture`, the kernel route's eager oracle (the inner loop on the host)
    est = make(tol=TOL) if kernels else make(use_kernels=False, tol=TOL)
    if not capture:
        est = make(tol=TOL, engine=make_engine(est.penalty, est.datafit,
                                               device=dev, capture=False))
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    est.fit(design, y, sample_weight=sample_weight, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = all_counts()
    res = est.result_
    peak, reserved = (torch.cuda.max_memory_allocated() / 2**30,
                      torch.cuda.memory_reserved() / 2**30) \
        if dev.type == "cuda" else (float("nan"), float("nan"))
    route = ("kernels" if capture else "oracle ") if kernels else "plain  "
    log(f"  {route}: wall {wall:.3f} s, "
        f"converged {res.converged}, kkt {res.kkt:.3e}, outer "
        f"{res.n_outer}, epochs {res.n_epochs}, ws {res.ws_history}, "
        f"host syncs "
        f"{res.n_host_syncs} ({res.n_host_syncs / max(1, len(res.kkt_history)):.1f} "
        f"per outer), peak mem {peak:.3f} GiB (reserved {reserved:.3f}), "
        f"launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return est, counts


def fit_both(label, make, design, y, dev, total, fails, needs, *,
             sample_weight=None, exact=None, per_head=None, per_epoch=None,
             min_ws=None, cluster=None, oracle=False):
    """One fit on the kernel route and on the plain route. Fails unless
    both converge, the kernel route read the host once per outer step
    (``n_host_syncs == len(kkt_history)``, the reference's contract), the
    coefficients agree to TOL, each kernel in `needs` launched, each in
    `exact` launched exactly that often, `per_head` launched at least once
    per outer head, `per_epoch` launched once per inner epoch, (with
    `min_ws`) the working set reached `min_ws`, and (with `cluster`) that
    kernel launched on a cluster branch. With `oracle`, the kernel route
    runs a third time with its inner loop on the host (``capture=False``)
    and its beta must equal the captured fit's bit for bit, with the same
    epochs. Adds the kernel route's launch counts to `total`."""
    import numpy as np
    import torch
    log(f"fit {label}")
    ek, counts = _fit(make, design, y, dev, True, sample_weight)
    ep, _ = _fit(make, design, y, dev, False, sample_weight)
    same = True
    if oracle:
        eo, _ = _fit(make, design, y, dev, True, sample_weight,
                     capture=False)
        same = (torch.equal(ek.result_.beta, eo.result_.beta)
                and ek.result_.n_epochs == eo.result_.n_epochs)
        log(f"  captured step == eager oracle bit for bit: {same}")
    one_read = ek.result_.n_host_syncs == len(ek.result_.kkt_history)
    for k in total:
        total[k] += counts[k]
    heads = len(ek.result_.kkt_history)
    diff = float(np.max(np.abs(ek.coef_ - ep.coef_)))
    ws_max = max(ek.result_.ws_history, default=0)
    ok = (ek.converged_ and ep.converged_ and diff <= TOL and same
          and one_read
          and np.all(np.isfinite(ek.coef_))
          and all(counts[k] > 0 for k in needs)
          and all(counts[k] == v for k, v in (exact or {}).items())
          and (per_head is None or counts[per_head] >= heads)
          and (per_epoch is None
               or counts[per_epoch] == ek.result_.n_epochs)
          and (min_ws is None or ws_max >= min_ws)
          and (cluster is None or cluster_launches(counts, cluster) > 0))
    log(f"  max |coef kernels - coef plain| = {diff:.3e}, "
        f"nnz {int(np.sum(ek.coef_ != 0))}, outer heads {heads}, ok {ok}")
    if not ok:
        fails.append(f"{label}: converged {ek.converged_}/"
                     f"{ep.converged_}, diff {diff:.3e}, heads {heads}, "
                     f"one read a step {one_read}, equal to the oracle "
                     f"{same}, "
                     f"max ws {ws_max}, launches "
                     f"{ {k: v for k, v in counts.items() if v} }")
    return ek


def fit_refused(label, make, design, y, dev, ref, kernel, fails,
                sample_weight=None):
    """The kernel-route fit `ref` again under a placement test that refuses
    16 CTAs: its plans must step down to 8 (``ops.cluster_counts``: no
    16-CTA launch of `kernel`, some 8-CTA ones), and the fit must equal
    `ref` bit for bit (K1, K1b: each row takes its updates in the same
    order at every cluster size) or within TOL (K2: its partial sums
    follow the ranks)."""
    import numpy as np
    from repro_torch.kernels import cd_epoch, ops
    log(f"fit {label}, 16 CTAs refused")
    with cd_epoch.placement(lambda k, plan, dt: plan.cluster <= 8):
        est, _ = _fit(make, design, y, dev, True, sample_weight)
    sizes = ops.cluster_counts()[kernel]
    if kernel == "cd_epoch_xb":
        same = float(np.max(np.abs(est.coef_ - ref.coef_))) <= TOL
    else:
        same = bool(np.array_equal(est.coef_, ref.coef_))
    ok = (est.converged_ and same and sizes.get(8, 0) > 0
          and 16 not in sizes)
    log(f"  {kernel} launches by cluster size {sizes}; equal to the "
        f"16-CTA fit ({'within TOL' if kernel == 'cd_epoch_xb' else 'bit for bit'}): "
        f"{same}, ok {ok}")
    if not ok:
        fails.append(f"{label} with 16 CTAs refused: converged "
                     f"{est.converged_}, equal {same}, sizes {sizes}")


def main_path(dev, cfg):
    """The four dense fits; returns (launch counts summed over the
    kernel-route fits, failures)."""
    import torch
    from repro_torch.core import (Lasso, LinearSVC, Logistic, MCPRegression,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.core.api import lasso_gap
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_classification, make_correlated_design
    total = dict.fromkeys(all_counts(), 0)
    fails = []

    def run(label, make, design, y, needs, **kw):
        return fit_both(label, make, design, y, dev, total, fails, needs,
                        **kw)

    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    lmax = lambda_max(design, y, device=dev)
    est = run("Lasso(lmax/20)", lambda **k: Lasso(alpha=lmax / 20, **k),
              design, y, ("fused_ws", "cd_epoch_gram"),
              per_epoch="cd_epoch_gram", oracle=True)
    gap, primal = lasso_gap(design.X, y, est.coef_, lmax / 20, device=dev)
    log(f"  Lasso duality gap {gap:.3e} (primal {primal:.6f})")
    run("MCPRegression(lmax/10, gamma=3)",
        lambda **k: MCPRegression(alpha=lmax / 10, gamma=3.0, **k),
        design, y, ("fused_ws", "cd_epoch_gram"), per_epoch="cd_epoch_gram",
        oracle=True)
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
        design, y, ("fused_ws", "cd_epoch_xb"), oracle=True)
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    X, y, _ = make_classification(n=cfg["svc_n"], p=cfg["svc_p"],
                                  n_nonzero=cfg["svc_nnz"], seed=0)
    make = lambda **k: LinearSVC(C=1.0, max_outer=100, **k)  # noqa: E731
    est = run("LinearSVC(C=1)", make, X, y, ("fused_ws", "cd_epoch_gram"),
              per_epoch="cd_epoch_gram", oracle=True)
    fit_refused("LinearSVC(C=1)", make, X, y, dev, est, "cd_epoch_gram",
                fails)
    return total, fails


def large_design(dev, cfg):
    """The kernel route of ``solve(X, y, Quadratic(), L1(lambda_max/10))``
    at tol 1e-6 on a dense design that takes at least 55% of the card's
    memory (n = 10,000, p a multiple of 1000 from ``mem_get_info``): Xt
    [p, n] and y = X beta* + noise (150 nonzeros, SNR 5) made on the card
    from a CUDA generator in chunks, passed as a ``DenseDesign``; no plain
    route, no numpy copy. Checked without an oracle: a plain-torch pass
    over X in chunks recomputes the final gradient and the L1
    subdifferential distance, whose max must be <= tol and agree with the
    solver's reported kkt to 1e-9 relative to max(kkt, lambda) and to
    1e-12 lambda absolute; the peak of allocated memory during the solve, less X's bytes, must stay <= 10% of X's bytes (no
    X-sized temporary on the kernel route). Returns (launch counts,
    failures)."""
    import torch
    from repro_torch.core import L1, Quadratic, lambda_max, solve
    from repro_torch.core.engine import DenseDesign
    from repro_torch.kernels import ops
    c = cfg["large"]
    n, f64 = c["n"], torch.float64
    fails = []
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        free, total = torch.cuda.mem_get_info(dev)
    else:
        free = total = c["cpu_bytes"]
    p = -(-int(c["frac"] * total) // (8 * n * 1000)) * 1000
    x_bytes = p * n * 8
    log(f"large dense design: n={n}, p={p}, X {x_bytes / 1e9:.3f} GB = "
        f"{x_bytes / total:.1%} of the card's {total / 1e9:.3f} GB "
        f"({free / 1e9:.3f} GB free)")
    if x_bytes > free - c["headroom"]:
        return {}, [f"large design: X {x_bytes} B does not fit beside "
                    f"{c['headroom']} B of headroom in {free} B free"]
    t = time.perf_counter()
    g = torch.Generator(device=dev).manual_seed(c["seed"])
    Xt = torch.empty((p, n), dtype=f64, device=dev)
    rows = max(1, 2**28 // (8 * n))
    for j in range(0, p, rows):
        Xt[j:j + rows].normal_(generator=g)
    supp = torch.randperm(p, generator=g, device=dev)[:c["n_nonzero"]]
    bstar = torch.randn(c["n_nonzero"], generator=g, device=dev, dtype=f64)
    signal = bstar @ Xt[supp]
    noise = torch.randn(n, generator=g, device=dev, dtype=f64)
    y = signal + noise * (torch.linalg.norm(signal)
                          / (c["snr"] * torch.linalg.norm(noise)))
    design = DenseDesign(Xt)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    log(f"  built on the card in {time.perf_counter() - t:.2f} s")
    lmax = lambda_max(design, y, device=dev)
    lam = lmax / c["frac_lambda"]
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = solve(design, y, Quadratic(), L1(lam), tol=TOL, device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = all_counts()
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" \
        else x_bytes
    reserved = torch.cuda.memory_reserved(dev) if dev.type == "cuda" else 0
    # the KKT violation in plain torch, over X in chunks
    beta = res.beta
    r = (Xt.T @ beta - y) / n
    kkt = torch.zeros((), dtype=f64, device=dev)
    for j in range(0, p, rows):
        gj = Xt[j:j + rows] @ r
        bj = beta[j:j + rows]
        dist = torch.where(bj == 0, torch.clamp(torch.abs(gj) - lam, min=0),
                           torch.abs(gj + lam * torch.sign(bj)))
        kkt = torch.maximum(kkt, torch.max(dist))
    kkt = float(kkt)
    # both are the max of distances computed from gradients of size ~lam:
    # their difference is rounding (summation order, the solver's
    # incrementally kept Xb), a few 1e-17, so it is taken relative to
    # max(kkt, lam), and held to 1e-12 lam absolute (the rounding scale of
    # such gradients), so a solver that reported a wrong kkt below tol
    # would still fail; relative to a kkt far below tol it is printed too
    diff = abs(kkt - res.kkt)
    rel = diff / max(res.kkt, lam)
    over = (peak - x_bytes) / x_bytes
    log(f"  fit: {wall:.3f} s, converged {res.converged}, outer steps "
        f"{len(res.kkt_history)}, ws {res.ws_history}, host reads "
        f"{res.n_host_syncs}, nnz {int(torch.sum(beta != 0))}, X bytes "
        f"{x_bytes}, max_memory_allocated {peak} B ({over:.2%} of X above "
        f"X), memory_reserved {reserved} B, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    log(f"  plain recomputed kkt {kkt:.6e}, solver kkt {res.kkt:.6e}, "
        f"difference {diff:.3e} ({diff / lam:.3e} of lam): relative to "
        f"max(kkt, lam = {lam:.6e}) {rel:.3e}, to kkt "
        f"{diff / max(res.kkt, 1e-300):.3e}")
    ok = (res.converged and kkt <= TOL and rel <= 1e-9
          and diff <= 1e-12 * lam
          and res.n_host_syncs == len(res.kkt_history)
          and counts["fused_ws"] >= len(res.kkt_history)
          and counts["cd_epoch_gram"] == res.n_epochs
          and over <= 0.10 and dev.type == "cuda")
    if not ok:
        fails.append(f"large design p={p}: converged {res.converged}, "
                     f"kkt {kkt:.3e} (solver {res.kkt:.3e}, rel {rel:.2e}), "
                     f"peak above X {over:.2%}, launches {counts}")
    del design, Xt
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return counts, fails


def sparse_designs(dev, cfg):
    """The full-size sparse problem (its scipy X and ground truth on the
    host, a CSC design of it with the ELL flag on `dev`, and its target) and
    a small design with empty columns and columns at the window cap."""
    import numpy as np
    import torch
    from repro_torch.data import make_sparse_design
    from repro_torch.sparse import CSCDesign
    t = time.perf_counter()
    X, y, beta_true = make_sparse_design(**cfg["sparse"])
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
    return X, beta_true, d, y, small


def sparse_path(dev, cfg, d, y):
    """The sparse fits: Lasso and weighted logistic on the full-size design
    at two depths each, and LinearSVC on a scipy sparse X; returns (launch
    counts summed over the kernel-route fits, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (Lasso, LinearSVC, Logistic,
                                  SparseLogisticRegression, lambda_max)
    from repro_torch.data import make_sparse_design
    total = dict.fromkeys(all_counts(), 0)
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
        make_log = lambda **k: SparseLogisticRegression(  # noqa: E731
            alpha=lmax_log / k_log, **k)
        fit_both(f"sparse Lasso(lmax/{k_lasso})",
                 lambda **k: Lasso(alpha=lmax / k_lasso, **k),
                 d, y, dev, total, fails, ("csc_score", "cd_epoch_gram"),
                 exact={"fused_ws": 0, "csc_weighted_col_sq": 0},
                 per_head="csc_score", per_epoch="cd_epoch_gram")
        label = f"sparse SparseLogisticRegression(lmax/{k_log}, weighted)"
        est = fit_both(label, make_log, d, ys, dev, total, fails,
                       ("csc_score", "cd_epoch_xb"), sample_weight=w,
                       exact={"fused_ws": 0, "csc_weighted_col_sq": 1},
                       per_head="csc_score", cluster="cd_epoch_xb",
                       oracle=k_log == cfg["sparse_lam"][-1][1])
        if k_log == cfg["sparse_lam"][0][1]:
            fit_refused(label, make_log, d, ys, dev, est, "cd_epoch_xb",
                        fails, sample_weight=w)
    Xs, ysvc, _ = make_sparse_design(**cfg["sparse_small"])
    fit_both(f"sparse LinearSVC(C=1) on scipy X {Xs.shape}",
             lambda **k: LinearSVC(C=1.0, max_outer=100, **k), Xs,
             np.sign(ysvc), dev, total, fails,
             ("csc_score", "cd_epoch_gram"),
             exact={"fused_ws": 0, "csc_weighted_col_sq": 0},
             per_head="csc_score", per_epoch="cd_epoch_gram")
    return total, fails


# ------------------------------------------------------ multitask (blocks)
def block_pens():
    from repro_torch.core.penalties import BlockL1, BlockMCP
    return [BlockL1(0.11), BlockMCP(0.11, 3.0)]


def block_inputs(n, p, T, dev, seed):
    """Xt [p, n], R [n, T] (scaled like a raw gradient), beta [p, T] with
    30% of its rows nonzero at norms on both sides of gamma * lam, L, and
    a small offset."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    Xt = torch.randn(p, n, **f64)
    R = torch.randn(n, T, **f64) / n ** 0.5
    beta = torch.randn(p, T, **f64) * (torch.rand(p, 1, **f64) < 0.3) * \
        (0.2 * torch.rand(p, 1, **f64))
    L = torch.sum(Xt * Xt, dim=1) / n
    return Xt, R, beta, L, 0.01 * torch.randn(p, **f64)


def gram_block_inputs(K, T, dev, seed):
    import torch
    g = torch.Generator(device="cpu").manual_seed(seed)
    n = 3 * K
    X = torch.randn(n, K, generator=g, dtype=torch.float64).to(dev)
    Y = torch.randn(n, T, generator=g, dtype=torch.float64).to(dev)
    G = (X.T @ X / n).t().contiguous().t()      # column-major, as the engine
    mask = (torch.rand(K, 1, generator=g, dtype=torch.float64) < 0.5)
    beta0 = (0.1 * torch.randn(K, T, generator=g, dtype=torch.float64)
             * mask).to(dev)
    return G, X.T @ Y / n, beta0, G @ beta0, torch.diagonal(G).contiguous()


def check_block_kernels(dev, cfg, errs, designs):
    """K3b, K1b and K5b against their plain versions; updates `errs`,
    returns the failures."""
    import torch
    from repro_torch.core.working_set import (candidate_columns,
                                              select_working_set)
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              fill_shared_memory_cuda)
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.csc_score import csc_score_plain, emulate
    from repro_torch.kernels.fused_ws import fused_ws_plain
    fails = []
    for name in ("fused_ws_block", "cd_epoch_gram_block", "csc_score_block"):
        errs.setdefault(name, 0.0)

    c, w = cfg["k3b"], cfg["k3b_wide"]
    # the smoke shape, an odd n (8-byte copies) and a ragged last feature
    # tile, and the leadfield's T = 50 (the wide product); shared memory
    # NaN-filled before each launch
    for n, p, T, ws in ((c["n"], c["p"], c["T"], c["ws"]),
                        (c["n"] + 1, c["p"] // 4 - 37, c["T"], c["ws"]),
                        (w["n"], w["p"], w["T"], w["ws"])):
        Xt, R, beta, L, off = block_inputs(n, p, T, dev, seed=13)
        for pen in block_pens():
            gs = pen.generalized_support(beta)
            for fp in (False, True):
                args = (Xt, R, beta, L, off, gs, type(pen),
                        penalty_params(pen, dev), ws)
                if dev.type == "cuda":
                    fill_shared_memory_cuda(dev)
                sk, gk, ik, wk, xk = ops.fused_ws_block(*args, use_fp=fp)
                sr, gr, ir, cr = fused_ws_plain(*args, use_fp=fp)
                ok1, e1 = close(sk, sr, 1e-12, 1e-12)
                ok2, e2 = close(gk, gr, 1e-12, 1e-10)
                same_idx = bool(torch.equal(ik, ir))
                same_ws = bool(torch.equal(
                    wk, select_working_set(sr, gs, ws)))
                exact = bool(torch.equal(
                    xk, candidate_columns(ir, cr, wk, p).T))
                errs["fused_ws_block"] = max(errs["fused_ws_block"], e1, e2)
                if not (ok1 and ok2 and same_idx and same_ws and exact):
                    fails.append(f"K3b n={n} p={p} T={T} {type(pen).__name__} "
                                 f"fp={fp} scores={e1:.3e} grad={e2:.3e} "
                                 f"cand_idx={same_idx} same_ws={same_ws} "
                                 f"exact_rows={exact}")
                del cr
        del Xt
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    for K, T in cfg["k1b_shapes"]:
        t = time.perf_counter()
        G, cc, beta0, q0, L = gram_block_inputs(K, T, dev, seed=K)
        for pen in block_pens():
            for epochs in (1, 3):
                args = (G, cc, beta0, q0, L, type(pen), penalty_params(pen, dev))
                tag = f"K1b K={K} T={T} {type(pen).__name__} epochs={epochs}"
                (bk, _), branch = check_epoch(
                    "cd_epoch_gram_block", tag, args, dict(epochs=epochs),
                    cd_epoch_gram_plain, 1e-12, 1e-5, errs, fails)
                moved = int(torch.sum(torch.any(bk != beta0, dim=1)))
                if moved == 0:
                    fails.append(f"{tag} moved no row")
        log(f"  K1b at K={K}, T={T}: branch {branch} "
            f"({time.perf_counter() - t:.1f} s)")
        del G

    for label, d in designs:
        g = torch.Generator(device=dev).manual_seed(17)
        raw = torch.randn(d.n_rows, cfg["k5b_T"], generator=g, device=dev,
                          dtype=torch.float64)
        args = (d.data, d.indices, d.col_ids, d.indptr)
        if dev.type == "cuda":
            fill_shared_memory_cuda(dev)
        k = ops.csc_score_block(*args, raw)
        ok, e = close(k, csc_score_plain(*args, raw), 1e-12, 1e-12)
        same = bool(torch.equal(k, ops.csc_score_block(*args, raw)))
        if label == "small":
            same = same and bool(torch.equal(k, emulate(
                d.data, d.indices, d.indptr, raw)))
        errs["csc_score_block"] = max(errs["csc_score_block"], e)
        if not (ok and same):
            fails.append(f"K5b {label} err={e:.3e} deterministic={same}")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return fails


def sparse_mt_target(X_sparse, beta_true, T):
    """The full-size sparse design's multitask target: T tasks on the
    generator's true columns, Y = X W + noise at SNR 5 (seeded)."""
    import numpy as np
    rng = np.random.default_rng(0)
    supp = np.flatnonzero(beta_true)
    W = np.zeros((X_sparse.shape[1], T))
    W[supp] = rng.standard_normal((len(supp), T))
    signal = np.asarray(X_sparse @ W)
    noise = rng.standard_normal(signal.shape)
    noise *= np.linalg.norm(signal) / (5.0 * np.linalg.norm(noise))
    return signal + noise


def multitask_path(dev, cfg, X_sparse, Y_sparse):
    """The multitask fits (M/EEG leadfield, dense, sparse: `Y_sparse` the
    target of the scipy design `X_sparse`); returns (launch counts summed
    over the kernel-route fits, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (MultiTaskLasso, MultiTaskMCP,
                                  MultitaskQuadratic, lambda_max)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_leadfield, make_multitask
    total = dict.fromkeys(all_counts(), 0)
    fails = []
    scalar0 = {"cd_epoch_gram": 0, "cd_epoch_xb": 0, "fused_ws": 0,
               "csc_score": 0}

    def dense_fit(label, make, X, Y, **kw):
        return fit_both(label, make, X, Y, dev, total, fails,
                        ("fused_ws_block", "cd_epoch_gram_block"),
                        exact=dict(scalar0, csc_score_block=0,
                                   csc_weighted_col_sq=0),
                        per_head="fused_ws_block",
                        per_epoch="cd_epoch_gram_block", **kw)

    # the M/EEG inverse problem at the width of a MEG forward model
    m = cfg["meeg"]
    X, Y, _, true_rows = make_leadfield(**m)
    p_hemi = m["p_per_hemi"]
    frac = cfg["meeg_frac"]
    lmax = lambda_max(X, Y, MultitaskQuadratic(), device=dev)
    log(f"M/EEG leadfield {m}: X {X.shape}, true source rows {true_rows}, "
        f"lambda_max {lmax:.6f}")
    for name, make in (
            ("MultiTaskLasso", lambda **k: MultiTaskLasso(alpha=lmax / frac,
                                                          **k)),
            ("MultiTaskMCP(gamma=3)",
             lambda **k: MultiTaskMCP(alpha=lmax / frac, gamma=3.0, **k))):
        est = dense_fit(f"M/EEG {name}(lmax/{frac})", make, X, Y)
        act = np.flatnonzero(np.linalg.norm(est.coef_, axis=1))
        log(f"  sources found: {act.tolist()[:12]}"
            f"{' ...' if len(act) > 12 else ''} ({len(act)}); one per "
            f"hemisphere: {bool(np.any(act < p_hemi))}/"
            f"{bool(np.any(act >= p_hemi))}; exactly the two true rows: "
            f"{sorted(act.tolist()) == sorted(true_rows)}")
    # the Xb form: the plain block epoch runs on both routes (no kernel)
    est = fit_both(f"M/EEG MultiTaskLasso(lmax/{frac}, use_gram=False)",
                   lambda **k: MultiTaskLasso(alpha=lmax / frac,
                                              use_gram=False, **k),
                   X, Y, dev, total, fails, ("fused_ws_block",),
                   exact=dict(scalar0, csc_score_block=0,
                              cd_epoch_gram_block=0, csc_weighted_col_sq=0),
                   per_head="fused_ws_block")
    log(f"  plain block Xb epochs on the kernel route: "
        f"{est.result_.n_epochs} (not a kernel; counted in no launch)")

    # a dense fit that loads the head and K1b at K >= 512
    t = time.perf_counter()
    X, Y, _ = make_multitask(**cfg["mt_dense"])
    design = DenseDesign.from_dense(X, dev)
    del X
    frac = cfg["mt_dense_frac"]
    lmax = lambda_max(design, Y, MultitaskQuadratic(), device=dev)
    log(f"dense multitask {cfg['mt_dense']}: built in "
        f"{time.perf_counter() - t:.1f} s, lambda_max {lmax:.6f}")
    make = lambda **k: MultiTaskLasso(alpha=lmax / frac, **k)  # noqa: E731
    est = dense_fit(f"dense MultiTaskLasso(lmax/{frac})", make, design, Y,
                    min_ws=cfg["mt_dense_min_ws"], oracle=True)
    fit_refused(f"dense MultiTaskLasso(lmax/{frac})", make, design, Y, dev,
                est, "cd_epoch_gram_block", fails)
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # the full-size sparse design, T tasks on the generator's true columns
    T, Y = cfg["mt_sparse_T"], Y_sparse
    frac = cfg["mt_sparse_frac"]
    w = np.random.default_rng(1).uniform(0.5, 1.5, X_sparse.shape[0])
    for sw in (None, w):
        lmax = lambda_max(X_sparse, Y, MultitaskQuadratic(), sample_weight=sw,
                          device=dev)
        fit_both(f"sparse MultiTaskLasso(lmax/{frac}, T={T}"
                 f"{', weighted' if sw is not None else ''}) on scipy X",
                 lambda **k: MultiTaskLasso(alpha=lmax / frac, **k),
                 X_sparse, Y, dev, total, fails,
                 ("csc_score_block", "cd_epoch_gram_block"),
                 sample_weight=sw,
                 exact=dict(scalar0, fused_ws_block=0,
                            csc_weighted_col_sq=0 if sw is None else 1),
                 per_head="csc_score_block", per_epoch="cd_epoch_gram_block",
                 min_ws=cfg["mt_sparse_min_ws"], cluster="cd_epoch_gram_block")
    return total, fails


# -------------------------------------------------------------------- paths
def run_path(label, call, dev, total=None):
    """Run one regularization path (``call()`` -> PathResult) with the
    launch counts reset just before and read just after (added to `total`
    when given), and print its wall time, outer steps, epochs, host reads,
    captures and their seconds, and peak allocated / reserved memory."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    res = call()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = all_counts()
    if total is not None:
        for k in total:
            total[k] += counts[k]
        for k, per in ops.shape_counts().items():
            mine = SHAPES.setdefault(k, {})
            for shape, n in per.items():
                mine[shape] = mine.get(shape, 0) + n
    peak, reserved = (torch.cuda.max_memory_allocated() / 2**30,
                      torch.cuda.max_memory_reserved() / 2**30) \
        if dev.type == "cuda" else (float("nan"), float("nan"))
    cap = res.diagnostics["capture_s"]
    log(f"  {label}: wall {wall:.3f} s, {len(res.lambdas)} lambdas, "
        f"converged {int(np.sum(res.kkts <= TOL))}, outer steps "
        f"{int(np.sum(res.n_outer))}, epochs {int(np.sum(res.n_epochs))}, "
        f"host reads {res.n_host_syncs}, captures {len(cap)} "
        f"({float(np.sum(cap)):.3f} s), keys {len(res.captures)}, peak "
        f"mem {peak:.3f} GiB (reserved {reserved:.3f}), launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return res, wall


def path_keys_once(label, res, fails, ladder=None):
    """Each captured step key of `res` captured once; with `ladder`, only
    buckets of it and no more keys than its rungs."""
    counts = set(res.captures.values())
    buckets = {key[0] for key in res.captures}
    ok = counts <= {1} and (ladder is None or (
        buckets <= set(ladder) and len(res.captures) <= len(ladder)))
    log(f"  {label}: {len(res.captures)} keys, captured "
        f"{sorted(counts)} time(s) each, buckets {sorted(buckets)}"
        + (f" (ladder {ladder})" if ladder is not None else "")
        + f": ok {ok}")
    if not ok:
        fails.append(f"{label}: captures {res.captures}")


def path_phase(dev, cfg, sparse_design, sparse_y):
    """The regularization paths: (a) a dense Lasso path on ``cv_fig``,
    (b) Figure 1 at its paper size, (c) a gap-safe screened Lasso path on
    ``sparse_fig2``, (d) a MultiTaskLasso path on the M/EEG leadfield;
    returns (launch counts summed over the kernel-route paths, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (L1, L1L2, MCP, SCAD, BlockL1,
                                  BucketPolicy, MultitaskQuadratic,
                                  Quadratic, make_engine, reg_path,
                                  support_metrics)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_correlated_design, make_leadfield
    total = dict.fromkeys(all_counts(), 0)
    fails = []

    def engine(penalty, datafit=None, **kw):
        return make_engine(penalty, datafit or Quadratic(), device=dev,
                           **kw)

    def converged(label, res, tol):
        ok = bool(np.all(res.kkts <= tol))
        if not ok:
            fails.append(f"{label}: lambdas not converged at {tol}: "
                         f"{res.kkts.tolist()}")
        return ok

    def same(label, a, b, what="capture=False"):
        ok = bool(np.array_equal(a.betas, b.betas)
                  and np.array_equal(a.n_epochs, b.n_epochs)
                  and np.array_equal(a.n_outer, b.n_outer))
        log(f"  {label}: kernel route == {what} bit for bit: {ok}")
        if not ok:
            fails.append(f"{label}: captured path differs from {what}: max "
                         f"{float(np.max(np.abs(a.betas - b.betas))):.3e}")

    def within(label, a, b, bound):
        diff = float(np.max(np.abs(a - b)))
        log(f"  {label}: max |diff| {diff:.3e} (bound {bound:g})")
        if not diff <= bound:
            fails.append(f"{label}: max |diff| {diff:.3e} > {bound:g}")

    # (a) the cv_fig Lasso path: 30 lambdas, lambda_max -> lambda_max/100
    a = cfg["path_a"]
    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    log(f"path (a): dense Lasso on cv_fig ({cfg['reg_n']} x {cfg['reg_p']}),"
        f" {a['n_lambdas']} lambdas to lambda_max/{round(1 / a['ratio'])}, "
        f"tol {a['tol']}")
    kw = dict(n_lambdas=a["n_lambdas"], lambda_min_ratio=a["ratio"],
              tol=a["tol"])
    eng = engine(L1(1.0))
    ka, _ = run_path("kernels", lambda: reg_path(
        design, y, L1(1.0), engine=eng, device=dev, **kw), dev, total)
    eng.release_graphs()
    converged("path (a)", ka, a["tol"])
    path_keys_once("path (a)", ka, fails, BucketPolicy(p0=64).ladder(
        cfg["reg_p"]))
    oa, _ = run_path("oracle ", lambda: reg_path(
        design, y, L1(1.0), engine=engine(L1(1.0), capture=False),
        device=dev, **kw), dev)
    same("path (a)", ka, oa)
    pa, _ = run_path("plain  ", lambda: reg_path(
        design, y, L1(1.0), lambdas=ka.lambdas[:a["plain_lambdas"]],
        tol=a["tol"], device=dev, use_kernels=False), dev)
    converged("path (a) plain", pa, a["tol"])
    within(f"path (a) plain route, first {a['plain_lambdas']} lambdas",
           pa.betas, ka.betas[:a["plain_lambdas"]], TOL)
    del design

    # (b) Figure 1 at its paper size, both routes
    b = cfg["fig1"]
    X, y, beta_true = make_correlated_design(
        n=b["n"], p=b["p"], n_nonzero=b["n_nonzero"], rho=0.6, snr=5.0,
        seed=0)
    X_te, y_te, _ = make_correlated_design(
        n=b["n"], p=b["p"], n_nonzero=b["n_nonzero"], rho=0.6, snr=5.0,
        seed=1)
    log(f"path (b): Figure 1 at paper size {b}, {b['n_lambdas']} lambdas to "
        f"lambda_max/100, tol {b['tol']}")

    def mfn(lam, beta):
        return support_metrics(beta, beta_true, X_te, y_te)

    for name, pen in (("L1", L1(1.0)), ("L1L2(rho=0.5)", L1L2(1.0, 0.5)),
                      ("MCP(gamma=3)", MCP(1.0, 3.0)),
                      ("SCAD(gamma=3.7)", SCAD(1.0, 3.7))):
        kw = dict(n_lambdas=b["n_lambdas"], lambda_min_ratio=0.01,
                  tol=b["tol"], metric_fn=mfn, device=dev)
        kb, _ = run_path(f"{name} kernels", lambda: reg_path(
            X, y, pen, **kw), dev, total)
        ob, _ = run_path(f"{name} oracle ", lambda: reg_path(
            X, y, pen, engine=engine(pen, capture=False), **kw), dev)
        path_keys_once(f"path (b) {name}", kb, fails)
        same(f"path (b) {name}", kb, ob)
        # the plain route's Python epochs take 4-5 min a penalty for the
        # whole grid on an H100: its first plain_lambdas lambdas
        k = b["plain_lambdas"]
        pb, _ = run_path(f"{name} plain  ", lambda: reg_path(
            X, y, pen, lambdas=kb.lambdas[:k], tol=b["tol"], device=dev,
            use_kernels=False), dev)
        converged(f"path (b) {name}", kb, b["tol"])
        converged(f"path (b) {name} plain", pb, b["tol"])
        within(f"path (b) {name} kernel vs plain route, first {k} lambdas",
               kb.betas[:k], pb.betas, TOL)
        f1 = [m["f1"] for m in kb.metrics]
        log(f"  {name}: best F1 {max(f1):.4f} at lambda index "
            f"{int(np.argmax(f1))}, exact support anywhere "
            f"{any(m['exact_support'] for m in kb.metrics)}, best est err "
            f"{min(m['est_err'] for m in kb.metrics):.4f}")

    # (c) the gap-safe screened Lasso path on the full sparse_fig2 design
    c = cfg["screen"]
    log(f"path (c): gap-safe screened Lasso on sparse_fig2, "
        f"{c['n_lambdas']} and {c['fine_lambdas']} lambdas to "
        f"lambda_max/{round(1 / c['ratio'])}, "
        f"tol {c['tol']}")
    for n_lam in (c["n_lambdas"], c["fine_lambdas"]):
        tag = f"path (c) {n_lam} lambdas"
        kw = dict(n_lambdas=n_lam, lambda_min_ratio=c["ratio"], tol=c["tol"],
                  device=dev)
        uc, _ = run_path(f"unscreened, {n_lam} lambdas", lambda: reg_path(
            sparse_design, sparse_y, L1(1.0), **kw), dev, total)
        sc, _ = run_path(f"screened,   {n_lam} lambdas", lambda: reg_path(
            sparse_design, sparse_y, L1(1.0), screen="gap_safe", **kw), dev,
            total)
        converged(f"{tag} unscreened", uc, c["tol"])
        converged(f"{tag} screened", sc, c["tol"])
        within(f"{tag} screened vs unscreened", sc.betas, uc.betas, 1e-7)
        path_keys_once(f"{tag} unscreened", uc, fails)
        path_keys_once(f"{tag} screened", sc, fails)
        slots = {(key[0], key[1]) for key in sc.captures}
        refills = sc.diagnostics["slot_refills"]
        log(f"  screened fractions "
            f"{[round(float(f), 4) for f in sc.screened_fracs]}, max "
            f"{float(np.max(sc.screened_fracs)):.4f}; step keys by (bucket, "
            f"slot design): {len(slots)}, slot designs made "
            f"{sc.diagnostics['slots_made']}, refilled in place {refills} "
            f"of {int(np.sum(sc.screened_fracs < 1.0))} screened solves")
        if not np.max(sc.screened_fracs) > 0.1:
            fails.append(f"{tag}: the rule screened at most "
                         f"{float(np.max(sc.screened_fracs)):.4f}")
        if n_lam == c["fine_lambdas"] and not refills:
            fails.append(f"{tag}: no slot design was refilled in place")

    # (d) a MultiTaskLasso path on the M/EEG leadfield
    d = cfg["path_mt"]
    X, Y, _, _ = make_leadfield(**cfg["meeg"])
    log(f"path (d): MultiTaskLasso on the M/EEG leadfield {cfg['meeg']}, "
        f"{d['n_lambdas']} lambdas to lambda_max/{round(1 / d['ratio'])}, "
        f"tol {TOL}")
    kw = dict(n_lambdas=d["n_lambdas"], lambda_min_ratio=d["ratio"],
              tol=TOL, device=dev)
    kd, _ = run_path("kernels", lambda: reg_path(
        X, Y, BlockL1(1.0), MultitaskQuadratic(), **kw), dev, total)
    od, _ = run_path("oracle ", lambda: reg_path(
        X, Y, BlockL1(1.0), MultitaskQuadratic(),
        engine=engine(BlockL1(1.0), MultitaskQuadratic(), capture=False),
        **kw), dev)
    converged("path (d)", kd, TOL)
    path_keys_once("path (d)", kd, fails)
    same("path (d)", kd, od)
    need = ("fused_ws", "cd_epoch_gram", "csc_score", "fused_ws_block",
            "cd_epoch_gram_block")
    missing = [k for k in need if not total[k]]
    if missing:
        fails.append(f"paths: kernels never launched {missing}")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return total, fails


# ------------------------------------------------------------------- lanes
def lane_rows(pen, S, dev, seed=0):
    """[S, arity] codec rows of `pen` on `dev`: its first hyper-parameter
    (lam, or Box's C) scaled per lane by a seeded factor in [0.5, 1.5]."""
    import numpy as np
    import torch
    from repro_torch.kernels.common import penalty_params
    rows = penalty_params(pen).repeat(S, 1)
    rows[:, 0] *= torch.as_tensor(np.random.default_rng(seed).uniform(
        0.5, 1.5, S))
    return rows.to(dev)


def gram_lane_inputs(S, K, dev, seed):
    """K1l inputs on the card: lane s's G is the Gram of one 3K x K
    Gaussian design scaled by 1 + 0.01 s (column-major, as the engine
    lays it out), its own c and beta0, q0 = G beta0, L = diag(G)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    X = torch.randn(3 * K, K, generator=g, device=dev, dtype=torch.float64)
    G0 = X.T @ X / (3 * K)
    del X
    scale = 1.0 + 0.01 * torch.arange(S, dtype=torch.float64, device=dev)
    G = (G0[None] * scale[:, None, None]).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    del G0
    c = 0.1 * torch.randn(S, K, generator=g, device=dev, dtype=torch.float64)
    beta0 = 0.1 * torch.randn(S, K, generator=g, device=dev,
                              dtype=torch.float64)
    q0 = (G @ beta0[..., None])[..., 0]
    return G, c, beta0, q0, torch.diagonal(G, dim1=1, dim2=2).contiguous()


def lane_mask(S, dev):
    """Lanes 1, 4, 7, ... frozen (none for one lane)."""
    import torch
    return torch.arange(S, device=dev) % 3 != 1


def check_k1l_sizes(dev, cfg):
    """K1l on every cluster size its lane plan can choose (the clusters of
    STEP_DOWN), forced, at the config's S and each K, for L1 and MCP: each
    lane K1 bit for bit, frozen lanes unchanged; the plan the wrapper
    takes there, the card's capacity for it (K1l's clusters at once) and
    its waves; K1's and K1l's registers and
    local bytes a thread (``cudaFuncGetAttributes``), every penalty: a K1l
    instance with more local memory than K1's of its penalty (a spill)
    fails. Returns the failures."""
    import torch
    from repro_torch.core.penalties import L1, MCP
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (
        STEP_DOWN, cd_epoch_gram_lanes_cuda, lane_capacity,
        gram_kernel_attrs_cuda, gram_lanes_plan, gram_plan)
    from repro_torch.kernels.common import (PENALTY_IDS,
                                            SCALAR_COORD_PENALTIES)
    fails = []
    if dev.type != "cuda":
        return fails
    f64 = torch.float64
    c = cfg["k1l_sizes"]
    S = c["S"]
    for K in c["K"]:
        G, cc, beta0, q0, L = gram_lane_inputs(S, K, dev, seed=3 * K)
        active = lane_mask(S, dev)
        plan = gram_lanes_plan(S, K, f64)
        cap, sms = lane_capacity(plan, f64)
        sizes = STEP_DOWN[:-1]
        log(f"  K1l S={S} K={K}: lane plan C={plan.cluster} "
            f"({plan.threads} threads), the card runs {cap} such clusters "
            f"at once on {sms} SMs: {-(-S // max(1, cap))} wave(s) of "
            f"{S * plan.cluster} CTAs; forced here: C in {sizes}")
        for pen in (L1(0.11), MCP(0.11, 3.0)):
            name = type(pen).__name__
            prm = lane_rows(pen, S, dev, seed=K)
            refs = [ops.cd_epoch_gram(G[s], cc[s], beta0[s], q0[s], L[s],
                                      type(pen), prm[s], epochs=2)
                    for s in range(S)]
            for C in sizes:
                b, q = cd_epoch_gram_lanes_cuda(
                    G, cc, beta0, q0, L, type(pen), prm, active, epochs=2,
                    plan=gram_plan(K, f64, cluster=C))
                same = True
                for s in range(S):
                    want = refs[s] if active[s] else (beta0[s], q0[s])
                    same &= bool(torch.equal(b[s], want[0])
                                 and torch.equal(q[s], want[1]))
                if not same:
                    fails.append(f"K1l S={S} K={K} C={C} {name}: not K1 "
                                 f"bit for bit lane by lane")
        del G
        torch.cuda.empty_cache()
    attrs = {}
    for pen_cls in sorted(SCALAR_COORD_PENALTIES, key=PENALTY_IDS.get):
        for cluster in (False, True):
            key = f"{'cluster' if cluster else 'one CTA'} {pen_cls.__name__}"
            k1 = gram_kernel_attrs_cuda(False, cluster, PENALTY_IDS[pen_cls])
            k1l = gram_kernel_attrs_cuda(True, cluster, PENALTY_IDS[pen_cls])
            attrs[key] = k1 + k1l
            if k1l[1] > k1[1]:
                fails.append(f"K1l {key}: {k1l[1]} bytes of local memory a "
                             f"thread, K1 {k1[1]}")
    log("  registers / local bytes a thread, K1 | K1l: "
        + ", ".join(f"{k} {a[0]}/{a[1]} | {a[2]}/{a[3]}"
                    for k, a in attrs.items()))
    return fails


def check_lane_kernels(dev, cfg, errs):
    """K1l, K2l and K3l on the card against their single-lane kernels and
    plain versions on the same inputs: K1l at every (S, K) of the config,
    all seven penalties with per-lane parameters, bit for bit per lane
    against K1 on that lane's inputs, frozen lanes unchanged, within K1's
    bound of the plain version at k1l_plain_S lanes (every penalty up to
    k1l_plain_K, L1 above); K2l (weighted logistic, per-lane weights) bit for bit per lane
    against K2 and within K2's bound of its plain version; K3l at ws 64
    and 1024 on random and tied-integer data within K3's bounds (equal on
    the integers), cand_idx exact, each lane's working set
    ``select_working_set`` of its plain scores and its rows bit for bit.
    Returns the failures."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.core.working_set import select_working_set
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              cd_epoch_xb_lanes_plain)
    from repro_torch.kernels.fused_ws import (fused_ws_lanes_plain,
                                              fused_ws_plain)
    fails = []
    for k in ("cd_epoch_gram_lanes", "cd_epoch_xb_lanes", "fused_ws_lanes"):
        errs[k] = 0.0

    def note(key, a, b, atol, rtol, tag):
        ok, e = close(a, b, atol, rtol)
        errs[key] = max(errs[key], e)
        if not ok:
            fails.append(f"{tag} err={e:.3e}")

    t = time.perf_counter()
    for S in cfg["k1l_S"]:
        t1 = time.perf_counter()
        for K in cfg["k1l_K"]:
            G, c, beta0, q0, L = gram_lane_inputs(S, K, dev, seed=S * K)
            active = lane_mask(S, dev)
            first = int(torch.nonzero(active)[0])
            for pen in penalties():
                name = type(pen).__name__
                prm = lane_rows(pen, S, dev, seed=S + K)
                b, q = ops.cd_epoch_gram_lanes(G, c, beta0, q0, L, type(pen),
                                               prm, active, epochs=2)
                same = True
                for s in range(S):
                    if not bool(active[s]):
                        same &= bool(torch.equal(b[s], beta0[s])
                                     and torch.equal(q[s], q0[s]))
                        continue
                    bs, qs = ops.cd_epoch_gram(G[s], c[s], beta0[s], q0[s],
                                               L[s], type(pen), prm[s],
                                               epochs=2)
                    same &= bool(torch.equal(b[s], bs)
                                 and torch.equal(q[s], qs))
                if not same:
                    fails.append(f"K1l S={S} K={K} {name}: not K1 bit for "
                                 f"bit lane by lane")
                if S == cfg["k1l_plain_S"] and (K <= cfg["k1l_plain_K"]
                                                or name == "L1"):
                    bp, qp = cd_epoch_gram_plain(
                        G[first], c[first], beta0[first], q0[first],
                        L[first], type(pen), prm[first], epochs=2)
                    note("cd_epoch_gram_lanes", b[first], bp, 1e-12, 1e-5,
                         f"K1l S={S} K={K} {name} beta")
                    note("cd_epoch_gram_lanes", q[first], qp, 1e-12, 1e-5,
                         f"K1l S={S} K={K} {name} q")
            del G
            if dev.type == "cuda":
                torch.cuda.empty_cache()
        log(f"  K1l checks at S={S}: {time.perf_counter() - t1:.1f} s")
    fails += check_k1l_sizes(dev, cfg)
    log(f"  K1l checks: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    c2 = cfg["k2l"]
    S, K, n = c2["S"], c2["K"], c2["n"]
    Xt, y, _, beta0, _, L, off = xb_inputs(K, n, "logistic", dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(6)
    Xt = torch.stack([Xt] + [Xt + 0.01 * s * torch.randn(
        K, n, generator=g, device=dev, dtype=torch.float64)
        for s in range(1, S)])
    beta0 = beta0.expand(S, K).contiguous() * (1 + 0.1 * torch.arange(
        S, device=dev, dtype=torch.float64))[:, None]
    Xb0 = (beta0[:, None, :] @ Xt)[:, 0]
    L = torch.sum(Xt * Xt, dim=2) / (4 * n)
    off = off.expand(S, K).contiguous()
    w = 0.5 + torch.rand(S, n, generator=g, device=dev, dtype=torch.float64)
    active = lane_mask(S, dev)
    prm = lane_rows(L1(0.002), S, dev, seed=7)
    b, x = ops.cd_epoch_xb_lanes(Xt, y, beta0, Xb0, L, off, L1, prm, active,
                                 "logistic", w=w, epochs=1)
    bp, xp = cd_epoch_xb_lanes_plain(Xt, y, beta0, Xb0, L, off, L1, prm,
                                     active, "logistic", w=w, epochs=1)
    note("cd_epoch_xb_lanes", b, bp, 1e-11, 1e-8, f"K2l S={S} K={K} beta")
    note("cd_epoch_xb_lanes", x, xp, 1e-11, 1e-8, f"K2l S={S} K={K} Xb")
    for s in range(S):
        if bool(active[s]):
            bs, xs = ops.cd_epoch_xb(Xt[s], y, beta0[s], Xb0[s], L[s], off[s],
                                     L1, prm[s], "logistic", w=w[s], epochs=1)
            if not (torch.equal(b[s], bs) and torch.equal(x[s], xs)):
                fails.append(f"K2l lane {s}: not K2 bit for bit")
        elif not (torch.equal(b[s], beta0[s]) and torch.equal(x[s], Xb0[s])):
            fails.append(f"K2l frozen lane {s} changed")
    del Xt
    log(f"  K2l checks: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    c3 = cfg["k3l"]
    S = c3["S"]
    n, p = cfg["k3_n"], cfg["k3_p"]
    for ties in (False, True):
        Xt, _, _, L, off = fused_inputs(n, p, dev, seed=3, ties=ties)
        g = torch.Generator(device=dev).manual_seed(8)
        if ties:
            R = torch.randint(-2, 3, (n, S), generator=g, device=dev).double()
            beta = torch.randint(-1, 2, (S, p), generator=g,
                                 device=dev).double()
            pen = L1(0.5)
        else:
            R = torch.randn(n, S, generator=g, device=dev,
                            dtype=torch.float64)
            beta = torch.randn(S, p, generator=g, device=dev,
                               dtype=torch.float64) * \
                (torch.rand(S, p, generator=g, device=dev) < 0.3)
            pen = L1(0.11)
        prm = lane_rows(pen, S, dev, seed=9)
        gs = beta != 0
        for ws in c3["ws"]:
            tag = f"K3l S={S} ws={ws} ties={ties}"
            sk, gk, ik, wk, xk = ops.fused_ws_lanes(Xt, R, beta, L.expand(
                S, p), off, gs, L1, prm, ws)
            sr, gr, ir, _ = fused_ws_lanes_plain(Xt, R, beta, L.expand(S, p),
                                                 off, gs, L1, prm, ws)
            note("fused_ws_lanes", sk, sr, 1e-12, 1e-11, f"{tag} scores")
            note("fused_ws_lanes", gk, gr, 1e-12, 1e-10, f"{tag} grad")
            exact = not ties or (torch.equal(sk, sr) and torch.equal(gk, gr))
            same = bool(torch.equal(ik, ir)) and exact and all(
                torch.equal(wk[s], select_working_set(sr[s], gs[s], ws))
                and torch.equal(xk[s], Xt[wk[s]]) for s in range(S))
            if not same:
                fails.append(f"{tag}: candidates, working sets or rows "
                             f"differ")
        if not ties:
            # the (g4) grid's lane count: the wide product
            S = c3["wide_S"]
            R = torch.randn(n, S, generator=g, device=dev,
                            dtype=torch.float64)
            beta = torch.randn(S, p, generator=g, device=dev,
                               dtype=torch.float64) * \
                (torch.rand(S, p, generator=g, device=dev) < 0.3)
            prm = lane_rows(pen, S, dev, seed=10)
            gs = beta != 0
            ws = max(c3["ws"])
            sk, gk, ik, wk, xk = ops.fused_ws_lanes(
                Xt, R, beta, L.expand(S, p), off, gs, L1, prm, ws)
            same = True
            for s in range(S):
                # lane by lane: the plain version's candidate buffer is as
                # large as X a lane
                sr, gr, ir, _ = fused_ws_plain(Xt, R[:, s], beta[s], L, off,
                                               gs[s], L1, prm[s], ws)
                note("fused_ws_lanes", sk[s], sr, 1e-12, 1e-12,
                     f"K3l S={S} ws={ws} lane {s} scores")
                note("fused_ws_lanes", gk[s], gr, 1e-12, 1e-10,
                     f"K3l S={S} ws={ws} lane {s} grad")
                same &= bool(torch.equal(ik[s], ir) and torch.equal(
                    wk[s], select_working_set(sr, gs[s], ws))
                    and torch.equal(xk[s], Xt[wk[s]]))
            if not same:
                fails.append(f"K3l S={S} ws={ws}: candidates, working sets "
                             f"or rows differ")
            del xk, R, S
            S = c3["S"]
        del Xt
    log(f"  K3l checks: {time.perf_counter() - t:.1f} s")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return fails


# the lane epochs' launches by shape ("K=<K> C=<C>": K rounded up to a
# power of two, the cluster size) over the captured kernel-route grids
# run_grid counts into a total
SHAPES: dict = {}


def run_grid(label, call, dev, total=None):
    """Run one grid (``call()`` -> a fitted CV estimator or a GridResult)
    with the launch counts reset just before and read just after (added to
    `total` when given), and print its wall time, rounds, mean occupancy,
    dispatches, outer steps, captures and their seconds, peak allocated /
    reserved memory, alpha_ and launches."""
    import numpy as np
    import torch
    from repro_torch.kernels import ops
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t = time.perf_counter()
    out = call()
    if dev.type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t
    counts = all_counts()
    if total is not None:
        for k in total:
            total[k] += counts[k]
        for k, per in ops.shape_counts().items():
            mine = SHAPES.setdefault(k, {})
            for shape, n in per.items():
                mine[shape] = mine.get(shape, 0) + n
    peak, reserved = (torch.cuda.max_memory_allocated() / 2**30,
                      torch.cuda.max_memory_reserved() / 2**30) \
        if dev.type == "cuda" else (float("nan"), float("nan"))
    g = getattr(out, "grid_result_", getattr(out, "path_result_", out))
    alpha = getattr(out, "alpha_", None)
    if hasattr(g, "n_rounds"):
        stats = (f"{g.n_rounds} rounds, occupancy "
                 f"{float(np.mean(g.occupancy)):.4f}, dispatches "
                 f"{g.n_dispatches}, outer steps {g.n_outer}, host reads "
                 f"{g.n_host_syncs}, captures {len(g.capture_s)} "
                 f"({float(np.sum(g.capture_s)):.3f} s), keys "
                 f"{len(g.captures)}, converged "
                 f"{int(np.sum(g.kkts <= TOL))}/{g.kkts.size}")
    else:                                   # an information-criterion path
        cap = g.diagnostics["capture_s"]
        stats = (f"{len(g.lambdas)} lambdas, outer steps "
                 f"{int(np.sum(g.n_outer))}, host reads {g.n_host_syncs}, "
                 f"captures {len(cap)} ({float(np.sum(cap)):.3f} s), keys "
                 f"{len(g.captures)}")
    log(f"  {label}: wall {wall:.3f} s, {stats}, peak mem {peak:.3f} GiB "
        f"(reserved {reserved:.3f}), alpha_ {alpha}, launches "
        f"{ {k: v for k, v in counts.items() if v} }")
    return out, counts, wall


def grid_held(label, k, o, tol, *, fails):
    """The kernel-route grid `k` (an estimator or a GridResult) held to
    its ``capture=False`` run `o` bit for bit (betas, cv_loss, kkts), each
    step key captured once, every item at kkt <= `tol`, one read a
    dispatch; a failure is appended to `fails`."""
    import numpy as np
    gk = getattr(k, "grid_result_", k)
    go = getattr(o, "grid_result_", o)
    same = bool(np.array_equal(gk.betas, go.betas)
                and np.array_equal(gk.cv_loss, go.cv_loss)
                and np.array_equal(gk.kkts, go.kkts))
    keys = set(gk.captures.values()) == {1}
    conv = bool(np.max(gk.kkts) <= tol)
    log(f"  {label}: == capture=False bit for bit {same}; keys captured "
        f"once {keys} ({len(gk.captures)}); every item kkt <= {tol} "
        f"{conv}; one read a dispatch "
        f"{gk.n_host_syncs == gk.n_dispatches}")
    if not (same and keys and conv and gk.n_host_syncs == gk.n_dispatches):
        fails.append(f"{label}: bit for bit {same}, keys {gk.captures}, "
                     f"max kkt {float(np.max(gk.kkts)):.3e}")


def grid_needs(label, counts, kernels, *, fails, absent=()):
    """Each kernel of `kernels` launched in `counts`, none of `absent`."""
    missing = [k for k in kernels if not counts[k]]
    extra = [k for k in absent if counts[k]]
    if missing or extra:
        fails.append(f"{label}: kernels never launched {missing}, launched "
                     f"though not on this path {extra}")


def grid_phase(dev, cfg, sparse_design, sparse_y):
    """The CV grids at full width on the kernel route, each held to
    ``capture=False`` bit for bit (betas, cv_loss, kkts), every item at
    kkt <= tol and each step key captured once: (g1) LassoCV on cv_fig
    (its folds 0 and 1 also against the sequential path on their row
    subsets, and the BIC path); (g2) LassoCV on sparse_fig2; (g3)
    SparseLogisticRegressionCV on make_classification; (g4) the reference's
    acceptance grid on both routes, with its budget contract and a second
    grid on the same engine capturing nothing. Returns (launch counts of
    the captured kernel-route grids, the grids' walls, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (L1, Logistic, LassoCV, Quadratic,
                                  SparseLogisticRegressionCV, cross_val_path,
                                  lambda_max, make_engine, reg_path)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_classification, make_correlated_design
    total = dict.fromkeys(all_counts(), 0)
    fails, walls = [], {}
    held = functools.partial(grid_held, fails=fails)
    need = functools.partial(grid_needs, fails=fails)

    def eager(datafit):
        return make_engine(L1(1.0), datafit, device=dev, capture=False)

    # (g1) LassoCV on cv_fig: 10 lanes, 150 items, K3l + K1l
    c = cfg["g1"]
    X, y, _ = make_correlated_design(n=cfg["reg_n"], p=cfg["reg_p"],
                                     n_nonzero=cfg["reg_nnz"], rho=0.5,
                                     snr=5.0, seed=0)
    design = DenseDesign.from_dense(X, dev)
    kw = dict(cv=c["cv"], n_alphas=c["n_alphas"], eps=c["eps"],
              vmap_chunk=c["vmap_chunk"], tol=TOL, device=dev)
    log(f"grid (g1): LassoCV({kw}) on cv_fig ({cfg['reg_n']} x "
        f"{cfg['reg_p']})")
    k1, counts, walls["g1"] = run_grid("kernels", lambda: LassoCV(**kw).fit(
        design, y), dev, total)
    need("grid (g1)", counts, ("fused_ws_lanes", "cd_epoch_gram_lanes"))
    o1, _, _ = run_grid("oracle ", lambda: LassoCV(
        engine=eager(Quadratic()), **kw).fit(design, y), dev)
    held("grid (g1)", k1, o1, TOL)
    g = k1.grid_result_
    for f in range(c["folds"]):
        keep = g.fold_weights[f] > 0
        sub, _ = run_path(f"fold {f} rows, sequential", lambda: reg_path(
            X[keep], y[keep], L1(1.0), lambdas=g.lambdas, tol=TOL,
            device=dev), dev)
        diff = float(np.max(np.abs(sub.betas - g.betas[f])))
        log(f"  grid (g1) fold {f} vs its row-subset path: max |diff| "
            f"{diff:.3e} (bound 1e-5: two solves each at kkt <= {TOL})")
        if not diff <= 1e-5:
            fails.append(f"grid (g1) fold {f}: {diff:.3e} from its path")
    del X
    bkw = dict(n_alphas=c["n_alphas"], eps=c["eps"], criterion="bic",
               vmap_chunk=c["vmap_chunk"], tol=TOL, device=dev)
    kb, counts, walls["g1-bic"] = run_grid("BIC kernels", lambda: LassoCV(
        **bkw).fit(design, y), dev, total)
    need("grid (g1) BIC", counts, ("fused_ws_lanes", "cd_epoch_gram_lanes"))
    ob, _, _ = run_grid("BIC oracle ", lambda: LassoCV(
        engine=eager(Quadratic()), **bkw).fit(design, y), dev)
    pk, po = kb.path_result_, ob.path_result_
    same = bool(np.array_equal(pk.betas, po.betas)) and \
        set(pk.captures.values()) == {1} and kb.alpha_ == ob.alpha_
    log(f"  grid (g1) BIC path == capture=False bit for bit, keys once: "
        f"{same}; alpha_ {kb.alpha_}")
    if not same or not np.all(pk.kkts <= TOL):
        fails.append("grid (g1) BIC path differs from capture=False or "
                     "did not converge")
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (g2) LassoCV on sparse_fig2: K5b at T = 10, K1l, K5s a fold. The
    # alphas are made once: lambda_max's plain CSC score pass adds with
    # atomics on the card, so two fits' grids can differ in the last bit
    c = cfg["g2"]
    lmax = lambda_max(sparse_design, sparse_y, device=dev)
    kw = dict(cv=c["cv"], alphas=lmax * np.geomspace(1.0, c["eps"],
                                                     c["n_alphas"]),
              vmap_chunk=c["vmap_chunk"], tol=TOL, device=dev)
    log(f"grid (g2): LassoCV(cv={c['cv']}, n_alphas={c['n_alphas']}, "
        f"eps={c['eps']}, vmap_chunk={c['vmap_chunk']}) on sparse_fig2")
    k2, counts, walls["g2"] = run_grid("kernels", lambda: LassoCV(**kw).fit(
        sparse_design, sparse_y), dev, total)
    need("grid (g2)", counts, ("csc_score_block", "cd_epoch_gram_lanes",
                               "csc_weighted_col_sq"))
    if counts["csc_weighted_col_sq"] != c["cv"]:
        fails.append(f"grid (g2): K5s launched "
                     f"{counts['csc_weighted_col_sq']} times, not once a "
                     f"fold")
    o2, _, _ = run_grid("oracle ", lambda: LassoCV(
        engine=eager(Quadratic()), **kw).fit(sparse_design, sparse_y), dev)
    held("grid (g2)", k2, o2, TOL)

    # (g3) SparseLogisticRegressionCV on make_classification: K3l + K2l
    c = cfg["g3"]
    X, y, _ = make_classification(n=c["n"], p=c["p"], n_nonzero=150, seed=0)
    design = DenseDesign.from_dense(X, dev)
    del X
    kw = dict(cv=c["cv"], n_alphas=c["n_alphas"], eps=c["eps"],
              vmap_chunk=c["vmap_chunk"], tol=TOL, device=dev)
    log(f"grid (g3): SparseLogisticRegressionCV({kw}) on "
        f"make_classification({c['n']} x {c['p']})")
    k3, counts, walls["g3"] = run_grid("kernels", lambda: (
        SparseLogisticRegressionCV(**kw).fit(design, y)), dev, total)
    need("grid (g3)", counts, ("fused_ws_lanes", "cd_epoch_xb_lanes"))
    o3, _, _ = run_grid("oracle ", lambda: SparseLogisticRegressionCV(
        engine=eager(Logistic()), **kw).fit(design, y), dev)
    held("grid (g3)", k3, o3, TOL)
    del design

    # (g4) the reference's acceptance grid, both routes
    c = cfg["g4"]
    X, y, _ = make_correlated_design(n=c["n"], p=c["p"],
                                     n_nonzero=c["n_nonzero"], seed=c["seed"])
    design = DenseDesign.from_dense(X, dev)
    kw = dict(n_lambdas=c["n_lambdas"], cv=c["cv"], tol=c["tol"],
              vmap_chunk=c["vmap_chunk"])
    log(f"grid (g4): cross_val_path({kw}) on {c['n']} x {c['p']}")
    eng = make_engine(L1(1.0), Quadratic(), device=dev)
    k4, counts, walls["g4"] = run_grid("kernels", lambda: cross_val_path(
        design, y, Quadratic(), L1(1.0), engine=eng, **kw), dev, total)
    need("grid (g4)", counts, ("fused_ws_lanes", "cd_epoch_gram_lanes"))
    o4, _, _ = run_grid("oracle ", lambda: cross_val_path(
        design, y, Quadratic(), L1(1.0), engine=eager(Quadratic()), **kw),
        dev)
    held("grid (g4)", k4, o4, c["tol"])
    lanes = {key[3] for key in k4.captures}
    budget = lanes == {c["cv"] * c["vmap_chunk"]} and \
        0 < k4.n_dispatches <= k4.n_outer and \
        k4.n_host_syncs == k4.n_dispatches and 0 < k4.best_index < 29
    log(f"  grid (g4) budget: lane counts {lanes}, dispatches "
        f"{k4.n_dispatches} <= outer steps {k4.n_outer}, host reads "
        f"{k4.n_host_syncs}, best index {k4.best_index}: ok {budget}")
    if not budget:
        fails.append("grid (g4): the budget contract does not hold")
    before = dict(eng.captures)
    again, _, _ = run_grid("again  ", lambda: cross_val_path(
        design, y, Quadratic(), L1(1.0), engine=eng, seed=7, **kw), dev)
    if dict(eng.captures) != before or not again.n_dispatches:
        fails.append("grid (g4): a second grid on the same engine captured")
    log(f"  grid (g4) second grid on the same engine: new captures "
        f"{len(eng.captures) - len(before)}")
    eng.release_graphs()
    p4, _, _ = run_grid("plain  ", lambda: cross_val_path(
        design, y, Quadratic(), L1(1.0), device=dev, use_kernels=False,
        **kw), dev)
    diff = float(np.max(np.abs(p4.betas - k4.betas)))
    log(f"  grid (g4) plain route: max |diff| {diff:.3e} (bound 1e-6), "
        f"max kkt {float(np.max(p4.kkts)):.3e}")
    if not diff <= 1e-6 or not np.max(p4.kkts) <= c["tol"]:
        fails.append(f"grid (g4) plain route: {diff:.3e} from the kernel "
                     f"route")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"  lane epochs' launches by shape over (g1)-(g4): "
        f"{json.dumps(SHAPES)}")
    return total, walls, fails


def k1l_shapes(dev, cfg, reps):
    """K1l at the config's other (S, K) (L1, 1 epoch, every lane active):
    its plan's cluster size, the card's clusters at once (one CTA a lane:
    the SMs) and the waves, its ms beside one K1 launch at K (CUDA
    events, warm)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import gram_lanes_plan, lane_capacity
    out = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 1
    for S, K in cfg["lane_time"]["k1l_other"]:
        G, c, beta0, q0, L = gram_lane_inputs(S, K, dev, seed=K + S)
        prm = lane_rows(L1(0.11), S, dev, seed=S)
        on = torch.ones(S, dtype=torch.bool, device=dev)
        args = (G, c, beta0, q0, L, L1, prm, on)
        plan = gram_lanes_plan(S, K, torch.float64)
        cap = lane_capacity(plan, torch.float64)[0] if plan.cluster > 1 \
            else sms
        out.append(dict(
            S=S, K=K, cluster=plan.cluster, clusters_at_once=cap,
            waves=-(-S // max(1, cap)),
            ms=time_ms(lambda: ops.cd_epoch_gram_lanes(*args), dev, reps),
            k1_ms=time_ms(lambda: ops.cd_epoch_gram(
                G[0], c[0], beta0[0], q0[0], L[0], L1, prm[0]), dev, reps)))
        del G
    return out


def lane_times(dev, cfg, launches, errs, card):
    """The rows of K1l, K2l and K3l at S = 10 lanes: K1l at K = 1024
    (L1, 1 epoch) beside ten K1 launches; K2l at (K, n) = (512, 10,000)
    (weighted logistic) beside ten K2 launches; K3l at ws = 1024 beside
    ten K3 heads, with torch.mm(Xt, R) as the library call. Bounds: K1l
    and K2l S times their single lane's bytes and operations (chain floor:
    K1's or K2's per lane, times the waves of lanes the card runs at
    once); K3l X once, R, beta, L and gsupp read, scores, grad and ws
    written, the S K rows read and written once (the gather)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_lanes_plain,
                                              cd_epoch_xb_lanes_plain,
                                              gram_chain_floor_cuda,
                                              gram_lanes_plan, lane_capacity,
                                              xb_plan)
    from repro_torch.kernels.fused_ws import fused_ws_lanes_plain, pick_bp
    reps = cfg["reps"]
    S, K = cfg["lane_time"]["S"], cfg["lane_time"]["K1"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 1
    rows = []

    # K1l
    G, c, beta0, q0, L = gram_lane_inputs(S, K, dev, seed=K)
    prm = lane_rows(L1(0.11), S, dev, seed=1)
    on = torch.ones(S, dtype=torch.bool, device=dev)
    args = (G, c, beta0, q0, L, L1, prm, on)
    ms = time_ms(lambda: ops.cd_epoch_gram_lanes(*args), dev, reps)
    replay = graph_ms(lambda: ops.cd_epoch_gram_lanes(*args), dev, reps)
    ten = time_ms(lambda: [ops.cd_epoch_gram(G[s], c[s], beta0[s], q0[s],
                                             L[s], L1, prm[s])
                           for s in range(S)], dev, reps)
    plain = time_ms(lambda: cd_epoch_gram_lanes_plain(*args), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_gram_lanes(*args)[0] != beta0))
    b = bound(8 * (moved * K + 6 * K * S), 2 * moved * K)
    plan = gram_lanes_plan(S, K, torch.float64)
    cap = lane_capacity(plan, torch.float64)[0] if plan.cluster > 1 \
        else sms
    waves = -(-S // max(1, cap))
    floor = None
    if dev.type == "cuda":
        epochs = max(1, 200_000 // K)
        floor = waves * time_ms(lambda: gram_chain_floor_cuda(
            K, epochs, plan.threads, dev), dev, 3) / epochs
    rows.append(dict(
        name="cd_epoch_gram_lanes", route="cuda",
        source="src/repro_torch/csrc/cd_epoch.cu",
        replaces="src/repro/kernels/cd_epoch.py:52",
        launches=launches["cd_epoch_gram_lanes"],
        max_abs_err=errs["cd_epoch_gram_lanes"], ms=ms, plain_ms=plain,
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_call="none: no single call", ten_single_ms=ten,
        graph_ms=replay,
        shape=f"S={S} lanes, K={K}, epochs=1, L1 (lam a lane), {moved} "
              f"coordinates moved",
        branch=plan.branch, cluster=plan.cluster, threads=plan.threads,
        chain_floor_ms=floor, lane_waves=waves, clusters_at_once=cap,
        launches_by_branch={br: launches[f"cd_epoch_gram_lanes/{br}"]
                            for br in ("single", "cluster-shared",
                                       "cluster-global")},
        launches_by_shape=SHAPES.get("cd_epoch_gram_lanes", {}),
        other_shapes=k1l_shapes(dev, cfg, reps)))
    del G

    # K2l
    c2 = cfg["k2l"]
    K2, n = c2["K"], c2["n"]
    Xt, y, _, b0, _, L2, off = xb_inputs(K2, n, "logistic", dev, seed=7)
    Xt = Xt.expand(S, K2, n).contiguous()
    b0 = b0.expand(S, K2).contiguous()
    Xb0 = (b0[:, None, :] @ Xt)[:, 0]
    L2 = L2.expand(S, K2).contiguous()
    off = off.expand(S, K2).contiguous()
    w = 0.5 + torch.rand(S, n, device=dev, dtype=torch.float64)
    prm = lane_rows(L1(0.07), S, dev, seed=2)
    args = (Xt, y, b0, Xb0, L2, off, L1, prm, on, "logistic")
    ms = time_ms(lambda: ops.cd_epoch_xb_lanes(*args, w=w), dev, reps)
    ten = time_ms(lambda: [ops.cd_epoch_xb(Xt[s], y, b0[s], Xb0[s], L2[s],
                                           off[s], L1, prm[s], "logistic",
                                           w=w[s]) for s in range(S)],
                  dev, reps)
    plain = time_ms(lambda: cd_epoch_xb_lanes_plain(*args, w=w), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_xb_lanes(*args, w=w)[0] != b0))
    b = bound(8 * S * (K2 * n + 4 * n + 5 * K2),
              2 * S * K2 * n + 4 * moved * n)
    plan = xb_plan(n, True, torch.float64)
    waves = -(-S // max(1, sms // plan.cluster))
    row = dict(
        name="cd_epoch_xb_lanes", route="cuda",
        source="src/repro_torch/csrc/cd_epoch.cu",
        replaces="src/repro/kernels/cd_epoch.py:128",
        launches=launches["cd_epoch_xb_lanes"],
        max_abs_err=errs["cd_epoch_xb_lanes"], ms=ms, plain_ms=plain,
        bound_ms=b[0], bound_by=b[1], library_ms=None,
        library_call="none: no single call", ten_single_ms=ten,
        shape=f"S={S} lanes, K={K2}, n={n}, logistic, weighted a lane, "
              f"epochs=1, L1 (lam a lane), {moved} coordinates moved",
        lane_waves=waves, **plan_fields(dev, "cd_epoch_xb_lanes", plan, K2,
                                        launches))
    if row["chain_floor_ms"] is not None:
        row["chain_floor_ms"] *= waves
    rows.append(row)
    del Xt

    # K3l
    n, p = cfg["k3_n"], cfg["k3_p"]
    ws = max(cfg["k3l"]["ws"])
    Xt, _, _, L, off = fused_inputs(n, p, dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(4)
    R = torch.randn(n, S, generator=g, device=dev, dtype=torch.float64)
    beta = torch.randn(S, p, generator=g, device=dev, dtype=torch.float64) \
        * (torch.rand(S, p, generator=g, device=dev) < 0.3)
    gs = beta != 0
    Ls = L.expand(S, p)
    prm = lane_rows(L1(0.11), S, dev, seed=3)
    args = (Xt, R, beta, Ls, off, gs, L1, prm, ws)
    ms = time_ms(lambda: ops.fused_ws_lanes(*args), dev, reps)
    ten = time_ms(lambda: [ops.fused_ws(Xt, R[:, s].contiguous(), beta[s],
                                        L, off, gs[s], L1, prm[s], ws)
                           for s in range(S)], dev, reps)
    plain = time_ms(lambda: fused_ws_lanes_plain(*args), dev, 1)
    lib = time_ms(lambda: torch.mm(Xt, R), dev, reps)
    bp = pick_bp(p)
    C = -(-p // bp) * min(bp, ws)
    b = bound(8 * (p * n + S * n + S * p * 3 + p + S * ws
                   + 2 * S * ws * n) + S * p + 4 * S * C, 2 * S * p * n)
    rows.append(dict(
        name="fused_ws_lanes", route="cuda",
        source="src/repro_torch/csrc/fused_ws.cu",
        replaces="src/repro/kernels/fused_ws.py:125",
        launches=launches["fused_ws_lanes"],
        max_abs_err=errs["fused_ws_lanes"], ms=ms, plain_ms=plain,
        bound_ms=b[0], bound_by=b[1], library_ms=lib,
        library_call="torch.mm(Xt, R): the gradient part only",
        ten_single_ms=ten,
        shape=f"S={S} lanes, n={n}, p={p}, ws={ws}, bp={bp}, L1 (lam a "
              f"lane)"))
    del Xt
    log_rows(rows, card)
    for row in rows:
        log(f"  {row['name']}: one lane launch {row['ms']:.4f} ms against "
            f"{S} single-lane launches {row['ten_single_ms']:.4f} ms on "
            f"{card}")
    return rows


# ------------------------------------------------------- multitask lanes
def block_lane_inputs(S, K, T, dev, seed):
    """K1bl inputs on the card: lane s's G the Gram of one 3K x K Gaussian
    design scaled by 1 + 0.01 s (column-major, as the engine lays it out),
    its own c and beta0 (half its rows zero), q0 = G beta0, L = diag(G)."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    X = torch.randn(3 * K, K, **f64)
    G0 = X.T @ X / (3 * K)
    del X
    scale = 1.0 + 0.01 * torch.arange(S, dtype=torch.float64, device=dev)
    G = (G0[None] * scale[:, None, None]).transpose(1, 2).contiguous() \
        .transpose(1, 2)
    del G0
    c = 0.1 * torch.randn(S, K, T, **f64)
    beta0 = 0.1 * torch.randn(S, K, T, **f64) * \
        (torch.rand(S, K, 1, **f64) < 0.5)
    return G, c, beta0, G @ beta0, \
        torch.diagonal(G, dim1=1, dim2=2).contiguous()


def block_lane_head_inputs(S, T, n, p, dev, seed):
    """K3bl inputs: Xt [p, n], R [n, S*T] (raw-gradient scale, lane-major),
    beta [S, p, T] with 30% of each lane's rows nonzero, L, an offset."""
    import torch
    g = torch.Generator(device=dev).manual_seed(seed)
    f64 = dict(generator=g, device=dev, dtype=torch.float64)
    Xt = torch.randn(p, n, **f64)
    R = torch.randn(n, S * T, **f64) / n ** 0.5
    beta = 0.2 * torch.randn(S, p, T, **f64) * \
        (torch.rand(S, p, 1, **f64) < 0.3)
    L = torch.sum(Xt * Xt, dim=1) / n
    return Xt, R, beta, L, 0.01 * torch.randn(p, **f64)


def _same_all(a, b):
    import torch
    return all(bool(torch.equal(x, y)) for x, y in zip(a, b))


def check_mt_lane_kernels(dev, cfg, errs, small, sparse_design):
    """K3bl, K1bl and K5b at the lanes' S*T columns against their plain
    versions; updates `errs`, returns the failures. K3bl at every (S, T,
    n, p, ws) of the config (S*T of 200, 500, an odd 91 with an odd n
    and a ragged tile, and 25), BlockL1 and BlockMCP (the fixed-point
    score on the first shape), a parameter row a lane, shared memory
    NaN-filled first: scores within 1e-12 + 1e-12 |ref|, gradient within
    1e-12 + 1e-10 |ref|, cand_idx exact, each lane's working set
    ``select_working_set`` of its plain scores and its rows bit for bit,
    and a second launch equal to the first bit for bit.
    K1bl at every (S, K, T) (one CTA, the cluster with q's rows in shared
    and in global memory), every third lane frozen: bit for bit lane by
    lane against K1b on that lane's inputs, frozen lanes unchanged, within
    K1's bound of the plain version. K5b at R = 100 and 500 columns on the
    small design (bit for bit against ``emulate``) and at 100 on the
    full-size one, within K5's bound and deterministic."""
    import torch
    from repro_torch.core.working_set import (candidate_columns,
                                              select_working_set)
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              fill_shared_memory_cuda,
                                              gram_block_plan)
    from repro_torch.kernels.csc_score import csc_score_plain, emulate
    from repro_torch.kernels.fused_ws import fused_ws_block_lanes_plain
    fails = []
    for k in ("fused_ws_block_lanes", "cd_epoch_gram_block_lanes"):
        errs[k] = 0.0

    def fill():
        if dev.type == "cuda":
            fill_shared_memory_cuda(dev)

    t = time.perf_counter()
    for i, (S, T, n, p, ws) in enumerate(cfg["k3bl"]):
        Xt, R, beta, L, off = block_lane_head_inputs(S, T, n, p, dev,
                                                     seed=S * T)
        gs = torch.linalg.vector_norm(beta, dim=2) != 0
        for pen in block_pens():
            prm = lane_rows(pen, S, dev, seed=S + T)
            for fp in (False, True) if i == 0 else (False,):
                tag = f"K3bl S={S} T={T} n={n} p={p} ws={ws} " \
                      f"{type(pen).__name__} fp={fp}"
                args = (Xt, R, beta, L.expand(S, p), off, gs, type(pen), prm,
                        ws)
                fill()
                sk, gk, ik, wk, xk = ops.fused_ws_block_lanes(*args,
                                                              use_fp=fp)
                fill()
                again = _same_all(ops.fused_ws_block_lanes(*args, use_fp=fp),
                                  (sk, gk, ik, wk, xk))
                sr, gr, ir, cr = fused_ws_block_lanes_plain(*args, use_fp=fp)
                ok1, e1 = close(sk, sr, 1e-12, 1e-12)
                ok2, e2 = close(gk, gr, 1e-12, 1e-10)
                errs["fused_ws_block_lanes"] = max(
                    errs["fused_ws_block_lanes"], e1, e2)
                same = bool(torch.equal(ik, ir)) and all(
                    torch.equal(wk[s], select_working_set(sr[s], gs[s], ws))
                    and torch.equal(xk[s], candidate_columns(
                        ir[s], cr[s], wk[s], p).T) for s in range(S))
                del cr
                if not (ok1 and ok2 and same and again):
                    fails.append(f"{tag} scores={e1:.3e} grad={e2:.3e} "
                                 f"candidates, working sets and rows equal "
                                 f"{same}, a second launch bit for bit "
                                 f"{again}")
        del Xt, R
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"  K3bl checks: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    for S, K, T in cfg["k1bl"]:
        G, c, beta0, q0, L = block_lane_inputs(S, K, T, dev, seed=K + T)
        active = lane_mask(S, dev)
        branch = gram_block_plan(K, T, torch.float64).branch
        for pen in block_pens():
            tag = f"K1bl S={S} K={K} T={T} {type(pen).__name__} ({branch})"
            prm = lane_rows(pen, S, dev, seed=S + K)
            fill()
            b, q = ops.cd_epoch_gram_block_lanes(G, c, beta0, q0, L,
                                                 type(pen), prm, active,
                                                 epochs=2)
            same = True
            for s in range(S):
                if not bool(active[s]):
                    same &= bool(torch.equal(b[s], beta0[s])
                                 and torch.equal(q[s], q0[s]))
                    continue
                fill()
                bs, qs = ops.cd_epoch_gram_block(G[s], c[s], beta0[s], q0[s],
                                                 L[s], type(pen), prm[s],
                                                 epochs=2)
                same &= bool(torch.equal(b[s], bs) and torch.equal(q[s], qs))
            moved = bool(torch.any(b[0] != beta0[0]))
            bp, qp = cd_epoch_gram_plain(G[0], c[0], beta0[0], q0[0], L[0],
                                         type(pen), prm[0], epochs=2)
            ok1, e1 = close(b[0], bp, 1e-12, 1e-5)
            ok2, e2 = close(q[0], qp, 1e-12, 1e-5)
            errs["cd_epoch_gram_block_lanes"] = max(
                errs["cd_epoch_gram_block_lanes"], e1, e2)
            if not (same and moved and ok1 and ok2):
                fails.append(f"{tag}: K1b bit for bit lane by lane {same}, "
                             f"moved {moved}, plain err {max(e1, e2):.3e}")
        del G
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    log(f"  K1bl checks: {time.perf_counter() - t:.1f} s")

    t = time.perf_counter()
    for label, d, widths in (("small", small, cfg["k5b_lane_T"]),
                             ("sparse_fig2", sparse_design,
                              cfg["k5b_lane_T"][:1])):
        for T in widths:
            g = torch.Generator(device=dev).manual_seed(T)
            raw = torch.randn(d.n_rows, T, generator=g, device=dev,
                              dtype=torch.float64)
            args = (d.data, d.indices, d.col_ids, d.indptr)
            fill()
            k = ops.csc_score_block(*args, raw)
            ok, e = close(k, csc_score_plain(*args, raw), 1e-12, 1e-12)
            same = bool(torch.equal(k, ops.csc_score_block(*args, raw)))
            if label == "small":
                same = same and bool(torch.equal(k, emulate(
                    d.data, d.indices, d.indptr, raw)))
            errs["csc_score_block"] = max(errs["csc_score_block"], e)
            if not (ok and same):
                fails.append(f"K5b {label} R={T} columns err={e:.3e} "
                             f"deterministic (and as emulated) {same}")
    log(f"  K5b at the lanes' widths: {time.perf_counter() - t:.1f} s")
    if dev.type == "cuda":
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
    return fails


def check_block_emulation(dev, cfg, errs):
    """K1bl at every (S, K, T) of the config and K1b at its one-CTA shapes
    of ``k1b_shapes``, BlockL1 and BlockMCP, 2 epochs, a parameter row a
    lane, every third lane frozen, row 1's L set to 0, every SM's shared
    memory NaN-filled before each launch: beta and q bit for bit against
    ``emulate_block_epoch`` (the kernel's arithmetic order; frozen lanes
    unchanged). Returns the failures."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (emulate_block_epoch,
                                              fill_shared_memory_cuda,
                                              gram_block_plan)
    fails = []
    t = time.perf_counter()
    errs.setdefault("cd_epoch_gram_block", 0.0)
    errs.setdefault("cd_epoch_gram_block_lanes", 0.0)
    singles = [(K, T) for K, T in cfg["k1b_shapes"]
               if gram_block_plan(K, T, torch.float64).cluster == 1]
    cases = [(S, K, T, True) for S, K, T in cfg["k1bl"]] + \
        [(1, K, T, False) for K, T in singles]
    for S, K, T, lanes in cases:
        G, c, beta0, q0, L = block_lane_inputs(S, K, T, dev, seed=K + 7 * T)
        L[:, 1 % K] = 0.0
        active = lane_mask(S, dev)
        branch = gram_block_plan(K, T, torch.float64).branch
        for pen in block_pens():
            prm = lane_rows(pen, S, dev, seed=K + T)
            if dev.type == "cuda":
                fill_shared_memory_cuda(dev)
            if lanes:
                name = "cd_epoch_gram_block_lanes"
                got = ops.cd_epoch_gram_block_lanes(G, c, beta0, q0, L,
                                                    type(pen), prm, active,
                                                    epochs=2)
                want = emulate_block_epoch(G, c, beta0, q0, L, type(pen),
                                           prm, epochs=2, active=active)
            else:
                name = "cd_epoch_gram_block"
                got = ops.cd_epoch_gram_block(G[0], c[0], beta0[0], q0[0],
                                              L[0], type(pen), prm[0],
                                              epochs=2)
                want = emulate_block_epoch(G[0], c[0], beta0[0], q0[0], L[0],
                                           type(pen), prm[0], epochs=2)
            same = _same_all(got, want)
            e = max(close(a, b, 0, 0)[1] for a, b in zip(got, want))
            errs[name] = max(errs[name], e)
            if not same:
                fails.append(f"{'K1bl' if lanes else 'K1b'} S={S} K={K} T={T} "
                             f"{type(pen).__name__} ({branch}): not bit for "
                             f"bit the emulation, max |diff| {e:.3e}")
        del G
    log(f"  K1b / K1bl against emulate_block_epoch at {len(cases)} shapes: "
        f"{len(fails)} failures ({time.perf_counter() - t:.1f} s)")
    return fails


def mt_lane_phase(dev, cfg, sparse_design, sparse_Y, card):
    """The multitask lanes at full width on the kernel route, each held to
    ``capture=False`` bit for bit with one read a dispatch and each step
    key captured once: (m1) ``cross_val_path`` with BlockL1 and BlockMCP
    on the M/EEG leadfield at MEG width (10 lanes: K3bl at S*T = 500, K1bl
    at T = 50), folds 0 and 1 of the BlockL1 grid against the sequential
    multitask path on their rows; (m2) a chunked MultiTaskLasso path on
    ``make_multitask(10000, 20000, 20)`` (5 lanes) against the sequential
    path; (m3) a multitask grid on ``sparse_fig2`` with T = 20 (K5b at
    S*T = 100, K1bl, K5s once a fold), unweighted and weighted; (m4) a
    small multitask grid on both routes. Returns (launch counts of the
    captured kernel-route runs, walls, failures)."""
    import numpy as np
    import torch
    from repro_torch.core import (BlockL1, BlockMCP, MultitaskQuadratic,
                                  cross_val_path, lambda_max, make_engine,
                                  reg_path)
    from repro_torch.core.engine import DenseDesign
    from repro_torch.data import make_leadfield, make_multitask
    total = dict.fromkeys(all_counts(), 0)
    fails, walls = [], {}
    held = functools.partial(grid_held, fails=fails)
    scalar = ("fused_ws_lanes", "cd_epoch_gram_lanes", "cd_epoch_xb_lanes",
              "fused_ws", "cd_epoch_gram", "fused_ws_block",
              "cd_epoch_gram_block", "csc_score")
    df = MultitaskQuadratic()

    def need(label, counts, kernels):
        grid_needs(label, counts, kernels, fails=fails, absent=scalar)

    def eager(pen):
        return make_engine(pen, df, device=dev, capture=False)

    def geom(lmax, c):
        return lmax * np.geomspace(1.0, c["ratio"], c["n_lambdas"])

    # (m1) the M/EEG leadfield at MEG width: 10 lanes, S*T = 500
    c = cfg["m1"]
    X, Y, _, _ = make_leadfield(**cfg["meeg"])
    design = DenseDesign.from_dense(X, dev)
    kw = dict(cv=c["cv"], lambdas=geom(lambda_max(design, Y, df, device=dev),
                                       c),
              vmap_chunk=c["vmap_chunk"], tol=TOL)
    for pen in (BlockL1(1.0), BlockMCP(1.0, 3.0)):
        name = type(pen).__name__
        label = f"grid (m1) {name}"
        log(f"{label}: cross_val_path(cv={c['cv']}, n_lambdas="
            f"{c['n_lambdas']}, ratio {c['ratio']}, vmap_chunk="
            f"{c['vmap_chunk']}) on the M/EEG leadfield {cfg['meeg']} on "
            f"{card}")
        k, counts, walls[f"m1-{name}"] = run_grid("kernels", lambda: (
            cross_val_path(design, Y, df, pen, device=dev, **kw)), dev, total)
        need(label, counts, ("fused_ws_block_lanes",
                             "cd_epoch_gram_block_lanes"))
        o, _, _ = run_grid("oracle ", lambda: cross_val_path(
            design, Y, df, pen, engine=eager(pen), **kw), dev)
        held(label, k, o, TOL)
        if name != "BlockL1":
            continue
        for f in range(c["folds"]):
            keep = k.fold_weights[f] > 0
            sub, _ = run_path(f"fold {f} rows, sequential", lambda: reg_path(
                X[keep], Y[keep], BlockL1(1.0), df, lambdas=k.lambdas,
                tol=TOL, device=dev), dev)
            diff = float(np.max(np.abs(sub.betas - k.betas[f])))
            log(f"  {label} fold {f} vs its row-subset path: max |diff| "
                f"{diff:.3e} (bound 1e-5: two solves each at kkt <= {TOL})")
            if not diff <= 1e-5:
                fails.append(f"{label} fold {f}: {diff:.3e} from its path")
    del design

    # (m2) a chunked MultiTaskLasso path on make_multitask, 5 lanes
    c = cfg["m2"]
    X, Y, _ = make_multitask(**cfg["mt_dense"])
    design = DenseDesign.from_dense(X, dev)
    del X
    label = "path (m2)"
    lams = geom(lambda_max(design, Y, df, device=dev), c)
    kw = dict(lambdas=lams, tol=TOL)
    log(f"{label}: reg_path(BlockL1, n_lambdas={c['n_lambdas']}, ratio "
        f"{c['ratio']}, vmap_chunk={c['vmap_chunk']}) on make_multitask "
        f"{cfg['mt_dense']} on {card}")
    eng = make_engine(BlockL1(1.0), df, device=dev)
    pk, walls["m2"] = run_path("kernels", lambda: reg_path(
        design, Y, BlockL1(1.0), df, engine=eng, vmap_chunk=c["vmap_chunk"],
        **kw), dev, total)
    counts = all_counts()
    need(label, counts, ("fused_ws_block_lanes", "cd_epoch_gram_block_lanes"))
    one_read = eng.n_chunk_reads == eng.n_dispatches
    eng.release_graphs()
    po, _ = run_path("oracle ", lambda: reg_path(
        design, Y, BlockL1(1.0), df, engine=eager(BlockL1(1.0)),
        vmap_chunk=c["vmap_chunk"], **kw), dev)
    ps, _ = run_path("sequential", lambda: reg_path(
        design, Y, BlockL1(1.0), df, device=dev, **kw), dev)
    path_keys_once(label, pk, fails)
    same = bool(np.array_equal(pk.betas, po.betas)
                and np.array_equal(pk.n_epochs, po.n_epochs))
    diff = float(np.max(np.abs(pk.betas - ps.betas)))
    conv = bool(np.all(pk.kkts <= TOL) and np.all(ps.kkts <= TOL))
    log(f"  {label}: == capture=False bit for bit {same}; one read a "
        f"dispatch {one_read}; every lambda kkt <= {TOL} {conv}; max |diff| "
        f"from the sequential path {diff:.3e} (bound 1e-6)")
    if not (same and one_read and conv and diff <= 1e-6):
        fails.append(f"{label}: bit for bit {same}, one read {one_read}, "
                     f"converged {conv}, {diff:.3e} from the sequential "
                     f"path")
    del design
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    # (m3) sparse_fig2 with T = 20: 5 lanes, K5b at S*T = 100 columns. The
    # lambdas are made once: lambda_max's plain CSC score pass adds with
    # atomics on the card, so two grids' lambdas can differ in the last bit
    c = cfg["m3"]
    w = np.random.default_rng(1).uniform(0.5, 1.5, sparse_design.n_rows)
    for sw in (None, w):
        label = "grid (m3)" + (" weighted" if sw is not None else "")
        kw = dict(cv=c["cv"], vmap_chunk=c["vmap_chunk"], tol=TOL,
                  sample_weight=sw, lambdas=geom(lambda_max(
                      sparse_design, sparse_Y, df, sample_weight=sw,
                      device=dev), c))
        log(f"{label}: cross_val_path(BlockL1, cv={c['cv']}, n_lambdas="
            f"{c['n_lambdas']}, ratio {c['ratio']}, vmap_chunk="
            f"{c['vmap_chunk']}) on sparse_fig2, T={sparse_Y.shape[1]} on "
            f"{card}")
        k, counts, walls["m3" if sw is None else "m3-weighted"] = run_grid(
            "kernels", lambda: cross_val_path(
                sparse_design, sparse_Y, df, BlockL1(1.0), device=dev, **kw),
            dev, total)
        need(label, counts, ("csc_score_block", "cd_epoch_gram_block_lanes",
                             "csc_weighted_col_sq"))
        if counts["csc_weighted_col_sq"] != c["cv"]:
            fails.append(f"{label}: K5s launched "
                         f"{counts['csc_weighted_col_sq']} times, not once "
                         f"a fold")
        o, _, _ = run_grid("oracle ", lambda: cross_val_path(
            sparse_design, sparse_Y, df, BlockL1(1.0),
            engine=eager(BlockL1(1.0)), **kw), dev)
        held(label, k, o, TOL)

    # (m4) a small multitask grid, both routes
    c = cfg["m4"]
    X, Y, _ = make_multitask(n=c["n"], p=c["p"], n_tasks=c["T"],
                             n_nonzero=c["n_nonzero"], seed=c["seed"])
    design = DenseDesign.from_dense(X, dev)
    kw = dict(n_lambdas=c["n_lambdas"], cv=c["cv"], tol=c["tol"],
              vmap_chunk=c["vmap_chunk"])
    label = "grid (m4)"
    log(f"{label}: cross_val_path(BlockL1, {kw}) on make_multitask({c['n']}"
        f" x {c['p']}, T={c['T']}) on {card}")
    # BlockL1: the plain route's per-coordinate epochs took 341 s on the
    # H100 for BlockMCP's 1570 lane epochs at this tol
    pen = BlockL1(1.0)
    k, counts, walls["m4"] = run_grid("kernels", lambda: cross_val_path(
        design, Y, df, pen, device=dev, **kw), dev, total)
    need(label, counts, ("fused_ws_block_lanes", "cd_epoch_gram_block_lanes"))
    o, _, _ = run_grid("oracle ", lambda: cross_val_path(
        design, Y, df, pen, engine=eager(pen), **kw), dev)
    held(label, k, o, c["tol"])
    pl, _, _ = run_grid("plain  ", lambda: cross_val_path(
        design, Y, df, pen, device=dev, use_kernels=False, **kw), dev)
    diff = float(np.max(np.abs(pl.betas - k.betas)))
    log(f"  {label} plain route: max |diff| {diff:.3e} (bound 1e-6), max "
        f"kkt {float(np.max(pl.kkts)):.3e}")
    if not diff <= 1e-6 or not np.max(pl.kkts) <= c["tol"]:
        fails.append(f"{label} plain route: {diff:.3e} from the kernel "
                     f"route")
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    log(f"  lane epochs' launches by shape over (g1)-(g4) and (m1)-(m4): "
        f"{json.dumps(SHAPES)}")
    return total, walls, fails


def product_launches(fn, dev):
    """The float64 product's launches (``block_mma_kernel`` or
    ``wide_mma_kernel``) in one call of `fn`, counted by ``torch.profiler``
    from the kernels that call ran (None in the CPU rehearsal). On the card
    a profile with no kernel in it raises: the count is a check."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    if dev.type != "cuda":
        return None
    fn()                        # the plan and the libraries before the count
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    kernels = [e for e in prof.key_averages()
               if getattr(e, "self_device_time_total", 0) > 0]
    if not kernels:
        raise RuntimeError("torch.profiler saw no kernel: the product's "
                           "launches a call were not counted")
    return sum(e.count for e in kernels if "mma_kernel" in e.key)


def product_fields(Xt, N):
    """The float64 product's launch on Xt's card at N columns
    (``card_product_plan``): its kernel, sample spans and scratch bytes;
    None each in the CPU rehearsal, where no product runs."""
    from repro_torch.kernels.fused_ws import card_product_plan
    if Xt.device.type != "cuda":
        return dict(product=None, product_spans=None, scratch_bytes=None)
    plan = card_product_plan(Xt, N)
    return dict(product=plan.name, product_spans=plan.spans,
                scratch_bytes=8 * plan.scratch)


def mt_lane_times(dev, cfg, launches, errs, card):
    """The rows of K3bl and K1bl at S = 10 lanes: K3bl at K3b's row shape
    (n = 10,000, p = 20,000, T = 20, ws = 512) beside ten K3b heads on the
    lanes' slices, with torch.mm(Xt, R) at S*T columns as its library call
    (the gradient part only), and at the leadfield's (S*T = 500); K1bl at
    each (S, K, T) of ``k1bl_time`` (BlockL1, 1 epoch: the one-CTA lanes
    of (m1) and (m4), eager and replayed from a graph, and the cluster at
    K = 1024, T = 20) beside S K1b launches (K1b's own rows are in the
    block rows). Bounds: K3bl X, R, beta, L and gsupp read once, grad,
    scores and ws written, the S ws rows read and written (the gather), 2
    p n S T operations; K1bl S times K1b's bytes and operations (chain
    floor: K1b's cluster barriers or its one-CTA chain floor, times the
    waves of lanes the card runs at once). Beside K3bl's rows: its product
    launches a call (``product_launches``) and the plan's scratch
    bytes."""
    import torch
    from repro_torch.core.penalties import BlockL1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_block_lanes_plain,
                                              gram_block_plan)
    from repro_torch.kernels.fused_ws import (fused_ws_block_lanes_plain,
                                              pick_bp)
    reps = cfg["reps"]
    c = cfg["mt_lane_time"]
    S = c["S"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count \
        if dev.type == "cuda" else 1
    rows = []

    def head_row(T, n, p, ws, seed):
        Xt, R, beta, L, off = block_lane_head_inputs(S, T, n, p, dev, seed)
        gs = torch.linalg.vector_norm(beta, dim=2) != 0
        prm = lane_rows(BlockL1(0.11), S, dev, seed=seed)
        args = (Xt, R, beta, L.expand(S, p), off, gs, BlockL1, prm, ws)
        ms = time_ms(lambda: ops.fused_ws_block_lanes(*args), dev, reps)
        Rs = [R[:, s * T:(s + 1) * T].contiguous() for s in range(S)]
        ten = time_ms(lambda: [ops.fused_ws_block(Xt, Rs[s], beta[s], L, off,
                                                  gs[s], BlockL1, prm[s], ws)
                               for s in range(S)], dev, reps)
        plain = time_ms(lambda: fused_ws_block_lanes_plain(*args), dev, 1)
        lib = time_ms(lambda: torch.mm(Xt, R), dev, reps)
        bp = pick_bp(p)
        C = -(-p // bp) * min(bp, ws)
        b = bound(8 * (p * n + n * S * T + 2 * S * p * T + 2 * S * p + 2 * p
                       + S * ws + 2 * S * ws * n) + S * p + 4 * S * C,
                  2 * p * n * S * T)
        count = product_launches(lambda: ops.fused_ws_block_lanes(*args),
                                 dev)
        prod = dict(product_launches=count, **product_fields(Xt, S * T))
        if dev.type == "cuda" and count != 1:
            raise RuntimeError(f"K3bl at S*T = {S * T}: {count} product "
                               f"launches in one call, not 1")
        del Xt, R
        return ms, ten, plain, lib, b, bp, prod

    ms, ten, plain, lib, b, bp, prod = head_row(
        c["T"], cfg["k3b"]["n"], cfg["k3b"]["p"], c["ws"], 21)
    m = cfg["meeg"]
    n_m, p_m, T_m = m["n"], 2 * m["p_per_hemi"], m["T"]
    ws_m = min(1024, p_m)
    ms_m, ten_m, plain_m, lib_m, b_m, _, prod_m = head_row(T_m, n_m, p_m,
                                                           ws_m, 22)
    rows.append(dict(
        name="fused_ws_block_lanes", route="cuda",
        source="src/repro_torch/csrc/fused_ws.cu",
        replaces="src/repro/kernels/fused_ws.py:71",
        launches=launches["fused_ws_block_lanes"],
        max_abs_err=errs["fused_ws_block_lanes"], ms=ms, plain_ms=plain,
        bound_ms=b[0], bound_by=b[1], library_ms=lib,
        library_call="torch.mm(Xt, R) at S*T columns: the gradient part "
                     "only",
        ten_single_ms=ten,
        shape=f"S={S} lanes, T={c['T']}, n={cfg['k3b']['n']}, "
              f"p={cfg['k3b']['p']}, ws={c['ws']}, bp={bp}, BlockL1 (lam a "
              f"lane)", **prod,
        leadfield=dict(shape=f"S={S}, T={T_m}, n={n_m}, p={p_m}, ws={ws_m}",
                       ms=ms_m, ten_single_ms=ten_m, plain_ms=plain_m,
                       library_ms=lib_m, bound_ms=b_m[0],
                       bound_by=b_m[1], **prod_m)))
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    for Sl, K, T in cfg["k1bl_time"]:
        G, cc, beta0, q0, L = block_lane_inputs(Sl, K, T, dev, seed=K)
        prm = lane_rows(BlockL1(0.11), Sl, dev, seed=1)
        on = torch.ones(Sl, dtype=torch.bool, device=dev)
        args = (G, cc, beta0, q0, L, BlockL1, prm, on)
        ms = time_ms(lambda: ops.cd_epoch_gram_block_lanes(*args), dev, reps)
        plan = gram_block_plan(K, T, torch.float64)
        graph = graph_ms(lambda: ops.cd_epoch_gram_block_lanes(*args), dev,
                         reps) if plan.cluster == 1 else None
        ten = time_ms(lambda: [ops.cd_epoch_gram_block(
            G[s], cc[s], beta0[s], q0[s], L[s], BlockL1, prm[s])
            for s in range(Sl)], dev, reps)
        plain = time_ms(lambda: cd_epoch_gram_block_lanes_plain(*args), dev,
                        1)
        moved = int(torch.sum(torch.any(
            ops.cd_epoch_gram_block_lanes(*args)[0] != beta0, dim=2)))
        b = bound(8 * (moved * K + Sl * (5 * K * T + K)), 2 * moved * K * T)
        # the lanes' waves: one CTA a lane places a lane an SM at least
        waves = -(-Sl // max(1, sms // plan.cluster))
        row = dict(
            name="cd_epoch_gram_block_lanes", route="cuda",
            source="src/repro_torch/csrc/cd_epoch.cu",
            replaces="src/repro/core/cd.py:66 (jax epoch under the "
                     "reference's vmap; no TPU kernel)",
            launches=launches["cd_epoch_gram_block_lanes"],
            max_abs_err=errs["cd_epoch_gram_block_lanes"], ms=ms,
            graph_ms=graph, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
            library_ms=None, library_call="none: no single call",
            ten_single_ms=ten,
            shape=f"S={Sl} lanes, K={K}, T={T}, epochs=1, BlockL1 (lam a "
                  f"lane), {moved} rows moved",
            lane_waves=waves, **plan_fields(dev, "cd_epoch_gram_block_lanes",
                                            plan, K, launches, T=T))
        if row["chain_floor_ms"] is not None:
            row["chain_floor_ms"] *= waves
        rows.append(row)
        del G
    log_rows(rows, card)
    for row in rows:
        log(f"  {row['name']} [{row['shape']}]: one lane launch "
            f"{row['ms']:.4f} ms (from a graph {row.get('graph_ms')}) "
            f"against its single-lane launches {row['ten_single_ms']:.4f} ms "
            f"on {card}")
    lf = rows[0]["leadfield"]
    log(f"  fused_ws_block_lanes at the leadfield [{lf['shape']}]: kernel "
        f"{lf['ms']:.4f} ms, {S} K3b heads {lf['ten_single_ms']:.4f} ms, "
        f"plain {lf['plain_ms']:.4f} ms, bound {lf['bound_ms']:.4f} ms "
        f"({lf['bound_by']}), library {lf['library_ms']:.4f} ms on {card}")
    for label, r in (("row", rows[0]), ("leadfield", lf)):
        log(f"  fused_ws_block_lanes {label}: product launches a call "
            f"{r['product_launches']} (counted by torch.profiler over one "
            f"call; None: the CPU rehearsal), {r['product']}, "
            f"{r['product_spans']} sample span(s), scratch "
            f"{r['scratch_bytes']} bytes")
    return rows


# ------------------------------------------------------------------- times
_FLOOR_US = {}


def plan_fields(dev, name, plan, K, launches, T=None):
    """A K2 or K1b row's branch, cluster size, threads, main-path launches
    by branch, and chain floor (one epoch): on a cluster K cluster-barrier
    round trips (measured once per cluster size and thread count); on K1b's
    one CTA (with T) K steps of ``gram_block_chain_floor_cuda``: a T-wide
    norm by the kernel's shuffle tree, a sqrt and a divide, and its
    hand-off, with no loads."""
    from repro_torch.kernels.cd_epoch import (BRANCHES,
                                              gram_block_chain_floor_cuda)
    floor = None
    if plan.cluster > 1 and dev.type == "cuda":
        key = (plan.cluster, plan.threads)
        if key not in _FLOOR_US:
            _FLOOR_US[key] = chain_floor_us(dev, *key, 10_000)
        floor = _FLOOR_US[key] * K / 1e3
    elif T is not None and dev.type == "cuda":
        epochs = max(1, 200_000 // K)
        floor = time_ms(lambda: gram_block_chain_floor_cuda(
            K, T, epochs, plan.threads, dev), dev, 3) / epochs
    extra = {} if plan.cluster > 1 else dict(
        owners=plan.owners, per=plan.per, g_whole=plan.g_whole,
        smem_bytes=plan.dyn_bytes)
    return dict(branch=plan.branch, cluster=plan.cluster,
                threads=plan.threads, chain_floor_ms=floor, **extra,
                launches_by_branch={b: launches[f"{name}/{b}"]
                                    for b in BRANCHES})


def gram_row(dev, K, launches, errs, reps):
    """K1's row at K: one L1 epoch on `gram_inputs` (every coordinate
    moves); bound: the moved columns of G, c, L, beta0, q0 read and beta, q
    written once, 2 K operations per moved coordinate; chain floor: K chain
    steps of a shuffle and a multiply-add with a handoff every 32 on one
    CTA of the plan's threads (a launch of that chain alone, over enough
    epochs to spread the launch)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (BRANCHES, cd_epoch_gram_plain,
                                              gram_chain_floor_cuda,
                                              gram_plan)
    from repro_torch.kernels.common import penalty_params
    G, c, beta0, q0, L = gram_inputs(K, dev, seed=K)
    args = (G, c, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
    ms = time_ms(lambda: ops.cd_epoch_gram(*args), dev, reps)
    plain = time_ms(lambda: cd_epoch_gram_plain(*args), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_gram(*args)[0] != beta0))
    b = bound(8 * (moved * K + 6 * K), 2 * moved * K)
    plan = gram_plan(K, torch.float64)
    floor = None
    if dev.type == "cuda":
        epochs = max(1, 200_000 // K)
        floor = time_ms(lambda: gram_chain_floor_cuda(K, epochs, plan.threads,
                                                      dev), dev, 3) / epochs
    return dict(name="cd_epoch_gram", route="cuda",
                source="src/repro_torch/csrc/cd_epoch.cu",
                replaces="src/repro/kernels/cd_epoch.py:52",
                launches=launches["cd_epoch_gram"],
                max_abs_err=errs["cd_epoch_gram"], ms=ms, plain_ms=plain,
                bound_ms=b[0], bound_by=b[1], library_ms=None,
                library_call="none: no single call",
                shape=f"K={K}, epochs=1, L1, {moved} coordinates moved",
                branch=plan.branch, cluster=plan.cluster,
                threads=plan.threads, chain_floor_ms=floor,
                launches_by_branch={br: launches[f"cd_epoch_gram/{br}"]
                                    for br in BRANCHES})


def xb_row(dev, K, n, weighted, lam, seed, launches, errs, reps):
    """K2's row at (K, n): logistic, 1 epoch, L1(lam); bound: X_ws, y,
    (w), Xb0 read and Xb written once; 2 K n operations for the dot
    products and 4 n per moved coordinate (axpy and raw update)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import cd_epoch_xb_plain, xb_plan
    from repro_torch.kernels.common import penalty_params
    Xt, y, w, beta0, Xb0, L, off = xb_inputs(K, n, "logistic", dev,
                                             seed=seed)
    wt = w if weighted else None
    args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(lam), dev),
            "logistic")
    ms = time_ms(lambda: ops.cd_epoch_xb(*args, w=wt), dev, reps)
    plain = time_ms(lambda: cd_epoch_xb_plain(*args, w=wt), dev, 1)
    moved = int(torch.sum(ops.cd_epoch_xb(*args, w=wt)[0] != beta0))
    b = bound(8 * (K * n + (4 if weighted else 3) * n + 5 * K),
              2 * K * n + 4 * moved * n)
    plan = xb_plan(n, weighted, torch.float64)
    return dict(name="cd_epoch_xb", route="cuda",
                source="src/repro_torch/csrc/cd_epoch.cu",
                replaces="src/repro/kernels/cd_epoch.py:128",
                launches=launches["cd_epoch_xb"],
                max_abs_err=errs["cd_epoch_xb"], ms=ms, plain_ms=plain,
                bound_ms=b[0], bound_by=b[1], library_ms=None,
                library_call="none: no single call",
                shape=f"K={K}, n={n}, logistic, "
                      f"{'weighted, ' if weighted else ''}epochs=1, "
                      f"L1({lam}), {moved} coordinates moved",
                **plan_fields(dev, "cd_epoch_xb", plan, K, launches))


def kernel_times(dev, cfg, launches, errs, card, sparse_design):
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import penalty_params
    from repro_torch.core.working_set import select_working_set
    from repro_torch.kernels.fused_ws import (fused_ws_plain, merge_cuda,
                                              pick_bp, score_cuda,
                                              select_cuda)
    reps = cfg["reps"]
    pen = L1(0.11)
    prm = penalty_params(pen, dev)
    rows = []

    for K in cfg["k1_time_K"]:
        rows.append(gram_row(dev, K, launches, errs, reps))
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    rows.append(xb_row(dev, cfg["k2_K"], cfg["k2_n"], False, 0.07, 7,
                       launches, errs, reps))

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=3)
    gs = pen.generalized_support(beta)
    for ws_size in cfg["k3_ws"]:
        args = (Xt, r, beta, L, off, gs, L1, prm, ws_size)
        ms = time_ms(lambda: ops.fused_ws(*args), dev, reps)
        plain = time_ms(lambda: fused_ws_plain(*args), dev, 3)
        lib = time_ms(lambda: torch.mv(Xt, r), dev, reps)
        bp = pick_bp(p)
        kc = min(bp, ws_size)
        C = -(-p // bp) * kc
        # X, r, beta, L, offset and gsupp read once; scores, grad, cand_idx
        # and ws written; the K rows of X read and written once (the
        # gather; no candidate buffer)
        b = bound(8 * (p * n + n + 3 * p + 2 * p + ws_size
                       + 2 * ws_size * n) + p + 4 * C, 2 * p * n)
        split = {}
        if dev.type == "cuda":
            # the head and each of its parts alone, launched (eager) and as
            # a replayed CUDA graph (as the captured outer step runs them):
            # the score launch, the select launch, the merge launch (the working set), the
            # gather of its rows, and the stable sort that the merge
            # replaces (select_working_set)
            dprm = args[7]
            sc, _, pri = score_cuda(Xt, r, beta, L, off, L1, dprm, gsupp=gs)
            cidx = select_cuda(pri, bp, kc)
            wsel = merge_cuda(pri, cidx, bp, ws_size)
            parts = dict(
                head=lambda: ops.fused_ws(*args),
                score=lambda: score_cuda(Xt, r, beta, L, off, L1, dprm,
                                         gsupp=gs),
                select=lambda: select_cuda(pri, bp, kc),
                merge=lambda: merge_cuda(pri, cidx, bp, ws_size),
                gather=lambda: Xt.index_select(0, wsel),
                sort=lambda: select_working_set(sc, gs, ws_size))
            split = {k: dict(eager=time_ms(f, dev, reps),
                             graph=graph_ms(f, dev, reps))
                     for k, f in parts.items()}
        row = dict(name="fused_ws", route="cuda",
                   source="src/repro_torch/csrc/fused_ws.cu",
                   replaces="src/repro/kernels/fused_ws.py:125",
                   launches=launches["fused_ws"],
                   max_abs_err=errs["fused_ws"], ms=ms, plain_ms=plain,
                   bound_ms=b[0], bound_by=b[1], library_ms=lib,
                   library_call="torch.mv(Xt, r): the gradient part only",
                   split_ms=split,
                   shape=f"n={n}, p={p}, ws={ws_size}, bp={bp}, C={C}, L1")
        if ws_size == max(cfg["k3_ws"]):
            rows.append(row)
        else:
            log(f"K3 at ws={ws_size}: {json.dumps(row)}")
    del Xt
    rows += sparse_times(dev, cfg, launches, errs, sparse_design)
    log_rows(rows, card)
    log("K1, K1b and K2 are bound by the chain of dependent coordinate "
        "steps, not by bytes: their bound_ms is the byte/operation floor "
        "only; chain_floor_ms is, for K1, K chain steps (a shuffle and a "
        "multiply-add) with a handoff every 32, for K2 and K1b K "
        "cluster-barrier round trips on the row's cluster.")
    return rows


def log_rows(rows, card):
    for row in rows:
        extra = "" if "branch" not in row else (
            f", branch {row['branch']} (C={row['cluster']}), chain floor "
            f"{row['chain_floor_ms']} ms")
        if row.get("split_ms"):
            extra += f", split (ms) {json.dumps(row['split_ms'])}"
        if row.get("walk_floor_ms") is not None:
            extra += (f", floor of the CSC-walk design (its L2 gathers, "
                      f"not a bound of the function) "
                      f"{row['walk_floor_ms']:.4f} ms "
                      f"({row['l2_bytes'] / 1e9:.3f} GB of L2 reads)")
        log(f"time {row['name']} [{row['shape']}] on {card}: kernel "
            f"{row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, bound "
            f"{row['bound_ms']:.4f} ms ({row['bound_by']}){extra}, library "
            f"{row['library_ms']}")


def l2_floor(dev, rows, width, gathers, reps):
    """The time of `gathers` hashed gathers of raw's rows ([rows, width]
    float64, made on the card) through L2: ``l2_gather_probe`` timed
    (None without a card)."""
    import torch
    if dev.type != "cuda":
        return None
    from repro_torch.kernels.csc_score import l2_gather_probe_cuda
    buf = torch.rand(rows, width, dtype=torch.float64, device=dev)
    return time_ms(lambda: l2_gather_probe_cuda(buf, gathers), dev, reps)


def with_l2(row, floor, l2_bytes):
    """`row` with, beside its HBM byte bound (which stays its bound), the
    floor of its CSC-walk design: the L2 gathers of raw's rows that a walk
    of CSC columns makes (a design that blocks by rows could reuse raw on
    chip and move fewer)."""
    row.update(walk_floor_ms=floor, l2_bytes=l2_bytes)
    return row


def walk_layout(T):
    """A K5/K5b row's layout: the walk's lanes at T tasks."""
    from repro_torch.kernels.csc_score import lane_plan
    V, G, E = lane_plan(T)
    if T == 1:
        return f"CSC walk, {G} lanes a column, {32 // G} columns a warp"
    return (f"CSC walk, {G} lanes an entry, {V} values a lane, {E} entries "
            f"a warp iteration")


def sparse_times(dev, cfg, launches, errs, d):
    """The rows of K2 at the sparse fits' n = 50,000, weighted (K = 512 and
    the deep fit's 4096), K4 (dense, n x p of K3, weighted), K5 and K5s
    (the full-size sparse design)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.csc_score import csc_score_plain
    from repro_torch.kernels.ws_score import ws_score_plain
    reps = cfg["reps"]
    rows = []

    for K, n in cfg["k2_time"]:
        rows.append(xb_row(dev, K, n, True, 0.002, 9, launches, errs, 3))
        if dev.type == "cuda":
            torch.cuda.empty_cache()

    n, p = cfg["k3_n"], cfg["k3_p"]
    Xt, r, beta, L, off = fused_inputs(n, p, dev, seed=5)
    g = torch.Generator(device=dev).manual_seed(5)
    w = 2.0 * torch.rand(n, generator=g, device=dev, dtype=torch.float64)
    prm = penalty_params(L1(0.11), dev)
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
    layout = walk_layout(1)
    # the gathers of v through L2: one 32-byte sector an entry
    floor = l2_floor(dev, n, 1, nnz, reps)
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
        rows.append(with_l2(dict(name=name, route="cuda",
                         source="src/repro_torch/csrc/csc_score.cu",
                         replaces="src/repro/sparse/ops.py:156" if not square
                         else "src/repro/sparse/ops.py:201",
                         launches=launches[name], max_abs_err=errs[name],
                         ms=ms, plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                         library_ms=lib, library_call=call,
                         shape=f"n={n}, p={p}, nnz={nnz}, {layout}"
                               + (", square" if square else "")),
                            floor, 32 * nnz))
    return rows


def block_times(dev, cfg, launches, errs, card, d):
    """The rows of K3b, K5b (full-size sparse design) and K1b."""
    import torch
    from repro_torch.core.penalties import BlockL1
    from repro_torch.kernels import ops
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_plain,
                                              gram_block_plan)
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.csc_score import csc_score_plain
    from repro_torch.kernels.fused_ws import fused_ws_plain, pick_bp
    reps = cfg["reps"]
    pen = BlockL1(0.11)
    prm = penalty_params(pen, dev)
    rows = []

    c = cfg["k3b"]
    n, p, T, ws = c["n"], c["p"], c["T"], c["ws"]
    Xt, R, beta, L, off = block_inputs(n, p, T, dev, seed=13)
    gs = pen.generalized_support(beta)
    args = (Xt, R, beta, L, off, gs, BlockL1, prm, ws)
    ms = time_ms(lambda: ops.fused_ws_block(*args), dev, reps)
    plain = time_ms(lambda: fused_ws_plain(*args), dev, 3)
    lib = time_ms(lambda: torch.mm(Xt, R), dev, reps)
    bp = pick_bp(p)
    C = -(-p // bp) * min(bp, ws)
    # X, R and beta read once; grad, scores and the ws rows of X written
    # once (no candidate buffer); L, offset, gsupp, ws and cand_idx
    b = bound(8 * (p * n + n * T + 2 * p * T + 3 * p + ws * n + ws) + p
              + 4 * C, 2 * p * n * T)
    prod = product_fields(Xt, T)
    rows.append(dict(name="fused_ws_block", route="cuda",
                     source="src/repro_torch/csrc/fused_ws.cu",
                     replaces="src/repro/kernels/fused_ws.py:71",
                     launches=launches["fused_ws_block"],
                     max_abs_err=errs["fused_ws_block"], ms=ms,
                     plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                     library_ms=lib,
                     library_call="torch.mm(Xt, R): the gradient part only",
                     shape=f"n={n}, p={p}, T={T}, ws={ws}, bp={bp}, C={C}, "
                           f"BlockL1, product {prod['product']}, sample "
                           f"spans {prod['product_spans']}"))
    del Xt
    # the sub-row wider than 24 columns: the leadfield fits' T = 50
    w = cfg["k3b_wide"]
    n, p, T, ws = w["n"], w["p"], w["T"], w["ws"]
    Xt, R, beta, L, off = block_inputs(n, p, T, dev, seed=13)
    gs = pen.generalized_support(beta)
    args = (Xt, R, beta, L, off, gs, BlockL1, prm, ws)
    bp = pick_bp(p)
    C = -(-p // bp) * min(bp, ws)
    b = bound(8 * (p * n + n * T + 2 * p * T + 3 * p + ws * n + ws) + p
              + 4 * C, 2 * p * n * T)
    prod = product_fields(Xt, T)
    rows[-1]["leadfield"] = dict(
        shape=f"n={n}, p={p}, T={T}, ws={ws}, product {prod['product']}, "
              f"sample spans {prod['product_spans']}",
        ms=time_ms(lambda: ops.fused_ws_block(*args), dev, reps),
        plain_ms=time_ms(lambda: fused_ws_plain(*args), dev, 3),
        library_ms=time_ms(lambda: torch.mm(Xt, R), dev, reps),
        bound_ms=b[0], bound_by=b[1])
    log(f"  fused_ws_block at the leadfield [{rows[-1]['leadfield']}] on "
        f"{card}")
    del Xt

    n, p = d.shape
    nnz = d.nnz
    T = cfg["k5b_T"]
    g = torch.Generator(device=dev).manual_seed(17)
    raw = torch.randn(n, T, generator=g, device=dev, dtype=torch.float64)
    cargs = (d.data, d.indices, d.col_ids, d.indptr)
    ms = time_ms(lambda: ops.csc_score_block(*cargs, raw), dev, reps)
    plain = time_ms(lambda: csc_score_plain(*cargs, raw), dev, reps)
    # a yardstick only, never a route; a failure fails the run
    lib = None
    if dev.type == "cuda":
        A = torch.sparse_csr_tensor(d.indptr.to(torch.int32),
                                    d.indices[:nnz], d.data[:nnz],
                                    size=(p, n), check_invariants=True)
        lib = time_ms(lambda: A @ raw, dev, reps)
        del A
    b = bound(nnz * 12 + (p + 1) * 8 + n * T * 8 + p * T * 8, 2 * nnz * T)
    # the gathers of raw's rows through L2: T values an entry
    floor = l2_floor(dev, n, T, nnz, reps)
    rows.append(with_l2(dict(name="csc_score_block", route="cuda",
                     source="src/repro_torch/csrc/csc_score.cu",
                     replaces="src/repro/sparse/ops.py:156",
                     launches=launches["csc_score_block"],
                     max_abs_err=errs["csc_score_block"], ms=ms,
                     plain_ms=plain, bound_ms=b[0], bound_by=b[1],
                     library_ms=lib,
                     library_call="torch.sparse_csr_tensor(X^T) @ raw "
                                  "(cuSPARSE SpMM)",
                     shape=f"n={n}, p={p}, nnz={nnz}, T={T}, "
                           f"{walk_layout(T)}"),
                        floor, 8 * T * nnz))

    for K, T in [(K, cfg["k1b_T"]) for K in cfg["k1b_time_K"]] + \
            list(cfg["k1b_onecta_time"]):
        G, cc, beta0, q0, L = gram_block_inputs(K, T, dev, seed=K)
        args = (G, cc, beta0, q0, L, BlockL1, prm)
        ms = time_ms(lambda: ops.cd_epoch_gram_block(*args), dev, reps)
        plan = gram_block_plan(K, T, torch.float64)
        graph = graph_ms(lambda: ops.cd_epoch_gram_block(*args), dev, reps) \
            if plan.cluster == 1 else None
        plain = time_ms(lambda: cd_epoch_gram_plain(*args), dev, 1)
        moved = int(torch.sum(torch.any(
            ops.cd_epoch_gram_block(*args)[0] != beta0, dim=1)))
        b = bound(8 * (moved * K + 5 * K * T + K), 2 * moved * K * T)
        rows.append(dict(
            name="cd_epoch_gram_block", route="cuda",
            source="src/repro_torch/csrc/cd_epoch.cu",
            replaces="src/repro/core/cd.py:66 (jax epoch; no TPU kernel)",
            launches=launches["cd_epoch_gram_block"],
            max_abs_err=errs["cd_epoch_gram_block"], ms=ms,
            plain_ms=plain, bound_ms=b[0], bound_by=b[1],
            library_ms=None, library_call="none: no single call",
            shape=f"K={K}, T={T}, epochs=1, BlockL1, {moved} rows moved",
            graph_ms=graph,
            **plan_fields(dev, "cd_epoch_gram_block", plan, K, launches,
                          T=T)))
        del G
    log_rows(rows, card)
    return rows


def chain_floor_us(dev, C, threads, iters):
    """One cluster barrier's round trip in microseconds: a launch of
    `iters` barriers on one cluster of C CTAs, over `iters` (CUDA
    events, warm; the launch itself is spread over the iterations)."""
    from repro_torch.kernels.cd_epoch import cluster_barrier_cuda
    return time_ms(lambda: cluster_barrier_cuda(C, threads, iters, dev), dev,
                   3) * 1e3 / iters


def build_report():
    """Build every kernel source (nvcc, in parallel) and print the ptxas
    report: registers, shared memory and spills of each kernel."""
    from repro_torch.kernels._build import BUILD
    t = time.perf_counter()
    BUILD.build_all()
    log(f"build: {time.perf_counter() - t:.1f} s")
    for name, text in BUILD.logs.items():
        for line in text.splitlines():
            if any(k in line for k in ("registers", "spill", "error",
                                       "Compiling entry")):
                log(f"  [{name}] {line.strip()}")


def run(dev, cfg):
    """All phases on `dev`; returns (kernels rows, failures)."""
    import torch
    card = card_line() if dev.type == "cuda" else "cpu"
    log(f"device: {card}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    failures = []

    if dev.type == "cuda":
        build_report()

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
    t1 = time.perf_counter()
    fails += check_k1_blocked(dev, cfg, errs)
    log(f"  K1 blocked-kernel checks: {time.perf_counter() - t1:.1f} s")
    fails += check_k2_big_and_k4(dev, cfg, errs)
    fails += check_step_down(dev, cfg, errs)
    failures += fails
    report("dense kernels", t, fails,
           (("cd_epoch_gram", "K1"), ("cd_epoch_xb", "K2"),
            ("fused_ws", "K3"), ("ws_score", "K4")))

    t = time.perf_counter()
    launches, fails = main_path(dev, cfg)
    failures += fails
    log(f"dense main path ({time.perf_counter() - t:.1f} s): launches "
        f"{launches}")
    t = time.perf_counter()
    large_launches, fails = large_design(dev, cfg)
    failures += fails
    log(f"large dense design ({time.perf_counter() - t:.1f} s): launches "
        f"{large_launches}")
    for k in large_launches:
        launches[k] += large_launches[k]

    X_sparse, beta_true, design, y, small = sparse_designs(dev, cfg)
    t = time.perf_counter()
    fails = check_k5(dev, (("sparse_fig2", design), ("small", small)), errs)
    failures += fails
    report("sparse kernels", t, fails,
           (("csc_score", "K5"), ("csc_weighted_col_sq", "K5s")))
    t = time.perf_counter()
    sparse_launches, fails = sparse_path(dev, cfg, design, y)
    failures += fails
    log(f"sparse main path ({time.perf_counter() - t:.1f} s): launches "
        f"{sparse_launches}")
    for k in launches:
        launches[k] += sparse_launches[k]

    t = time.perf_counter()
    fails = check_block_kernels(dev, cfg, errs,
                                (("sparse_fig2", design), ("small", small)))
    failures += fails
    report("block kernels", t, fails,
           (("fused_ws_block", "K3b"), ("cd_epoch_gram_block", "K1b"),
            ("csc_score_block", "K5b")))
    t = time.perf_counter()
    Y_sparse = sparse_mt_target(X_sparse, beta_true, cfg["mt_sparse_T"])
    mt_launches, fails = multitask_path(dev, cfg, X_sparse, Y_sparse)
    failures += fails
    log(f"multitask path ({time.perf_counter() - t:.1f} s): launches "
        f"{mt_launches}")
    for k in launches:
        launches[k] += mt_launches[k]
    del X_sparse

    t = time.perf_counter()
    path_launches, fails = path_phase(dev, cfg, design, y)
    failures += fails
    log(f"paths ({time.perf_counter() - t:.1f} s): launches "
        f"{path_launches}")
    for f in fails:
        log(f"  FAIL {f}")
    for k in launches:
        launches[k] += path_launches[k]

    t = time.perf_counter()
    fails = check_lane_kernels(dev, cfg, errs)
    failures += fails
    report("lane kernels", t, fails,
           (("cd_epoch_gram_lanes", "K1l"), ("cd_epoch_xb_lanes", "K2l"),
            ("fused_ws_lanes", "K3l")))
    t = time.perf_counter()
    grid_launches, walls, fails = grid_phase(dev, cfg, design, y)
    failures += fails
    log(f"grids ({time.perf_counter() - t:.1f} s): walls {walls}, launches "
        f"{grid_launches}")
    for f in fails:
        log(f"  FAIL {f}")
    for k in launches:
        launches[k] += grid_launches[k]

    t = time.perf_counter()
    fails = check_mt_lane_kernels(dev, cfg, errs, small, design)
    failures += fails
    report("multitask lane kernels", t, fails,
           (("fused_ws_block_lanes", "K3bl"),
            ("cd_epoch_gram_block_lanes", "K1bl"),
            ("csc_score_block", "K5b")))
    fails = check_block_emulation(dev, cfg, errs)
    failures += fails
    for f in fails:
        log(f"  FAIL {f}")
    del small
    t = time.perf_counter()
    mt_lane_launches, walls, fails = mt_lane_phase(dev, cfg, design,
                                                   Y_sparse, card)
    failures += fails
    log(f"multitask lanes ({time.perf_counter() - t:.1f} s) on {card}: "
        f"walls {walls}, launches {mt_lane_launches}")
    for f in fails:
        log(f"  FAIL {f}")
    for k in launches:
        launches[k] += mt_lane_launches[k]
    del Y_sparse

    rows = kernel_times(dev, cfg, launches, errs, card, design)
    rows += block_times(dev, cfg, launches, errs, card, design)
    rows += lane_times(dev, cfg, launches, errs, card)
    rows += mt_lane_times(dev, cfg, launches, errs, card)
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

