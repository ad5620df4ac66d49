#!/usr/bin/env python3
"""Time K1 (``cd_epoch_gram``) at fixed thread counts, and K2
(``cd_epoch_xb``) and K1b (``cd_epoch_gram_block``) at fixed cluster sizes,
on one CUDA card.

    python3 cd_sweep.py [k1|k2|k1b|k1l|k1l_rule|csc|k3bl|heads|emulate|
                         mgrids ...]
                        [--src=SRC]

With names, only those kernels are swept (default: k1, k2, k1b; ``k1l``,
K1's lane form over lane counts and cluster sizes, ``k1l_rule``, its lane
plan's rule against every cluster size in repeated rounds, ``csc``, the
sparse score pass, ``k3bl``, the float64 product of the dense block heads,
and ``heads`` only when named: ``sweep_k1l``, ``sweep_k1l_rule``,
``sweep_csc``, ``sweep_k3bl``, ``sweep_heads``; ``emulate`` alone holds K1b
and K1bl at ``chip_smoke.py``'s shapes bit for bit to
``emulate_block_epoch``, ``chip_smoke.check_block_emulation``;
``mgrids`` alone runs ``chip_smoke.py``'s multitask lane runs (m1)-(m4)
and prints their walls). ``--src``
times the ``repro_torch`` of another tree's ``src`` (``heads`` runs on a
tree that takes its penalty parameters by
value too: an A/B of two trees, one process each, alternating). K1, for each
K of ``SWEEP["k1"]`` and each (cluster size, threads) of
``SWEEP["k1_layouts"]`` (``gram_plan`` of ``repro_torch/kernels/cd_epoch.py``
with ``cluster=`` and ``threads=``; None: the plan's own; clusters only
where K > 64): one L1 epoch on the Gram inputs of ``chip_smoke.py`` (every
coordinate moves), checked against its plain version and against the first
layout's result (bit for bit) and launched again for the same bits, timed
(CUDA events, warm), beside the same epoch with nothing moving (the chain
and the staging alone) and K1's chain floor on one CTA of that many
threads (K chain steps of a shuffle and a multiply-add, a handoff every
32).

K2 and K1b: for each shape of ``SWEEP`` and each cluster size C in
(1, 8, 16) it launches the kernel with the plan of that C (``xb_plan`` /
``gram_block_plan`` of ``repro_torch/kernels/cd_epoch.py`` with
``cluster=C``; C = 1 is K1b's one-CTA kernel, at each thread count of
``SWEEP["k1b_threads"]``, and K2's cluster kernel on one CTA), checks it
against its plain version (K2, and K1b up to K = 1024) and against the
first layout's result (K1b, bit for bit; C = 1 only where one CTA holds
the state on chip, q in registers), launches it again and requires
the same bits, and times one epoch (CUDA events, warm). It also times the
cluster barrier's round trip. The plans' thread counts, cluster size and
K1b's single-CTA threshold rest on these numbers. Every record is printed; all of them go
to ``build/cd_sweep.json`` in the checkout. It exits non-zero if any launch
raised or any check failed.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import chip_smoke as cs

SWEEP = dict(k1=(64, 128, 256, 512, 1024, 2048, 4096),
             k1_layouts=((1, None), (1, 64), (1, 128), (1, 256), (1, 512),
                         (4, None), (8, None), (16, None), (16, 64),
                         (16, 128), (16, 256), (16, 512)),
             k2_n=(1000, 2000, 10_000, 50_000, 160_003), k2_K=512,
             k2_deep=(4096, 50_000),
             k1b=((64, 50), (64, 20), (128, 20), (256, 20), (512, 20),
                  (1024, 20), (2048, 20), (4096, 20),
                  # where K1b's one CTA gives way to the cluster: K T from
                  # 2560 to 7680 at T = 5, 20 and 50 (5880 and 5850: just
                  # under the registers' reach, 5888)
                  (512, 5), (1024, 5), (1176, 5), (1536, 5), (128, 40),
                  (117, 50), (128, 50), (150, 50), (294, 20), (320, 20),
                  (384, 20)),
             # K1b's one CTA at the plan's threads (None) and forced ones
             k1b_threads=(None, 256, 384, 512, 768),
             clusters=(1, 8, 16), barrier_iters=10_000, reps=5,
             csc_T=20,
             # the product sweep: (label, n, p, ws) and the column counts
             k3bl_shapes=(("row", 10_000, 20_000, 512),
                          ("leadfield", 305, 7498, 1024)),
             k3bl_N=(24, 25, 48, 100, 200, 500),
             # K1l: lane counts, K and the cluster sizes a lane may take
             k1l_S=(1, 2, 5, 10, 20, 50),
             k1l_K=(256, 512, 1024, 2048, 4096, 8192, 16384),
             k1l_C=(16, 8, 4, 2),
             # the lanes' Grams a K takes at most (S K^2 float64 values):
             # (g1)'s deep buckets run K1l at K = 16384 on 10 lanes
             k1l_bytes=24 * 2**30,
             # the lane plan's rule: lane counts and K where a wave's
             # count decides, every cluster size timed in interleaved rounds
             k1l_rule_S=(10, 20, 50, 100), k1l_rule_K=(512, 1024, 2048, 4096),
             k1l_rounds=7)


def _record(out, fails, key, rec, run):
    """Run `run(rec)` (which fills `rec`); a launch that raises or a check
    that fails is a failure."""
    try:
        run(rec)
    except RuntimeError as exc:
        rec.update(ok=False, error=str(exc))
    if not rec["ok"]:
        fails.append(f"{key} {rec}")
    out[key].append(rec)
    cs.log(f"sweep {key} {json.dumps(rec)}")


def floor_ms(dev, K, threads):
    """K1's chain floor on one CTA of `threads` threads, in ms an epoch
    (CUDA events over a launch of enough epochs that the launch itself is
    spread thin)."""
    from repro_torch.kernels.cd_epoch import gram_chain_floor_cuda
    epochs = max(1, 200_000 // K)
    return cs.time_ms(lambda: gram_chain_floor_cuda(K, epochs, threads, dev),
                      dev, 3) / epochs


def sweep_k1(dev, cfg, out, fails):
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels.cd_epoch import (cd_epoch_gram_cuda,
                                              cd_epoch_gram_plain, gram_plan)
    from repro_torch.kernels.common import penalty_params
    for K in cfg["k1"]:
        G, c, beta0, q0, L = cs.gram_inputs(K, dev, seed=K)
        args = (G, c, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
        zero = torch.zeros_like(beta0)
        still = (G, c, zero, zero, L, L1, penalty_params(L1(1e6), dev))
        br, qr = cd_epoch_gram_plain(*args)
        moved = int(torch.sum(br != beta0))
        first = []
        for C, threads in cfg["k1_layouts"]:
            if C > 1 and K <= 64:
                continue
            plan = gram_plan(K, torch.float64, cluster=C, threads=threads)

            def run(rec, plan=plan):
                bk, qk = cd_epoch_gram_cuda(*args, plan=plan)
                bk2, qk2 = cd_epoch_gram_cuda(*args, plan=plan)
                torch.cuda.synchronize()
                ok_b, e_b = cs.close(bk, br, 1e-12, 1e-5)
                ok_q, e_q = cs.close(qk, qr, 1e-12, 1e-5)
                same = bool(torch.equal(bk, bk2) and torch.equal(qk, qk2))
                if not first:
                    first.extend((bk, qk))
                eq1 = bool(torch.equal(bk, first[0])
                           and torch.equal(qk, first[1]))
                rec.update(
                    ok=ok_b and ok_q and same and eq1, err=max(e_b, e_q),
                    repeat_equal=same, equals_first=eq1,
                    ms=cs.time_ms(lambda: cd_epoch_gram_cuda(
                        *args, plan=plan), dev, cfg["reps"]),
                    still_ms=cs.time_ms(lambda: cd_epoch_gram_cuda(
                        *still, plan=plan), dev, cfg["reps"]),
                    floor_ms=floor_ms(dev, K, plan.threads))
            _record(out, fails, "k1",
                    dict(K=K, C=plan.cluster, threads=plan.threads,
                         branch=plan.branch, dyn_bytes=plan.dyn_bytes,
                         moved=moved), run)
        del G
        torch.cuda.empty_cache()


def sweep_k1l(dev, cfg, out, fails):
    """K1l (``cd_epoch_gram_lanes``) at each S of ``k1l_S`` (as many as
    ``k1l_bytes`` of Grams hold) and K of ``k1l_K``, on each cluster size
    of ``k1l_C`` that the card places at
    K (and on one CTA a lane at K <= GRAM_SINGLE_MAX_K): one L1 epoch on
    ``chip_smoke.py``'s lane inputs (lam a lane, every lane active), each
    lane held to K1 on its own inputs bit for bit, timed (CUDA events,
    warm), with the card's capacity for that plan (``lane_capacity``: K1l's
    clusters at once), the waves of lanes it
    makes, and whether ``gram_lanes_plan`` picks it. Beside each K, one K1
    launch at K1's own plan (``gram_plan``)."""
    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels.cd_epoch import (
        GRAM_SINGLE_MAX_K, cd_epoch_gram_cuda, cd_epoch_gram_lanes_cuda,
        gram_lanes_plan, gram_plan, lane_capacity)
    f64 = torch.float64
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for K in cfg["k1l_K"]:
        lanes = [S for S in cfg["k1l_S"] if S * K * K * 8 <= cfg["k1l_bytes"]]
        Smax = max(lanes)
        G, c, beta0, q0, L = cs.gram_lane_inputs(Smax, K, dev, seed=K)
        prm = cs.lane_rows(L1(0.11), Smax, dev, seed=K)
        one = gram_plan(K, f64)
        ref = [cd_epoch_gram_cuda(G[s], c[s], beta0[s], q0[s], L[s], L1,
                                  prm[s], plan=one) for s in range(Smax)]
        k1 = cs.time_ms(lambda: cd_epoch_gram_cuda(
            G[0], c[0], beta0[0], q0[0], L[0], L1, prm[0], plan=one), dev,
            cfg["reps"] * 4)
        out["k1l_k1"].append(dict(K=K, C=one.cluster, threads=one.threads,
                                  ms=k1))
        cs.log(f"sweep k1l K1 K={K} C={one.cluster}: {k1:.4f} ms")
        sizes = ((1,) if K <= GRAM_SINGLE_MAX_K else ()) + cfg["k1l_C"]
        for S in lanes:
            picked = gram_lanes_plan(S, K, f64)
            on = torch.ones(S, dtype=torch.bool, device=dev)
            args = (G[:S], c[:S], beta0[:S], q0[:S], L[:S], L1, prm[:S], on)
            for C in sizes:
                plan = gram_plan(K, f64, cluster=C)
                cap = lane_capacity(plan, f64)[0] if C > 1 else sms
                if cap < 1:
                    cs.log(f"sweep k1l K={K} C={C}: the card places none")
                    continue

                def run(rec, plan=plan, args=args, S=S):
                    b, q = cd_epoch_gram_lanes_cuda(*args, plan=plan)
                    torch.cuda.synchronize()
                    same = all(torch.equal(b[s], ref[s][0])
                               and torch.equal(q[s], ref[s][1])
                               for s in range(S))
                    ms = cs.time_ms(lambda: cd_epoch_gram_lanes_cuda(
                        *args, plan=plan), dev, cfg["reps"])
                    rec.update(ok=same, equals_k1=same, ms=ms,
                               over_k1=ms / k1)
                _record(out, fails, "k1l",
                        dict(K=K, S=S, C=C, threads=plan.threads,
                             dyn_bytes=plan.dyn_bytes, capacity=cap,
                             waves=-(-S // cap), picked=plan == picked,
                             k1_ms=k1), run)
        del G, ref
        torch.cuda.empty_cache()


def sweep_k1l_rule(dev, cfg, out, fails):
    """The lane plan's rule held to repeated times: at each S of
    ``k1l_rule_S`` and K of ``k1l_rule_K``, K1l (one L1 epoch, every lane
    active, each lane K1 bit for bit) on each cluster size of STEP_DOWN
    that places, timed in ``k1l_rounds`` rounds that take the sizes in
    turn (CUDA events, warm; min, median and max of the rounds), beside
    the card's clusters at once (``lane_capacity``, two CTAs sharing an SM
    where they fit) and at most the SMs over C (a CTA an SM), the waves
    each makes, and the size ``gram_lanes_plan`` picks; the record of each
    (S, K) names the fastest size by median and the loss to it of the
    plan's pick and of the fewest waves at a CTA an SM (the largest C of
    a tie)."""
    import statistics

    import torch
    from repro_torch.core.penalties import L1
    from repro_torch.kernels.cd_epoch import (
        STEP_DOWN, cd_epoch_gram_cuda, cd_epoch_gram_lanes_cuda,
        gram_lanes_plan, gram_plan, lane_capacity)
    f64 = torch.float64
    for K in cfg["k1l_rule_K"]:
        Smax = max(cfg["k1l_rule_S"])
        G, c, beta0, q0, L = cs.gram_lane_inputs(Smax, K, dev, seed=K)
        prm = cs.lane_rows(L1(0.11), Smax, dev, seed=K)
        ref = [cd_epoch_gram_cuda(G[s], c[s], beta0[s], q0[s], L[s], L1,
                                  prm[s], plan=gram_plan(K, f64))
               for s in range(Smax)]
        for S in cfg["k1l_rule_S"]:
            on = torch.ones(S, dtype=torch.bool, device=dev)
            args = (G[:S], c[:S], beta0[:S], q0[:S], L[:S], L1, prm[:S], on)
            cells = {}
            for C in STEP_DOWN[:-1]:
                plan = gram_plan(K, f64, cluster=C)
                shared, sms = lane_capacity(plan, f64)
                if shared < 1:
                    continue
                b, q = cd_epoch_gram_lanes_cuda(*args, plan=plan)
                torch.cuda.synchronize()
                same = all(torch.equal(b[s], ref[s][0])
                           and torch.equal(q[s], ref[s][1])
                           for s in range(S))
                own = min(shared, sms // C)
                cells[C] = dict(plan=plan, C=C, threads=plan.threads,
                                shared=shared, own=own,
                                waves_shared=-(-S // shared),
                                waves_own=-(-S // own), ok=same, ms=[])
            for _ in range(cfg["k1l_rounds"]):
                for cell in cells.values():
                    cell["ms"].append(cs.time_ms(
                        lambda plan=cell["plan"]: cd_epoch_gram_lanes_cuda(
                            *args, plan=plan), dev, 4 * cfg["reps"]))

            def run(rec, cells=cells, S=S):
                for cell in cells.values():
                    ms = cell.pop("ms")
                    del cell["plan"]
                    cell.update(median=statistics.median(ms), min=min(ms),
                                max=max(ms))
                best = min(cells, key=lambda C: cells[C]["median"])
                picks = dict(
                    plan=gram_lanes_plan(S, K, f64).cluster,
                    own=min(cells, key=lambda C: (cells[C]["waves_own"],
                                                  -C)))
                rec.update(
                    ok=all(cell["ok"] for cell in cells.values()),
                    cells=list(cells.values()), best=best, picks=picks,
                    loss={k: cells[C]["median"] / cells[best]["median"] - 1
                          for k, C in picks.items()})
            _record(out, fails, "k1l_rule", dict(S=S, K=K), run)
        del G, ref
        torch.cuda.empty_cache()


def sweep_csc(dev, cfg, out, fails):
    """K5, K5s and K5b (``csrc/csc_score.cu``) on the full-size sparse
    design of ``chip_smoke.py`` (``sparse_fig2``, float64; K5b at T = 20),
    each checked against its plain version (1e-12 + 1e-12 |ref|), launched
    twice for the same bits, and timed (CUDA events, warm; launched, and
    replayed from a CUDA graph), beside the L2 gather floor of its walk
    (``l2_gather_probe``: nnz hashed reads of raw's rows)."""
    import torch
    from repro_torch.data import make_sparse_design
    from repro_torch.kernels.csc_score import (csc_score_plain, csc_walk_cuda,
                                               l2_gather_probe_cuda, lane_plan)
    from repro_torch.sparse import CSCDesign
    X = make_sparse_design(**cs.FULL["sparse"])[0]
    d = CSCDesign.from_scipy(X, ell=True, device=dev)
    del X
    n, p = d.shape
    nnz = d.nnz
    g = torch.Generator(device=dev).manual_seed(11)
    args = (d.data, d.indices, d.col_ids, d.indptr)
    f64 = torch.float64
    for T in (1, cfg["csc_T"]):
        raw = torch.randn(n, T, generator=g, device=dev, dtype=f64)
        v = raw[:, 0].contiguous() if T == 1 else raw
        w = torch.rand(n, generator=g, device=dev, dtype=f64) + 0.5
        for square in ((False, True) if T == 1 else (False,)):
            x = w if square else v
            ref = csc_score_plain(*args, x, square=square)

            def call(square=square, x=x):
                return csc_walk_cuda(d.data, d.indices, d.indptr, x,
                                     square=square)

            def run(rec, call=call, ref=ref):
                k1, k2 = call(), call()
                torch.cuda.synchronize()
                ok, err = cs.close(k1, ref, 1e-12, 1e-12)
                same = bool(torch.equal(k1, k2))
                rec.update(ok=ok and same, err=err, repeat_equal=same,
                           ms=cs.time_ms(call, dev, cfg["reps"]),
                           graph_ms=cs.graph_ms(call, dev, cfg["reps"]))
            V, G, E = lane_plan(T)
            _record(out, fails, "csc",
                    dict(T=T, square=square, n=n, p=p, nnz=nnz, V=V, G=G,
                         E=E), run)
        buf = torch.rand(n, T, dtype=f64, device=dev)
        floor = cs.time_ms(lambda: l2_gather_probe_cuda(buf, nnz), dev,
                           cfg["reps"])
        out["csc"].append(dict(T=T, kind="l2_floor", ms=floor))
        cs.log(f"sweep csc T={T} L2 gather floor {floor:.4f} ms")
        del raw, buf
    del d
    torch.cuda.empty_cache()


def kernel_split(fn, calls=5):
    """Device ms a call of `fn` by kernel (``torch.profiler`` over `calls`
    warm calls; self device time, the kernel's name without its namespace
    and arguments)."""
    import re
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total", 0)
        if us > 0:
            m = re.search(r"(\w+)(<[^(]*>)?\(", e.key)
            name = m.group(1) if m else e.key
            split[name] = split.get(name, 0.0) + us / 1e3 / calls
    return split


def _lanes_of(N, T0):
    """(S, T) with S * T = N for K3bl at N columns: T = gcd(N, T0) (the
    shape's task count where it divides N)."""
    import math
    T = math.gcd(N, T0)
    return N // T, T


def sweep_k3bl(dev, cfg, out, fails):
    """The float64 product of K3b, K3l and K3bl (``product_cuda`` of
    ``repro_torch/kernels/fused_ws.py``) at N columns of R [n, N] on the
    row shape (n = 10,000, p = 20,000) and the leadfield (n = 305, p =
    7498), float64, beside the tensor cores' own rate (``dmma_rate_cuda``,
    each MMA shape from registers): the kernel the plan picks (the narrow
    one to N = 24, the wide one above) with the plan's spans, launched
    twice for the same bits, its spans' sum held to ``torch.mm(Xt, R)``
    within 1e-12 + 1e-10 |ref| and timed alone (CUDA events, warm); beside
    it ``torch.mm(Xt, R)`` and K3bl (``ops.fused_ws_block_lanes``, BlockL1,
    S lanes of T = gcd(N, 20 or 50) tasks) with its plan, held to its plain
    version (scores and gradient within 1e-12 + 1e-12 / 1e-10 |ref|,
    cand_idx and working sets equal), with its device time split by kernel
    (``kernel_split``)."""
    import torch
    from repro_torch.core.penalties import BlockL1
    from repro_torch.core.working_set import select_working_set
    from repro_torch.kernels import ops
    from repro_torch.kernels.fused_ws import (card_product_plan,
                                              dmma_rate_cuda,
                                              fused_ws_block_lanes_plain,
                                              product_cuda)
    reps = cfg["reps"]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for mma in ("m8n8k4", "m16n8k4", "m16n8k8", "m16n8k16"):
        # the tensor cores alone: 8 warps an SM, operands in registers
        iters = 2000
        ms = cs.time_ms(lambda: dmma_rate_cuda(mma, 256, sms, iters, dev),
                        dev, reps)
        m, k = int(mma[1:mma.index("n")]), int(mma[mma.index("k") + 1:])
        rec = dict(kind="dmma_rate", mma=mma, threads=256, ctas=sms, ms=ms,
                   tflops=2 * 8 * iters * m * 8 * k * 8 * sms / ms / 1e9)
        out["k3bl"].append(rec)
        cs.log(f"sweep k3bl {json.dumps(rec)}")
    for label, n, p, ws in cfg["k3bl_shapes"]:
        g = torch.Generator(device=dev).manual_seed(n)
        Xt = torch.randn(p, n, generator=g, device=dev, dtype=torch.float64)
        for N in cfg["k3bl_N"]:
            R = torch.randn(n, N, generator=g, device=dev,
                            dtype=torch.float64) / n ** 0.5
            ref = torch.mm(Xt, R)
            mm_ms = cs.time_ms(lambda: torch.mm(Xt, R), dev, reps)
            plan = card_product_plan(Xt, N)

            def run(rec, plan=plan):
                a = product_cuda(Xt, R, plan)
                b = product_cuda(Xt, R, plan)
                torch.cuda.synchronize()
                tot = a[0]
                for k in range(1, plan.spans):
                    tot = tot + a[k]
                ok, err = cs.close(tot[:, :N], ref, 1e-12, 1e-10)
                same = bool(torch.equal(a, b))
                ms = cs.time_ms(lambda: product_cuda(Xt, R, plan), dev,
                                reps)
                rec.update(ok=ok and same, err=err, repeat_equal=same,
                           ms=ms, mm_ms=mm_ms,
                           tflops=2 * p * n * N / ms / 1e9)
            _record(out, fails, "k3bl",
                    dict(shape=label, n=n, p=p, N=N, product=plan.name,
                         bn=plan.bn, spans=plan.spans, ctas=plan.ctas,
                         scratch_bytes=8 * plan.scratch), run)
            torch.cuda.empty_cache()
            S, T = _lanes_of(N, 20 if label == "row" else 50)
            beta = 0.2 * torch.randn(S, p, T, generator=g, device=dev,
                                     dtype=torch.float64) * \
                (torch.rand(S, p, 1, generator=g, device=dev) < 0.3)
            L = (torch.sum(Xt * Xt, dim=1) / n).expand(S, p)
            off = 0.01 * torch.randn(p, generator=g, device=dev,
                                     dtype=torch.float64)
            gs = torch.linalg.vector_norm(beta, dim=2) != 0
            prm = cs.lane_rows(BlockL1(0.11), S, dev, seed=N)
            wsz = min(ws, p)
            args = (Xt, R, beta, L, off, gs, BlockL1, prm, wsz)

            def run(rec, args=args, S=S, wsz=wsz):
                sk, gk, ik, wk, _ = ops.fused_ws_block_lanes(*args)
                sr, gr, ir, _ = fused_ws_block_lanes_plain(*args)
                ok1, e1 = cs.close(sk, sr, 1e-12, 1e-12)
                ok2, e2 = cs.close(gk, gr, 1e-12, 1e-10)
                same = bool(torch.equal(ik, ir)) and all(
                    torch.equal(wk[s], select_working_set(sr[s], gs[s], wsz))
                    for s in range(S))
                plan = card_product_plan(Xt, N)
                rec.update(ok=ok1 and ok2 and same, err=max(e1, e2),
                           product=plan.name, spans=plan.spans,
                           scratch_bytes=8 * plan.scratch,
                           ms=cs.time_ms(lambda: ops.fused_ws_block_lanes(
                               *args), dev, reps), mm_ms=mm_ms,
                           split_ms=kernel_split(
                               lambda: ops.fused_ws_block_lanes(*args)))
            _record(out, fails, "k3bl",
                    dict(shape=label, n=n, p=p, N=N, kernel="K3bl", S=S, T=T,
                         ws=wsz), run)
            del R, beta
            torch.cuda.empty_cache()
        del Xt
        torch.cuda.empty_cache()


def sweep(dev, cfg=SWEEP, kernels=("k1", "k2", "k1b")):
    """Returns (records, failures)."""
    import torch
    from repro_torch.core.penalties import L1, BlockL1
    from repro_torch.kernels.cd_epoch import (
        SMEM_DYN_MAX, cd_epoch_gram_block_cuda, cd_epoch_gram_plain,
        cd_epoch_xb_cuda, cd_epoch_xb_plain, gram_block_plan, xb_plan)
    from repro_torch.kernels.common import penalty_params
    out = dict(barrier=[], k1=[], k1l_rule=[], k2=[], k1b=[], k1l=[],
               k1l_k1=[], csc=[], k3bl=[])
    fails = []
    if "k1" in kernels:
        sweep_k1(dev, cfg, out, fails)
    if "k1l" in kernels:
        sweep_k1l(dev, cfg, out, fails)
    if "k1l_rule" in kernels:
        sweep_k1l_rule(dev, cfg, out, fails)
    if "csc" in kernels:
        sweep_csc(dev, cfg, out, fails)
    if "k3bl" in kernels:
        sweep_k3bl(dev, cfg, out, fails)
    if "k2" not in kernels and "k1b" not in kernels:
        return out, fails
    for C in cfg["clusters"]:
        for threads in (128, 1024):
            us = cs.chain_floor_us(dev, C, threads, cfg["barrier_iters"])
            out["barrier"].append(dict(C=C, threads=threads, us=us))
            cs.log(f"cluster barrier C={C} threads={threads}: {us:.4f} us")

    shapes = [(kind, wt, cfg["k2_K"], n) for kind, wt in
              (("logistic", True), ("quadratic", False))
              for n in cfg["k2_n"]] if "k2" in kernels else []
    if shapes:
        shapes.append(("logistic", True) + cfg["k2_deep"])
    for kind, weighted, K, n in shapes:
        Xt, y, w, beta0, Xb0, L, off = cs.xb_inputs(K, n, kind, dev, seed=n)
        wt = w if weighted else None
        args = (Xt, y, beta0, Xb0, L, off, L1,
                penalty_params(L1(0.002), dev),
                kind)
        br, xr = cd_epoch_xb_plain(*args, w=wt)
        moved = int(torch.sum(br != beta0))
        for C in cfg["clusters"]:
            plan = xb_plan(n, weighted, torch.float64, cluster=C)

            def run(rec, plan=plan):
                bk, xk = cd_epoch_xb_cuda(*args, w=wt, plan=plan)
                bk2, xk2 = cd_epoch_xb_cuda(*args, w=wt, plan=plan)
                torch.cuda.synchronize()
                ok_b, e_b = cs.close(bk, br, 1e-11, 1e-8)
                ok_x, e_x = cs.close(xk, xr, 1e-11, 1e-8)
                same = bool(torch.equal(bk, bk2) and torch.equal(xk, xk2))
                rec.update(ok=ok_b and ok_x and same, err=max(e_b, e_x),
                           repeat_equal=same, ms=cs.time_ms(
                               lambda: cd_epoch_xb_cuda(*args, w=wt,
                                                        plan=plan),
                               dev, cfg["reps"]))
            _record(out, fails, "k2",
                    dict(kind=kind, weighted=weighted, K=K, n=n, C=C,
                         branch=plan.branch, threads=plan.threads,
                         per=plan.per, dyn_bytes=plan.dyn_bytes,
                         moved=moved), run)
        del Xt
        torch.cuda.empty_cache()

    prm = penalty_params(BlockL1(0.11), dev)
    for K, T in cfg["k1b"] if "k1b" in kernels else ():
        G, cc, beta0, q0, L = cs.gram_block_inputs(K, T, dev, seed=K)
        args = (G, cc, beta0, q0, L, BlockL1, prm)
        ref = cd_epoch_gram_plain(*args) if K <= 1024 else None
        first = []
        layouts = [(C, th) for C in cfg["clusters"]
                   for th in (cfg["k1b_threads"] if C == 1 else (None,))]
        for C, th in layouts:
            try:
                plan = gram_block_plan(K, T, torch.float64, cluster=C,
                                       threads=th)
            except ValueError as exc:   # past the one CTA's 64 tasks
                cs.log(f"sweep k1b K={K} T={T} C={C}: {exc}")
                continue
            if plan.dyn_bytes > SMEM_DYN_MAX:
                cs.log(f"sweep k1b K={K} T={T} C={C} threads={th}: one CTA "
                       f"cannot hold the state ({plan})")
                continue

            def run(rec, plan=plan):
                bk, qk = cd_epoch_gram_block_cuda(*args, plan=plan)
                bk2, qk2 = cd_epoch_gram_block_cuda(*args, plan=plan)
                torch.cuda.synchronize()
                same = bool(torch.equal(bk, bk2) and torch.equal(qk, qk2))
                ok, err = True, 0.0
                if ref is not None:
                    ok_b, e_b = cs.close(bk, ref[0], 1e-12, 1e-5)
                    ok_q, e_q = cs.close(qk, ref[1], 1e-12, 1e-5)
                    ok, err = ok_b and ok_q, max(e_b, e_q)
                if not first:
                    first.extend((bk, qk))
                eq1 = bool(torch.equal(bk, first[0])
                           and torch.equal(qk, first[1]))
                rec.update(ok=ok and same and eq1, err=err,
                           repeat_equal=same, equals_first_c=eq1,
                           ms=cs.time_ms(lambda: cd_epoch_gram_block_cuda(
                               *args, plan=plan), dev, cfg["reps"]))
            _record(out, fails, "k1b",
                    dict(K=K, T=T, C=C, branch=plan.branch,
                         threads=plan.threads, per=plan.per,
                         owners=plan.owners, g_whole=plan.g_whole,
                         dyn_bytes=plan.dyn_bytes), run)
        del G
        torch.cuda.empty_cache()
    return out, fails


def sweep_heads(dev, cfg):
    """K3 (the head at ws = 1024, and its score launch alone), K4
    (weighted), K3b (T = 20, ws = 512, and the leadfield's T = 50, ws =
    1024), K3l (S = 10, ws = 1024), K3bl (S = 10, T = 20, ws = 512, and
    the leadfield's S = 10, T = 50; each beside its yardstick of ten K3b
    heads, eager and replayed from a graph), K1 (K = 1024, and 256, 2048,
    4096), K2 (K = 512, n = 10,000), K1b (K = 1024, T = 20; on one CTA at
    (64, 50) and (256, 20)), K1l (S = 10 at K = 256 ... 4096, S = 50 at K =
    256 and 1024), K1bl ((10, 64, 50), (50, 512, 5) on one CTA, (10, 1024,
    20)) and K2l (S = 10, K = 64 and 128, n = 10,000) at the time shapes
    of ``chip_smoke.py`` and the grids', L1 / BlockL1, float64: ms a
    launch (CUDA events, warm; the one-CTA and K2l shapes also replayed
    from a graph), and K1b's one-CTA chain floor where the tree has it.
    The penalty's vector is made on the card, where the kernels read
    it."""
    import torch
    from repro_torch.core.penalties import L1, BlockL1
    from repro_torch.kernels import ops
    from repro_torch.kernels.common import penalty_params
    from repro_torch.kernels.fused_ws import score_cuda

    c = cs.FULL
    reps = cfg["reps"] * 10
    out = {}
    n, p = c["k3_n"], c["k3_p"]
    Xt, r, beta, L, off = cs.fused_inputs(n, p, dev, seed=3)
    gs = L1(0.11).generalized_support(beta)
    w = 2.0 * torch.rand(n, device=dev, dtype=torch.float64)
    args = (Xt, r, beta, L, off, gs, L1, penalty_params(L1(0.11), dev), 1024)
    out["K3"] = cs.time_ms(lambda: ops.fused_ws(*args), dev, reps)
    out["K3 score"] = cs.time_ms(lambda: score_cuda(
        Xt, r, beta, L, off, L1, args[7], gsupp=gs), dev, reps)
    out["K4"] = cs.time_ms(lambda: ops.ws_score(
        Xt, r, beta, L, off, L1, args[7], w=w), dev, reps)
    out["torch.mv"] = cs.time_ms(lambda: torch.mv(Xt, r), dev, reps)
    del Xt
    b = c["k3b"]
    Xt, R, beta, L, off = cs.block_inputs(b["n"], b["p"], b["T"], dev,
                                          seed=13)
    gs = BlockL1(0.11).generalized_support(beta)
    args = (Xt, R, beta, L, off, gs, BlockL1,
            penalty_params(BlockL1(0.11), dev), b["ws"])
    out["K3b"] = cs.time_ms(lambda: ops.fused_ws_block(*args), dev, reps)
    del Xt
    m = c["k3b_wide"]
    Xt, R, beta, L, off = cs.block_inputs(m["n"], m["p"], m["T"], dev,
                                          seed=13)
    gs = BlockL1(0.11).generalized_support(beta)
    args = (Xt, R, beta, L, off, gs, BlockL1,
            penalty_params(BlockL1(0.11), dev), m["ws"])
    out["K3b T=50"] = cs.time_ms(lambda: ops.fused_ws_block(*args), dev,
                                 reps)
    out["K3b T=50 graph"] = cs.graph_ms(lambda: ops.fused_ws_block(*args),
                                        dev, reps)
    del Xt
    S = c["k3l"]["S"]
    Xt, _, _, L, off = cs.fused_inputs(n, p, dev, seed=3)
    g = torch.Generator(device=dev).manual_seed(8)
    R = torch.randn(n, S, generator=g, device=dev, dtype=torch.float64)
    beta = torch.randn(S, p, generator=g, device=dev, dtype=torch.float64) \
        * (torch.rand(S, p, generator=g, device=dev) < 0.3)
    prm = cs.lane_rows(L1(0.11), S, dev, seed=9)
    args = (Xt, R, beta, L.expand(S, p), off, beta != 0, L1, prm, 1024)
    out["K3l"] = cs.time_ms(lambda: ops.fused_ws_lanes(*args), dev, reps)
    del Xt
    t = c["mt_lane_time"]
    for key, (T, n3, p3, ws3) in (
            ("K3bl", (t["T"], b["n"], b["p"], t["ws"])),
            ("K3bl leadfield", (m["T"], m["n"], m["p"], m["ws"]))):
        Xt, R, beta, L, off = cs.block_lane_head_inputs(t["S"], T, n3, p3,
                                                        dev, 21)
        gs = torch.linalg.vector_norm(beta, dim=2) != 0
        prm = cs.lane_rows(BlockL1(0.11), t["S"], dev, seed=21)
        args = (Xt, R, beta, L.expand(t["S"], p3), off, gs, BlockL1, prm,
                ws3)
        out[key] = cs.time_ms(lambda: ops.fused_ws_block_lanes(*args), dev,
                              cfg["reps"] * 4)
        out[key + " graph"] = cs.graph_ms(
            lambda: ops.fused_ws_block_lanes(*args), dev, cfg["reps"] * 4)
        # its yardstick in chip_smoke.py: ten K3b heads on the lanes' slices
        Rs = [R[:, s * T:(s + 1) * T].contiguous() for s in range(t["S"])]

        def ten(Xt=Xt, Rs=Rs, beta=beta, L=L, off=off, gs=gs, prm=prm,
                ws3=ws3):
            return [ops.fused_ws_block(Xt, Rs[s], beta[s], L, off, gs[s],
                                       BlockL1, prm[s], ws3)
                    for s in range(len(Rs))]
        out[key + " ten K3b"] = cs.time_ms(ten, dev, cfg["reps"] * 4)
        out[key + " ten K3b graph"] = cs.graph_ms(ten, dev, cfg["reps"] * 4)
        del Xt, Rs
    G, cc, beta0, q0, L = cs.gram_inputs(1024, dev, seed=1024)
    args = (G, cc, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
    out["K1"] = cs.time_ms(lambda: ops.cd_epoch_gram(*args), dev, reps)
    for K in (256, 2048, 4096):
        G, cc, beta0, q0, L = cs.gram_inputs(K, dev, seed=K)
        args = (G, cc, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
        out[f"K1 K={K}"] = cs.time_ms(lambda: ops.cd_epoch_gram(*args), dev,
                                      reps)
    Xt, y, w, beta0, Xb0, L, off = cs.xb_inputs(c["k2_K"], c["k2_n"],
                                                "logistic", dev, seed=7)
    args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.07), dev),
            "logistic")
    out["K2"] = cs.time_ms(lambda: ops.cd_epoch_xb(*args), dev, reps)
    G, cc, beta0, q0, L = cs.gram_block_inputs(1024, c["k1b_T"], dev,
                                               seed=1024)
    args = (G, cc, beta0, q0, L, BlockL1, penalty_params(BlockL1(0.11), dev))
    out["K1b"] = cs.time_ms(lambda: ops.cd_epoch_gram_block(*args), dev,
                            cfg["reps"])
    # the lane epochs at the shapes the grids launch them most: one CTA a
    # lane (K1l at K = 256, K1bl at K T = 3200) and the cluster (K = 1024)
    for S, K in ((10, 256), (10, 1024), (10, 2048), (10, 4096), (50, 256),
                 (50, 1024)):
        on = torch.ones(S, dtype=torch.bool, device=dev)
        G, cc, beta0, q0, L = cs.gram_lane_inputs(S, K, dev, seed=K)
        args = (G, cc, beta0, q0, L, L1, cs.lane_rows(L1(0.11), S, dev), on)
        key = f"K1l K={K}" if S == 10 else f"K1l S={S} K={K}"
        out[key] = cs.time_ms(lambda: ops.cd_epoch_gram_lanes(*args), dev,
                              cfg["reps"])
        if (S, K) == (10, 1024):
            out[key + " graph"] = cs.graph_ms(
                lambda: ops.cd_epoch_gram_lanes(*args), dev, cfg["reps"])
    # K1bl where the grids launch it most (one CTA a lane: (m1)'s leadfield
    # at K = 64, T = 50 and (m4)'s K = 512, T = 5) and on the cluster, and
    # K1b on one CTA; the one-CTA shapes also replayed from a graph
    for S, K, T in ((10, 64, 50), (50, 512, 5), (10, 1024, 20)):
        on = torch.ones(S, dtype=torch.bool, device=dev)
        G, cc, beta0, q0, L = cs.block_lane_inputs(S, K, T, dev, seed=K)
        args = (G, cc, beta0, q0, L, BlockL1,
                cs.lane_rows(BlockL1(0.11), S, dev), on)
        key = f"K1bl K={K} T={T}" if S == 10 else f"K1bl S={S} K={K} T={T}"
        out[key] = cs.time_ms(
            lambda: ops.cd_epoch_gram_block_lanes(*args), dev,
            cfg["reps"] * 4)
        if K < 1024:
            out[key + " graph"] = cs.graph_ms(
                lambda: ops.cd_epoch_gram_block_lanes(*args), dev,
                cfg["reps"] * 4)
        del G
    for K, T in ((64, 50), (256, 20)):
        G, cc, beta0, q0, L = cs.gram_block_inputs(K, T, dev, seed=K)
        args = (G, cc, beta0, q0, L, BlockL1,
                penalty_params(BlockL1(0.11), dev))
        out[f"K1b K={K} T={T}"] = cs.time_ms(
            lambda: ops.cd_epoch_gram_block(*args), dev, cfg["reps"] * 4)
        out[f"K1b K={K} T={T} graph"] = cs.graph_ms(
            lambda: ops.cd_epoch_gram_block(*args), dev, cfg["reps"] * 4)
    del G
    # K2l where (g3) launches it (K = 64 and 128; 10 lanes, n = 10,000,
    # weighted logistic), eager and replayed from a graph
    S, n = 10, c["k2l"]["n"]
    for K in (64, 128):
        Xt, y, _, b0, _, L2, off = cs.xb_inputs(K, n, "logistic", dev, seed=7)
        Xt = Xt.expand(S, K, n).contiguous()
        b0 = b0.expand(S, K).contiguous()
        Xb0 = (b0[:, None, :] @ Xt)[:, 0]
        w = 0.5 + torch.rand(S, n, device=dev, dtype=torch.float64)
        args = (Xt, y, b0, Xb0, L2.expand(S, K).contiguous(),
                off.expand(S, K).contiguous(), L1,
                cs.lane_rows(L1(0.07), S, dev, seed=2),
                torch.ones(S, dtype=torch.bool, device=dev), "logistic")
        out[f"K2l K={K}"] = cs.time_ms(
            lambda: ops.cd_epoch_xb_lanes(*args, w=w), dev, cfg["reps"] * 4)
        out[f"K2l K={K} graph"] = cs.graph_ms(
            lambda: ops.cd_epoch_xb_lanes(*args, w=w), dev, cfg["reps"] * 4)
        del Xt
    # the one-CTA chain floor (a tree where the parent tree has none)
    from repro_torch.kernels import cd_epoch
    if hasattr(cd_epoch, "gram_block_chain_floor_cuda"):
        for K, T in ((64, 50), (512, 5), (256, 20)):
            th = cd_epoch.gram_block_plan(K, T, torch.float64).threads
            epochs = max(1, 200_000 // K)
            out[f"K1b chain floor K={K} T={T}"] = cs.time_ms(
                lambda: cd_epoch.gram_block_chain_floor_cuda(
                    K, T, epochs, th, dev), dev, 3) / epochs
    cs.log(f"sweep heads {json.dumps(out)}")
    return out


def main() -> int:
    here = Path(__file__).resolve().parent
    src = [a.split("=", 1)[1] for a in sys.argv[1:] if a.startswith("--src=")]
    sys.path.insert(0, str(Path(src[0]).resolve() if src else here / "src"))
    import torch
    if not torch.cuda.is_available():
        print("cd_sweep: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"device: {card}")
    cs.build_report()
    kernels = tuple(a for a in sys.argv[1:] if not a.startswith("--")) \
        or ("k1", "k2", "k1b")
    if kernels == ("heads",):
        sweep_heads(torch.device("cuda"), SWEEP)
        return 0
    if kernels == ("mgrids",):
        # the multitask lane runs (m1)-(m4) of chip_smoke.py alone, with
        # their walls, for an A/B of two trees
        dev = torch.device("cuda")
        X, beta_true, design, y, _ = cs.sparse_designs(dev, cs.FULL)
        Y = cs.sparse_mt_target(X, beta_true, cs.FULL["mt_sparse_T"])
        _, walls, fails = cs.mt_lane_phase(dev, cs.FULL, design, Y, card)
        cs.log(f"sweep mgrids {json.dumps(walls)}")
        for f in fails:
            print(f"cd_sweep FAILED: {f}", file=sys.stderr)
        return 1 if fails else 0
    if kernels == ("emulate",):
        fails = cs.check_block_emulation(torch.device("cuda"), cs.FULL, {})
        for f in fails:
            print(f"cd_sweep FAILED: {f}", file=sys.stderr)
        return 1 if fails else 0
    records, failures = sweep(torch.device("cuda"), kernels=kernels)
    out = here / "build" / "cd_sweep.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, **records), indent=1))
    cs.log(f"sweep: {time.perf_counter() - t0:.1f} s, written to {out}")
    for f in failures:
        print(f"cd_sweep FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
