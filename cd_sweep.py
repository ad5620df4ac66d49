#!/usr/bin/env python3
"""Time K1 (``cd_epoch_gram``) at fixed thread counts, and K2
(``cd_epoch_xb``) and K1b (``cd_epoch_gram_block``) at fixed cluster sizes,
on one CUDA card.

    python3 cd_sweep.py [k1|k2|k1b|csc|heads ...] [--src=SRC]

With names, only those kernels are swept (default: k1, k2, k1b; ``csc``,
the sparse score pass, and ``heads`` only when named: ``sweep_csc``,
``sweep_heads``). ``--src`` times the ``repro_torch`` of another tree's
``src`` (``heads`` runs on a tree that takes its penalty parameters by
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
``cluster=C``; C = 1 is K1b's one-CTA kernel and K2's cluster kernel on one
CTA), checks it against its plain version (K2, and K1b up to K = 1024) and
against the first C's result (K1b, bit for bit; C = 1 only where one CTA
holds q in shared memory), launches it again and requires
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
                  (1024, 20), (2048, 20), (4096, 20)),
             clusters=(1, 8, 16), barrier_iters=10_000, reps=5,
             csc_T=20)


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


def sweep(dev, cfg=SWEEP, kernels=("k1", "k2", "k1b")):
    """Returns (records, failures)."""
    import torch
    from repro_torch.core.penalties import L1, BlockL1
    from repro_torch.kernels.cd_epoch import (
        SMEM_DYN_MAX, cd_epoch_gram_block_cuda, cd_epoch_gram_plain,
        cd_epoch_xb_cuda, cd_epoch_xb_plain, gram_block_plan, xb_plan)
    from repro_torch.kernels.common import penalty_params
    out = dict(barrier=[], k1=[], k2=[], k1b=[], csc=[])
    fails = []
    if "k1" in kernels:
        sweep_k1(dev, cfg, out, fails)
    if "csc" in kernels:
        sweep_csc(dev, cfg, out, fails)
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
        for C in cfg["clusters"]:
            plan = gram_block_plan(K, T, torch.float64, cluster=C)
            if plan.dyn_bytes > SMEM_DYN_MAX:
                cs.log(f"sweep k1b K={K} T={T} C={C}: one CTA cannot hold "
                       f"q ({plan.dyn_bytes} bytes)")
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
                         dyn_bytes=plan.dyn_bytes), run)
        del G
        torch.cuda.empty_cache()
    return out, fails


def sweep_heads(dev, cfg):
    """K3 (the head at ws = 1024, and its score launch alone), K4
    (weighted), K3b (T = 20, ws = 512), K1 (K = 1024), K2 (K = 512, n =
    10,000) and K1b (K = 1024, T = 20) at the time shapes of
    ``chip_smoke.py``, L1 / BlockL1, float64: ms a launch (CUDA events,
    warm). The penalty's vector is made on the card, where the kernels
    read it."""
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
    G, cc, beta0, q0, L = cs.gram_inputs(1024, dev, seed=1024)
    args = (G, cc, beta0, q0, L, L1, penalty_params(L1(0.11), dev))
    out["K1"] = cs.time_ms(lambda: ops.cd_epoch_gram(*args), dev, reps)
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
