#!/usr/bin/env python3
"""Time K2 (``cd_epoch_xb``) and K1b (``cd_epoch_gram_block``) at fixed
cluster sizes on one CUDA card.

    python3 cd_sweep.py

For each shape of ``SWEEP`` and each cluster size C in (1, 8, 16) it
launches the kernel with the plan of that C (``xb_plan`` /
``gram_block_plan`` of ``repro_torch/kernels/cd_epoch.py`` with
``cluster=C``; C = 1 is K1b's one-CTA kernel and K2's cluster kernel on one
CTA), checks it against its plain version (K2, and K1b up to K = 1024) and
against the first C's result (K1b, bit for bit; C = 1 only where one CTA
holds q in shared memory), launches it again and requires
the same bits, and times one epoch (CUDA events, warm). It also times the
cluster barrier's round trip. The plans' cluster size and K1b's single-CTA
threshold rest on these numbers. Every record is printed; all of them go
to ``build/cd_sweep.json`` in the checkout. It exits non-zero if any launch
raised or any check failed.
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path

import chip_smoke as cs

SWEEP = dict(k2_n=(1000, 2000, 10_000, 50_000, 160_003), k2_K=512,
             k2_deep=(4096, 50_000),
             k1b=((64, 50), (64, 20), (128, 20), (256, 20), (512, 20),
                  (1024, 20), (2048, 20), (4096, 20)),
             clusters=(1, 8, 16), barrier_iters=10_000, reps=5)


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


def sweep(dev, cfg=SWEEP):
    """Returns (records, failures)."""
    import torch
    from repro_torch.core.penalties import L1, BlockL1
    from repro_torch.kernels.cd_epoch import (
        SMEM_DYN_MAX, cd_epoch_gram_block_cuda, cd_epoch_gram_plain,
        cd_epoch_xb_cuda, cd_epoch_xb_plain, gram_block_plan, xb_plan)
    from repro_torch.kernels.common import penalty_params
    out = dict(barrier=[], k2=[], k1b=[])
    fails = []
    for C in cfg["clusters"]:
        for threads in (128, 1024):
            us = cs.chain_floor_us(dev, C, threads, cfg["barrier_iters"])
            out["barrier"].append(dict(C=C, threads=threads, us=us))
            cs.log(f"cluster barrier C={C} threads={threads}: {us:.4f} us")

    shapes = [(kind, wt, cfg["k2_K"], n) for kind, wt in
              (("logistic", True), ("quadratic", False))
              for n in cfg["k2_n"]]
    shapes.append(("logistic", True) + cfg["k2_deep"])
    for kind, weighted, K, n in shapes:
        Xt, y, w, beta0, Xb0, L, off = cs.xb_inputs(K, n, kind, dev, seed=n)
        wt = w if weighted else None
        args = (Xt, y, beta0, Xb0, L, off, L1, penalty_params(L1(0.002)),
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

    prm = penalty_params(BlockL1(0.11))
    for K, T in cfg["k1b"]:
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


def main() -> int:
    here = Path(__file__).resolve().parent
    sys.path.insert(0, str(here / "src"))
    import torch
    if not torch.cuda.is_available():
        print("cd_sweep: no CUDA device", file=sys.stderr)
        return 2
    t0 = time.perf_counter()
    card = cs.card_line()
    cs.log(f"device: {card}")
    cs.build_report()
    records, failures = sweep(torch.device("cuda"))
    out = here / "build" / "cd_sweep.json"
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(dict(card=card, **records), indent=1))
    cs.log(f"sweep: {time.perf_counter() - t0:.1f} s, written to {out}")
    for f in failures:
        print(f"cd_sweep FAILED: {f}", file=sys.stderr)
    return 1 if failures else 0


if __name__ == "__main__":
    sys.exit(main())
