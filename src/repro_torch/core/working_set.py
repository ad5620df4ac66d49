"""Working-set machinery (paper Algorithm 1; port of the single-device parts
of ``repro.core.working_set``).

Features are ranked by violation of the first-order optimality condition
score_j = dist(-grad_j f(beta), d g_j(beta_j)) (Eq. 2), or by the fixed-point
violation score^cd (Eq. 24) when the penalty's subdifferential is
uninformative. The working set grows as ws_size = max(ws_size, 2 |gsupp|),
rounded to powers of two (BucketPolicy), taking the ws_size highest scores
while always retaining the generalized support (priority +inf).

Selection order is the reference's ``lax.top_k`` order: priority
descending, lowest index first on ties. ``torch.topk`` does not promise
that, so selection is a stable descending sort.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from ..bucketing import next_pow2

__all__ = ["fixed_point_score", "violation_scores", "grow_ws_size",
           "BucketPolicy", "select_working_set", "scatter_ws",
           "ws_occupancy", "candidate_columns", "priorities"]


def fixed_point_score(penalty, beta, grad, L):
    """score^cd_j = |beta_j - prox_{g_j/L_j}(beta_j - grad_j / L_j)|; for
    block coefficients [p, T] the row norm of the difference."""
    step = 1.0 / torch.clamp(L, min=1e-30)
    if beta.ndim == 2:
        step = step[:, None]
    diff = beta - penalty.prox(beta - grad * step, step)
    if beta.ndim == 2:
        return torch.sqrt(torch.sum(diff ** 2, dim=-1))
    return torch.abs(diff)


def violation_scores(penalty, beta, grad, L, use_fixed_point=None):
    """Per-feature priority scores; picks score^d or score^cd."""
    if use_fixed_point is None:
        use_fixed_point = not penalty.HAS_SUBDIFF
    if use_fixed_point:
        return fixed_point_score(penalty, beta, grad, L)
    return penalty.subdiff_dist(grad, beta)


def grow_ws_size(prev_size: int, gsupp_count: int, p: int, p0: int = 64,
                 growth: int = 2) -> int:
    """ws_size = max(prev, growth*|gsupp|), pow2-padded, clamped to p."""
    target = max(p0, prev_size, growth * gsupp_count)
    return min(p, next_pow2(target))


@dataclass(frozen=True)
class BucketPolicy:
    """Working-set bucket policy: powers of two from p0, clamped to p,
    chosen monotonically by `next_bucket`."""
    p0: int = 64
    growth: int = 2                  # bucket >= growth * |generalized support|

    def first_bucket(self, gsupp_count: int, p: int) -> int:
        return grow_ws_size(0, gsupp_count, p, p0=self.p0,
                            growth=self.growth)

    def next_bucket(self, prev: int, gsupp_count: int, p: int) -> int:
        return grow_ws_size(prev, gsupp_count, p, p0=self.p0,
                            growth=self.growth)

    def escalate(self, bucket: int, p: int) -> int:
        """Next rung of the ladder."""
        return min(p, next_pow2(bucket + 1))

    def ladder(self, p: int):
        """All buckets this policy can ever select for a p-feature problem."""
        out, b = [], min(p, next_pow2(self.p0))
        while b < p:
            out.append(b)
            b = next_pow2(b + 1)
        out.append(p)
        return out


def priorities(scores, gsupp_mask):
    """Selection priority: the score, +inf on the generalized support.
    Adding 0.0 maps -0.0 to +0.0, so signed zeros tie as the kernel's
    comparison sees them."""
    return torch.where(gsupp_mask, torch.inf, scores) + 0.0


def select_working_set(scores, gsupp_mask, ws_size: int):
    """Top-`ws_size` features by score, generalized support always
    included, in ``lax.top_k`` order (lowest index first on ties)."""
    pri = priorities(scores, gsupp_mask)
    order = torch.sort(pri, descending=True, stable=True).indices
    return order[:ws_size]


def scatter_ws(vec, ws, vals):
    """A copy of vec with vec[ws] = vals."""
    out = vec.clone()
    out[ws] = vals
    return out


def ws_occupancy(beta_ws):
    """Fraction of the working-set slots holding a nonzero coefficient after
    the inner solve (0-d tensor); a block [K, T] counts as occupied when any
    task coefficient is nonzero."""
    nz = torch.any(beta_ws != 0, dim=-1) if beta_ws.ndim == 2 \
        else (beta_ws != 0)
    return torch.mean(nz.to(beta_ws.dtype))


def candidate_columns(cand_idx, cand_cols, ws, p: int):
    """Recover ``X[:, ws]`` ([n, K]) from the fused head's candidate buffer.

    cand_idx [C] int32 holds global feature indices (entries >= p are
    exhausted-tile padding) and cand_cols [C, n] the matching columns of X.
    Every ws entry appears in cand_idx, so an inverse index maps ws rows to
    candidate rows without touching X again. Padding entries all land in
    the spare slot p of the inverse index, which ws never reads; no host
    read is needed. The result is a transposed view of a contiguous [K, n]
    copy (``.T`` of it is the feature-major ``Xt_ws`` the inner solvers
    take).
    """
    C = cand_idx.shape[0]
    idx = torch.clamp(cand_idx.long(), max=p)
    pos = torch.zeros(p + 1, dtype=torch.long, device=cand_idx.device)
    pos.scatter_(0, idx, torch.arange(C, device=cand_idx.device))
    return cand_cols[pos[ws]].T
