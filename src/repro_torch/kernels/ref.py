"""Plain torch oracles for the kernels (port of ``repro.kernels.ref``).

``cd_epoch_gram_ref`` / ``cd_epoch_xb_ref`` run ``epochs`` passes of the
plain CD epochs of ``core/cd.py``; ``fused_ws_ref`` is the two-pass head
that K3 fuses (score pass, top-k select, separate column gather), the same
function as ``_two_pass`` in the reference's fused-head tests.
"""
from __future__ import annotations

from ..core.cd import cd_epoch_gram, cd_epoch_xb
from ..core.working_set import select_working_set, violation_scores

__all__ = ["cd_epoch_gram_ref", "cd_epoch_xb_ref", "fused_ws_ref"]


def cd_epoch_gram_ref(G, c, beta0, q0, L, penalty, epochs=1):
    beta, q = beta0, q0
    for _ in range(epochs):
        beta, q = cd_epoch_gram(G, c, beta, q, L, penalty)
    return beta, q


def cd_epoch_xb_ref(Xt_ws, y, beta0, Xb0, L, offset, datafit, penalty,
                    epochs=1, w=None):
    beta, Xb = beta0, Xb0
    for _ in range(epochs):
        beta, Xb = cd_epoch_xb(Xt_ws, y, beta, Xb, L, offset, datafit,
                               penalty, w=w)
    return beta, Xb


def fused_ws_ref(X, r, beta, L, offset, penalty, gsupp, ws_size, use_fp):
    """(scores, grad, ws, X[:, ws]) of the two-pass head; X is [n, p]."""
    grad = X.T @ r + offset
    scores = violation_scores(penalty, beta, grad, L, use_fixed_point=use_fp)
    ws = select_working_set(scores, gsupp, ws_size)
    return scores, grad, ws, X[:, ws]
