"""Shared power-of-two bucket rounding (own copy of ``repro.bucketing``).

The engine quantizes working-set sizes to powers of two; this module is the
single definition of that rounding rule for the port.
"""
from __future__ import annotations

__all__ = ["next_pow2", "pow2_bucket"]


def next_pow2(x: int) -> int:
    """Smallest power of two >= x (and 1 for x <= 1)."""
    return 1 << max(0, int(x - 1)).bit_length()


def pow2_bucket(n: int, minimum: int = 1, maximum: int | None = None) -> int:
    """Round ``n`` up to a power-of-two bucket, clamped below by
    ``next_pow2(minimum)`` and above by ``maximum`` (which wins)."""
    b = max(next_pow2(minimum), next_pow2(n))
    if maximum is not None:
        b = min(b, maximum)
    return b

