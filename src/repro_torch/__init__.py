"""repro_torch: the PyTorch/CUDA port of the skglm reproduction.

The JAX package ``repro`` is the reference; this package sits beside it with
the same module layout (``repro_torch/core/engine.py`` is the counterpart of
``repro/core/engine.py``) and imports neither ``jax`` nor ``repro``.

Device rule: every entry point (``solve``, ``make_engine``, ``lambda_max``,
the estimators' ``fit``) takes ``device=None``, which means ``"cuda"``, and
raises when no card is present instead of running on the CPU. Pass
``device="cpu"`` explicitly to run the plain-torch versions (the tests do).
The dtype follows the input; parity runs use float64.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "repro_torch: no CUDA device is available; the entry points run "
            "on the card by default. Pass device='cpu' to run the plain "
            "torch versions on the CPU.")
    return dev
