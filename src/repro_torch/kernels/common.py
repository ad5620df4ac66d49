"""The penalty-parameter codec shared by the kernels (port of
``repro.kernels.common``).

The codec is exact-arity: ``penalty_params`` packs every scalar
hyper-parameter of a registered penalty class into an ``(arity,)`` float64
vector and ``make_penalty`` rebuilds the penalty from it. The CUDA kernels
take the class as an integer id (``PENALTY_IDS``, the ``switch`` in
``csrc/prox.cuh``; 7 and 8 are the block penalties, whose row proxes run
in the block kernels only) plus a pointer to that vector on the card,
which they read at entry. Unregistered classes and array-valued
(per-coordinate) hyper-parameters raise ``UnsupportedPenaltyError`` instead
of being silently truncated.

``bind_penalty`` is the other direction on the kernel route: the penalty of
a class whose fields are 0-d views of a vector. The captured outer step
(``core/engine.py``) runs on such a penalty over its static ``params``
input, so a CUDA graph captured at one lam replays at any other: the
values are bound at each replay, not baked into the graph.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core import penalties as _pen

__all__ = ["UnsupportedPenaltyError", "PENALTY_FIELDS", "PENALTY_IDS",
           "SCALAR_COORD_PENALTIES", "BLOCK_PENALTIES", "penalty_arity",
           "check_kernel_penalty", "check_score_kernel_penalty",
           "check_block_kernel_penalty", "penalty_params", "make_penalty",
           "bind_penalty"]


class UnsupportedPenaltyError(TypeError):
    """Penalty cannot be encoded for kernel use (unregistered class, or
    array-valued / per-coordinate hyper-parameters)."""


# class -> ordered scalar hyper-parameter field names
PENALTY_FIELDS: dict = {
    cls: tuple(f.name for f in dataclasses.fields(cls))
    for cls in (_pen.L1, _pen.L1L2, _pen.MCP, _pen.SCAD, _pen.L05, _pen.L23,
                _pen.Box, _pen.BlockL1, _pen.BlockMCP)}

# class -> the penalty id the CUDA prox switches on (csrc/prox.cuh)
PENALTY_IDS = {_pen.L1: 0, _pen.L1L2: 1, _pen.MCP: 2, _pen.SCAD: 3,
               _pen.L05: 4, _pen.L23: 5, _pen.Box: 6, _pen.BlockL1: 7,
               _pen.BlockMCP: 8}

# penalties whose prox acts on scalar coordinates: the set the scalar CD
# and score kernels (K1-K4) instantiate
SCALAR_COORD_PENALTIES = frozenset(
    (_pen.L1, _pen.L1L2, _pen.MCP, _pen.SCAD, _pen.L05, _pen.L23, _pen.Box))

# penalties with row-block proxes on [p, T] coefficients: the set the
# block kernels (K1b, K3b) instantiate
BLOCK_PENALTIES = frozenset((_pen.BlockL1, _pen.BlockMCP))


def penalty_arity(cls) -> int:
    """Number of scalar hyper-parameters the codec packs for `cls`."""
    try:
        return len(PENALTY_FIELDS[cls])
    except KeyError:
        raise UnsupportedPenaltyError(
            f"{cls.__name__} is not registered with the kernel penalty "
            "codec") from None


def check_kernel_penalty(cls):
    """Raise unless `cls` can run inside the scalar-coordinate CD kernels."""
    penalty_arity(cls)
    if cls not in SCALAR_COORD_PENALTIES:
        raise UnsupportedPenaltyError(
            f"{cls.__name__} has block (non-scalar-coordinate) proxes and "
            "cannot run inside the scalar CD kernels")


def check_score_kernel_penalty(cls):
    """Raise unless `cls` can run inside the fused working-set head (any
    codec-registered penalty: scalar ones in K3, block ones in K3b)."""
    penalty_arity(cls)


def check_block_kernel_penalty(cls):
    """Raise unless `cls` can run inside the block kernels (K1b, K3b)."""
    penalty_arity(cls)
    if cls not in BLOCK_PENALTIES:
        raise UnsupportedPenaltyError(
            f"{cls.__name__} has scalar-coordinate proxes and cannot run "
            "inside the block kernels")


def penalty_params(penalty, device=None) -> torch.Tensor:
    """Pack a penalty's hyper-parameters into an ``(arity,)`` float64
    tensor, on the CPU or on `device` (on a card a copy from pinned memory
    that does not wait for the stream). Raises UnsupportedPenaltyError for
    unregistered classes and for array-valued hyper-parameters."""
    fields = PENALTY_FIELDS.get(type(penalty))
    if fields is None:
        raise UnsupportedPenaltyError(
            f"{type(penalty).__name__} is not registered with the kernel "
            "penalty codec")
    vals = []
    for name in fields:
        v = getattr(penalty, name)
        if getattr(v, "ndim", 0) != 0:
            raise UnsupportedPenaltyError(
                f"{type(penalty).__name__}.{name} is array-valued "
                "(per-coordinate hyper-parameters are not kernel-encodable)")
        vals.append(float(v))
    out = torch.tensor(vals, dtype=torch.float64)
    if device is None or torch.device(device).type == "cpu":
        return out
    return out.pin_memory().to(device, non_blocking=True)


def make_penalty(cls, params):
    """Rebuild a penalty object from a parameter vector (inverse of
    ``penalty_params``)."""
    arity = penalty_arity(cls)
    return cls(*(float(params[i]) for i in range(arity)))


def bind_penalty(cls, params):
    """The `cls` penalty whose hyper-parameters are 0-d views of the codec
    vector `params` (on any device): its methods read the vector's values
    where they run, with no host read, so writing new values into `params`
    changes the penalty in place."""
    arity = penalty_arity(cls)
    if params.ndim != 1 or params.shape[0] != arity:
        raise ValueError(f"{cls.__name__} takes {arity} parameters, got a "
                         f"vector of shape {tuple(params.shape)}")
    return cls(*params.unbind(0))
