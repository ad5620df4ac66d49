"""State carried across from the JAX package into the port.

The JAX package's objects reach this module as plain values (class names,
dataclass field values, numpy arrays); nothing of ``repro`` or ``jax`` is
imported. Four kinds of state carry over:

* a penalty or datafit, given by class name plus its dataclass fields
  (``penalty_from``, ``datafit_from``; ``from_reference`` reads both off an
  object by duck typing);
* a fitted estimator's ``coef_`` and ``intercept_`` (``load_fitted``;
  ``coef_ [p, T]`` and ``intercept_ [T]`` for a multitask fit);
* a warm-start ``beta0`` (``warm_start``; ``[p]`` or ``[p, T]``);
* a sparse design, from the arrays of a reference ``CSCDesign``
  (``csc_design_from_reference``), so both packages solve on the same
  padded arrays.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from . import resolve_device
from .core import datafits as _df
from .core import penalties as _pen
from .sparse.matrix import CSCDesign

__all__ = ["PENALTIES", "DATAFITS", "penalty_from", "datafit_from",
           "from_reference", "load_fitted", "warm_start",
           "csc_design_from_reference"]

PENALTIES = {cls.__name__: cls for cls in (
    _pen.L1, _pen.L1L2, _pen.MCP, _pen.SCAD, _pen.L05, _pen.L23, _pen.Box,
    _pen.BlockL1, _pen.BlockMCP)}
DATAFITS = {cls.__name__: cls for cls in (
    _df.Quadratic, _df.Logistic, _df.QuadraticSVC, _df.MultitaskQuadratic)}


def _build(registry, kind, name, fields):
    cls = registry.get(name)
    if cls is None:
        raise NotImplementedError(f"{kind} {name} is not ported yet")
    names = [f.name for f in dataclasses.fields(cls)]
    if sorted(fields) != sorted(names):
        raise ValueError(f"{name} takes fields {names}, got {sorted(fields)}")
    vals = {}
    for k, v in fields.items():
        a = np.asarray(v)
        if a.ndim != 0:
            raise ValueError(f"{name}.{k} is array-valued; only scalar "
                             "hyper-parameters carry over")
        vals[k] = float(a)
    return cls(**vals)


def penalty_from(name: str, **fields):
    """The port's penalty of class `name` with the given hyper-parameters."""
    return _build(PENALTIES, "penalty", name, fields)


def datafit_from(name: str, **fields):
    """The port's datafit of class `name` (the ported ones have no fields)."""
    return _build(DATAFITS, "datafit", name, fields)


def from_reference(obj):
    """The port's counterpart of a reference penalty or datafit object,
    read by class name and dataclass fields."""
    name = type(obj).__name__
    fields = {f.name: getattr(obj, f.name) for f in dataclasses.fields(obj)}
    if name in PENALTIES:
        return penalty_from(name, **fields)
    return datafit_from(name, **fields)


def warm_start(beta, *, dtype=torch.float64, device=None) -> torch.Tensor:
    """A reference coefficient vector ([p], or [p, T] multitask) as the
    port's ``beta0``."""
    return torch.as_tensor(np.asarray(beta), dtype=dtype,
                           device=resolve_device(device))


def load_fitted(estimator, coef, intercept=0.0, *, dual_coef=None):
    """Give a port estimator the fitted state of a reference one
    (``coef_``, ``intercept_`` and, for LinearSVC, ``dual_coef_``), so that
    its ``predict`` serves the reference's model."""
    estimator.coef_ = np.array(coef, dtype=np.float64)
    icpt = np.asarray(intercept, dtype=np.float64)
    estimator.intercept_ = float(icpt) if icpt.ndim == 0 else icpt
    if dual_coef is not None:
        estimator.dual_coef_ = np.array(dual_coef, dtype=np.float64)
    return estimator


def csc_design_from_reference(arrays, *, device=None):
    """The port's ``CSCDesign`` holding a reference ``CSCDesign``'s arrays.

    `arrays` maps ``data``, ``indices``, ``col_ids``, ``indptr`` and
    ``col_sq`` (numpy, window-padded as the reference built them),
    ``shape`` (n, p), ``max_col_nnz`` and, for the ELL layout, ``rows`` and
    ``vals`` ([p, m]; absent or None without it). The port derives the ELL
    layout from the CSC arrays, so ``rows`` only sets the ELL flag. Index
    arrays are cast to the port's dtypes (int32 indices and column ids,
    int64 indptr).
    """
    device = resolve_device(device)
    put = lambda a, dtype=None: torch.as_tensor(np.array(a, dtype=dtype),
                                                device=device)
    n, p = (int(v) for v in arrays["shape"])
    return CSCDesign(put(arrays["data"]), put(arrays["indices"], np.int32),
                     put(arrays["col_ids"], np.int32),
                     put(arrays["indptr"], np.int64), put(arrays["col_sq"]),
                     (n, p), int(arrays["max_col_nnz"]),
                     arrays.get("rows") is not None)
