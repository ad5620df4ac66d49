"""repro_torch.sparse: CSC designs on the card (port of ``repro.sparse``,
single device).

Only the score pass ``X.T @ raw`` and the residual update
``Xb += X_ws d`` touch the whole design; the working-set inner solve
densifies only the K selected columns. ``ShardedCSCDesign`` (mesh mode) and
``take_columns`` (screening) are not ported yet.
"""
from .matrix import CSCDesign
from .ops import (csc_column_windows, csc_gather_columns, csc_incremental_xb,
                  csc_matvec, csc_score, csc_score_ell, csc_weighted_col_sq)

__all__ = ["CSCDesign", "csc_score", "csc_weighted_col_sq", "csc_score_ell",
           "csc_column_windows", "csc_gather_columns", "csc_incremental_xb",
           "csc_matvec"]
