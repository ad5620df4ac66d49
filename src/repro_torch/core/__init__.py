"""repro_torch.core: the working-set + Anderson-CD solver (port of
``repro.core``, single-device path: dense and CSC designs, scalar and
multitask block coordinates, regularization paths with gap-safe screening
and chunked lanes, the CV grid and the CV estimators)."""
from .datafits import Logistic, MultitaskQuadratic, Quadratic, QuadraticSVC
from .penalties import (MCP, SCAD, L05, L23, L1, L1L2, BlockL1, BlockMCP,
                        Box, soft_threshold)
from .solver import SolveResult, make_engine, normalize_weights, solve
from .path import (GridResult, PathResult, cross_val_path, reg_path,
                   support_metrics)
from .lanes import LaneScheduler
from .screening import (gap_safe_mask_design, lasso_gap_safe_mask,
                        screened_fraction)
from .engine import (Design, DenseDesign, EngineConfig, GramSolver,
                     SolveEngine, SubproblemSolver, XbSolver, as_design)
from .anderson import anderson_extrapolate
from .working_set import (BucketPolicy, fixed_point_score, grow_ws_size,
                          next_pow2, select_working_set, violation_scores)
from .api import (elastic_net, enet_gap, l05_regression, l23_regression,
                  lambda_max, lasso, lasso_gap, logreg_gap, mcp_regression,
                  multitask_lasso, multitask_mcp, scad_regression,
                  sparse_logreg, svc_dual)
from .estimators import (ElasticNet, GeneralizedLinearEstimator, Lasso,
                         LassoCV, LinearSVC, MCPRegression, MCPRegressionCV,
                         MultiTaskLasso, MultiTaskMCP, SCADRegression,
                         SparseLogisticRegression, SparseLogisticRegressionCV,
                         information_criterion)

__all__ = [
    "Quadratic", "Logistic", "QuadraticSVC", "MultitaskQuadratic",
    "L1", "L1L2", "MCP", "SCAD", "L05", "L23", "Box", "BlockL1", "BlockMCP",
    "soft_threshold",
    "solve", "SolveResult", "make_engine", "normalize_weights",
    "reg_path", "PathResult", "support_metrics", "cross_val_path",
    "GridResult", "LaneScheduler", "gap_safe_mask_design",
    "lasso_gap_safe_mask", "screened_fraction",
    "EngineConfig", "SolveEngine", "SubproblemSolver", "GramSolver",
    "XbSolver", "Design", "DenseDesign", "as_design", "next_pow2",
    "BucketPolicy", "anderson_extrapolate", "violation_scores",
    "fixed_point_score", "select_working_set", "grow_ws_size",
    "lambda_max", "lasso_gap", "enet_gap", "logreg_gap", "lasso",
    "elastic_net", "mcp_regression", "scad_regression", "l05_regression",
    "l23_regression", "sparse_logreg", "svc_dual", "multitask_lasso",
    "multitask_mcp",
    "GeneralizedLinearEstimator", "Lasso", "ElasticNet", "MCPRegression",
    "SCADRegression", "SparseLogisticRegression", "LinearSVC",
    "MultiTaskLasso", "MultiTaskMCP",
    "LassoCV", "MCPRegressionCV", "SparseLogisticRegressionCV",
    "information_criterion",
]
