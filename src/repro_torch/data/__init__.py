"""Synthetic data generators and replicate weights (numpy; own copies of
``repro.data.synth`` and ``repro.data.folds``)."""
from .folds import bootstrap_weights, kfold_weights
from .synth import (make_classification, make_correlated_design,
                    make_leadfield, make_multitask, make_sparse_design)

__all__ = ["make_correlated_design", "make_classification",
           "make_sparse_design", "make_multitask", "make_leadfield",
           "kfold_weights", "bootstrap_weights"]
