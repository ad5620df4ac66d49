"""Synthetic data generators (numpy; own copies of ``repro.data.synth``)."""
from .synth import (make_classification, make_correlated_design,
                    make_leadfield, make_multitask, make_sparse_design)

__all__ = ["make_correlated_design", "make_classification",
           "make_sparse_design", "make_multitask", "make_leadfield"]
