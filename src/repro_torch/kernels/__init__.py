"""Hand-written CUDA kernels of the port (K1-K3) and their plain torch
versions. ``ops`` holds the checked, counted public wrappers; the CUDA
sources are in ``repro_torch/csrc`` and build at first use on a card."""
