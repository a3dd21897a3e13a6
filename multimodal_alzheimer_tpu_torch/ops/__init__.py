"""Normalisation ops and the CUDA kernels that carry them."""
