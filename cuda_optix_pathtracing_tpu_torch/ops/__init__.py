"""Rendering primitives in PyTorch and the wrappers of the CUDA kernels."""
