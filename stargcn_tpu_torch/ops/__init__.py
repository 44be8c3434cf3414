"""Operators: the bitdense backend and the build of its CUDA kernel."""
