"""Compute: scalar oracle, plain PyTorch kernel twins, CUDA kernels, engine."""
