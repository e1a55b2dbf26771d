"""Hand-written CUDA kernels (sources in ``csrc/``) and their wrappers.

Each wrapper launches its kernel for CUDA tensors, uses the plain PyTorch
version beside it for CPU tensors only, and counts its launches.
"""
