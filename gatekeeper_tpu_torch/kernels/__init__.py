"""Hand-written device kernels, each beside its plain PyTorch version.

K1 pair_compact (CUDA C++, csrc/pair_compact.cu) and K2 clause (Triton,
generated per template by clause_triton.py). A wrapper takes the plain
version only for tensors on the CPU; on a CUDA tensor it launches its
kernel or raises. Each wrapper counts its launches in `launches`.
"""
