"""Hand-written device kernels, each beside its plain PyTorch version.

K1 pair_compact (CUDA C++, csrc/pair_compact.cu), K2 clause (Triton,
generated per template by clause_triton.py), K3 regex_scan (CUDA C++,
csrc/regex_scan.cu), K4 join_member (CUDA C++, csrc/join_member.cu) and K5
rows_update (CUDA C++, csrc/rows_update.cu).
A wrapper takes the plain version only for tensors on the CPU; on a CUDA
tensor it launches its kernel or raises. Each wrapper counts its launches
in `launches`.
"""
