"""Secure-aggregation kernels: the counter-PRG masks, the Z_2^32 codec,
the plain PyTorch versions, the CUDA kernel wrappers and the dispatch."""
