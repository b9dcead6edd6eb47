"""DP clip-and-noise: the CUDA kernel wrapper, its plain PyTorch version
and the dispatch."""
