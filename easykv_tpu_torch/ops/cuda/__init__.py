"""Hand-written CUDA kernels of the decode path, one wrapper module each,
with the plain PyTorch version beside every wrapper."""
