"""Hand-written CUDA kernels of the decode path and of the int8-cache
prefill, one wrapper module each, with the plain PyTorch version beside
every wrapper."""
