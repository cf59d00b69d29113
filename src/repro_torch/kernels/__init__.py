"""Hand-written CUDA kernels for the linear backend, their wrappers and
their plain PyTorch versions."""
