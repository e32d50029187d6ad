"""Hand-written CUDA kernels and their wrappers (each builds at first use)."""
