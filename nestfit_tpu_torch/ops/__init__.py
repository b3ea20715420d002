"""Hand-written Hopper kernels, each with its plain PyTorch version."""
