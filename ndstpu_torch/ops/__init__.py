"""Hand-written CUDA kernels for the engine's hot operators, with their
plain PyTorch versions and the build that compiles them."""
