"""Hand-written CUDA kernels for the switch response path, each beside its
plain PyTorch version (``ref``).  Sources live in ``csrc/``; they are built
with ``nvcc`` at first use (``build``)."""
