"""Hand-written CUDA kernels (the switch response path and flash
attention), each beside its plain PyTorch version (``ref``).  Sources live
in ``csrc/``; they are built with ``nvcc`` at first use (``build``)."""
