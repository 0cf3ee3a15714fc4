"""Hand-written CUDA kernels (the switch response path, flash attention
and the SSD and RG-LRU scans), each beside its plain PyTorch version
(``ref``).  Sources live in ``csrc/``; they are built with ``nvcc`` at
first use (``build``)."""
