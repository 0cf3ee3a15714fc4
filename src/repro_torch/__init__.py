"""PyTorch + CUDA port of the NetClone reproduction (``repro``).

Same module paths as the JAX reference (``repro_torch.fleetsim.stages`` ↔
``repro.fleetsim.stages``).  The port imports ``torch`` and numpy only —
nothing of ``jax`` and nothing of ``repro`` — and keeps its own copies of
the reference's plain-Python tables.  Its entry points run on the CUDA
device unless the caller asks for the CPU.
"""
