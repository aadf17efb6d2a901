"""ndstpu_torch: the nds-tpu SQL engine ported to PyTorch and CUDA.

The counterpart of the JAX package ``ndstpu``, module for module
(``datagen/``, ``engine/``, ``faults/``, ``harness/``, ``io/``, ``obs/``,
``ops/``, ``queries/``), running on an NVIDIA GPU.  It imports neither JAX
nor ``ndstpu``: the JAX-free layers and files it needs are its own copies.
Entry points run on ``cuda`` unless the caller asks for the CPU.
"""

__version__ = "0.1.0"
