"""mcpx_torch — the PyTorch/CUDA port of ``mcpx``.

A package of its own beside the JAX reference package, mirroring its
module paths. It imports torch and numpy, never jax and nothing of
``mcpx``. Entry points run on the GPU unless the caller passes
``device="cpu"``; there, every CUDA kernel's wrapper takes its plain
PyTorch version.
"""

# The API version served (the reference package's: the same wire format).
__version__ = "0.1.0"
