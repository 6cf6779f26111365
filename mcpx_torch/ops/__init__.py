"""Public op surface: the port's hand-written CUDA kernel and its plain
PyTorch version (``mcpx/ops/__init__.py``'s two names)."""

from mcpx_torch.engine.kernels.paged_attention import (
    paged_attention,
    paged_attention_reference,
)

__all__ = ["paged_attention", "paged_attention_reference"]
