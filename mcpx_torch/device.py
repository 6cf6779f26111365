"""Device resolution for the port's entry points: the GPU unless the caller
asks for the CPU, and never a silent fall back to the CPU."""

from __future__ import annotations

import torch

from mcpx_torch.core.errors import EngineError


def resolve_device(device: "torch.device | str | None" = None) -> torch.device:
    """``None`` means CUDA; CUDA without a visible card raises."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise EngineError(
            "CUDA is not available: the port runs on the GPU by default; pass "
            "device='cpu' to run its plain PyTorch path on the CPU"
        )
    return dev
