"""Token sampling, mask-aware: greedy argmax or temperature sampling.

Port of ``mcpx/engine/sampling.py::sample``. Masking happens on the logits
before temperature and top-k, so constrained decoding composes with any
sampling config. Greedy ``argmax`` returns the first maximum, as ``jnp``
does. Temperature sampling draws from an explicit ``torch.Generator``; its
draws differ from ``jax.random``'s for the same seed. The draw is
``torch.multinomial``'s own one-sample path written out (the argmax of the
probabilities over exponential noise), which gives its draws from the same
generator state without its host-side check of the probabilities: no
synchronisation, so a CUDA graph can capture it (with the generator
registered to the graph).
"""

from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def sample(
    logits: torch.Tensor,
    generator: Optional[torch.Generator] = None,
    *,
    temperature: float = 0.0,
    top_k: int = 0,
    mask: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample ids from [B, V] logits. ``temperature <= 0`` is greedy;
    ``top_k > 0`` keeps the k highest logits; ``mask`` ([B, V] or [V]
    bool) excludes False entries."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    if temperature <= 0.0:
        return torch.argmax(logits, dim=-1)
    logits = logits / temperature
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(logits, top_k, dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, torch.full_like(logits, NEG_INF), logits)
    probs = torch.softmax(logits, dim=-1)
    noise = torch.empty_like(probs).exponential_(1.0, generator=generator)
    return torch.argmax(probs / noise, dim=-1)
