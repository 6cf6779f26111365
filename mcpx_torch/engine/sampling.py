"""Token sampling, mask-aware: greedy argmax or temperature sampling.

Port of ``mcpx/engine/sampling.py``: ``sample``, and the heterogeneous
engine's per-row ``sample_rows``, ``sample_window_rows`` and
``accept_rows``. Masking happens on the logits
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


def exponential_noise(shape, generator: Optional[torch.Generator], device) -> torch.Tensor:
    """Exp(1) noise for the exponential race of :func:`sample_rows` (its
    ``-log`` is Gumbel(0, 1) noise for :func:`sample_window_rows`), drawn
    from ``generator`` on ``device``."""
    return torch.empty(shape, dtype=torch.float32, device=device).exponential_(1.0, generator=generator)


def sample_rows(
    logits: torch.Tensor,
    generator: Optional[torch.Generator],
    temperature: torch.Tensor,
    *,
    top_k: int = 0,
    mask: Optional[torch.Tensor] = None,
    noise: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Sample ids from [B, V] logits with a per-row temperature ([B]
    float): rows at ``temperature <= 0`` take the masked argmax, the rest
    sample at their own temperature; both are computed and selected, so one
    body serves every mix. Greedy rows mask, then argmax, as :func:`sample`
    does, so their picks equal the homogeneous path's. ``noise`` ([B, V]
    Exp(1), from :func:`exponential_noise`) lets two draws share one noise
    tensor (the engine's compact and full-vocabulary draws of a row);
    without it the noise is drawn from ``generator``."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    greedy = torch.argmax(logits, dim=-1)
    scaled = logits / torch.clamp(temperature.float(), min=1e-6)[:, None]
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF), scaled)
    probs = torch.softmax(scaled, dim=-1)
    if noise is None:
        noise = exponential_noise(probs.shape, generator, probs.device)
    stochastic = torch.argmax(probs / noise, dim=-1)
    return torch.where(temperature <= 0.0, greedy, stochastic)


def sample_window_rows(
    logits: torch.Tensor,
    temperature: torch.Tensor,
    *,
    top_k: int = 0,
    mask: Optional[torch.Tensor] = None,
    gumbel: torch.Tensor,
) -> torch.Tensor:
    """Sample every position of a [B, W, V] speculation window with a
    per-row temperature ([B] float): position w of row b is drawn as
    :func:`sample_rows` would draw it. ``mask`` is [B, W, V] or [V];
    ``gumbel`` is a [B, W, V] Gumbel(0, 1) tensor, one draw per window
    position. One argmax serves both kinds of row: greedy rows get scale 1
    and zeroed noise, so their pick is the masked argmax exactly (``x / 1``
    and ``x + 0`` are exact), hot rows ``argmax(logits / T + gumbel)`` (the
    Gumbel-max identity). Returns [B, W] ids."""
    logits = logits.float()
    if mask is not None:
        logits = torch.where(mask, logits, torch.full_like(logits, NEG_INF))
    hot = temperature > 0.0
    temperature = temperature.float()
    scale = torch.where(hot, torch.clamp(temperature, min=1e-6), torch.ones_like(temperature))
    scaled = logits / scale[:, None, None]
    if 0 < top_k < logits.shape[-1]:
        kth = torch.topk(scaled, top_k, dim=-1).values[..., -1:]
        scaled = torch.where(scaled < kth, torch.full_like(scaled, NEG_INF), scaled)
    return torch.argmax(scaled + gumbel * hot.float()[:, None, None], dim=-1)


def accept_rows(
    samples: torch.Tensor,  # [B, K] verification samples per window position
    proposals: torch.Tensor,  # [B, K] drafted tokens
    valid: torch.Tensor,  # [B, K] whether a token was drafted there
) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-row speculative acceptance, one rule for greedy and sampled rows:
    draft j is accepted while it equals position j's verification sample
    (drawn from the model's distribution given the draft prefix), and the
    first mismatching sample is the correction token. Every temperature
    then emits what token-by-token decode would: greedy rows exactly,
    sampled rows in distribution. Returns (``accepted`` [B, K] prefix
    flags, ``n_accepted`` [B])."""
    ok = valid & (samples == proposals)
    accepted = torch.cumprod(ok.long(), dim=1).bool()
    return accepted, accepted.long().sum(dim=1)
