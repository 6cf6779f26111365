"""Gemma-architecture configuration.

Architecture follows the public Gemma family (RMSNorm with +1 scale, RoPE,
GQA/MQA attention, GeGLU MLP, tied embeddings, embedding scaling by
sqrt(d_model)) — re-implemented TPU-first; the reference framework has no
model code at all (its LLM is OpenAI's API, reference
``control_plane.py:69-73``).

Size presets carry the *architecture dims* of Gemma-2B/7B; ``vocab_size`` is
independent so the in-tree byte tokenizer (384) and real SentencePiece
checkpoints (256128) both fit the same code path.
"""

from __future__ import annotations

from dataclasses import dataclass

from mcpx_torch.core.errors import ConfigError


@dataclass(frozen=True)
class GemmaConfig:
    vocab_size: int = 384
    d_model: int = 128
    n_layers: int = 2
    n_heads: int = 4
    n_kv_heads: int = 1
    head_dim: int = 32
    d_ff: int = 256
    rope_theta: float = 10000.0
    norm_eps: float = 1e-6
    max_seq_len: int = 2048
    dtype: str = "bfloat16"

    def __post_init__(self) -> None:
        if self.n_heads % self.n_kv_heads != 0:
            raise ConfigError("n_heads must be divisible by n_kv_heads")

    @property
    def q_per_kv(self) -> int:
        return self.n_heads // self.n_kv_heads

    @property
    def n_params(self) -> int:
        """Parameter count (tied embeddings counted once) — the basis for
        model-FLOPs/token ≈ 2*n_params in MFU accounting."""
        D, H, K, hd, F = self.d_model, self.n_heads, self.n_kv_heads, self.head_dim, self.d_ff
        per_layer = D * H * hd + 2 * D * K * hd + H * hd * D + 3 * D * F + 2 * D
        return self.vocab_size * D + self.n_layers * per_layer + D

    @classmethod
    def named(cls, name: str, *, vocab_size: int = 384, max_seq_len: int = 2048) -> "GemmaConfig":
        presets = {
            # Tiny random-weight config for CPU CI (SURVEY.md §4.5).
            "test": dict(d_model=128, n_layers=2, n_heads=4, n_kv_heads=1, head_dim=32, d_ff=256),
            # Gemma-2B architecture dims (18 layers, MQA).
            "2b": dict(
                d_model=2048, n_layers=18, n_heads=8, n_kv_heads=1, head_dim=256, d_ff=16384
            ),
            # Gemma-7B architecture dims (28 layers, MHA).
            "7b": dict(
                d_model=3072, n_layers=28, n_heads=16, n_kv_heads=16, head_dim=256, d_ff=24576
            ),
        }
        if name not in presets:
            raise ConfigError(f"unknown model size {name!r}; expected one of {sorted(presets)}")
        return cls(vocab_size=vocab_size, max_seq_len=max_seq_len, **presets[name])
