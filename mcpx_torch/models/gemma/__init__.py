from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import (
    init_params,
    forward,
    prefill,
    decode_step,
    init_kv_cache,
)

__all__ = [
    "GemmaConfig",
    "init_params",
    "forward",
    "prefill",
    "decode_step",
    "init_kv_cache",
]
