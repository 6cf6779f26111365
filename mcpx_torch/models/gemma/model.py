"""Gemma-architecture decoder in PyTorch: plain functions on a dict of
layer-stacked tensors.

Port of ``mcpx/models/gemma/model.py`` with the same parameter keys and
layouts (``embed`` [V, D]; ``layers/wq`` [L, D, H, hd], ``wk``/``wv``
[L, D, K, hd], ``wo`` [L, H, hd, D], ``w_gate``/``w_up`` [L, D, F],
``w_down`` [L, F, D], norms [L, D]; ``final_norm`` [D]), so weights carry
across one-to-one (``params.params_from_numpy``). The layer stack is a
Python loop over the leading axis. Numerics follow the reference: RMSNorm in
fp32 with scale ``1 + w``; half-split RoPE; tanh-approximate GeLU; the
embedding scaled by ``sqrt(d_model)`` cast to the activation dtype first;
attention logits and softmax in fp32; the tied unembedding with fp32 output.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from mcpx_torch.models.gemma.config import GemmaConfig

Params = dict[str, Any]
KVCache = dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[str(name)]


# --------------------------------------------------------------------- init
def init_params(
    cfg: GemmaConfig,
    generator: torch.Generator,
    device: "torch.device | str" = "cpu",
) -> Params:
    """Random-init parameters in ``cfg.dtype``, layer-stacked: normal draws
    scaled by 1/sqrt(fan_in) from ``generator`` (a seeded ``torch.Generator``
    on ``device``); norms start at zero (scale 1). The draws differ from the
    reference package's ``jax.random`` ones; carry weights across with
    ``params_from_numpy`` where equality matters."""
    dtype = torch_dtype(cfg.dtype)
    L, D, H, K, hd, Fd, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.d_ff, cfg.vocab_size,
    )

    def normal(shape, fan_in):
        # Layer-stacked weights are drawn one layer at a time so the fp32
        # staging buffer stays one layer wide at full width.
        if len(shape) == 2:
            w = torch.randn(shape, generator=generator, device=device)
            return (w / math.sqrt(fan_in)).to(dtype)
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            w = torch.randn(shape[1:], generator=generator, device=device)
            out[i] = (w / math.sqrt(fan_in)).to(dtype)
        return out

    return {
        "embed": normal((V, D), D),
        "layers": {
            "pre_attn_norm": torch.zeros((L, D), dtype=dtype, device=device),
            "pre_mlp_norm": torch.zeros((L, D), dtype=dtype, device=device),
            "wq": normal((L, D, H, hd), D),
            "wk": normal((L, D, K, hd), D),
            "wv": normal((L, D, K, hd), D),
            "wo": normal((L, H, hd, D), H * hd),
            "w_gate": normal((L, D, Fd), D),
            "w_up": normal((L, D, Fd), D),
            "w_down": normal((L, Fd, D), Fd),
        },
        "final_norm": torch.zeros((D,), dtype=dtype, device=device),
    }


def init_kv_cache(cfg: GemmaConfig, batch: int, max_len: int, device="cpu", dtype=None) -> KVCache:
    d = torch_dtype(dtype or cfg.dtype)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=d, device=device), "v": torch.zeros(shape, dtype=d, device=device)}


# ------------------------------------------------------------------- pieces
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float) -> torch.Tensor:
    x32 = x.float()
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    normed = x32 * torch.rsqrt(var + eps)
    return (normed * (1.0 + scale.float())).to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embeddings, half-split pairs. x: [..., seq, heads, head_dim];
    positions: [..., seq]."""
    head_dim = x.shape[-1]
    half = head_dim // 2
    freq = torch.exp(
        -math.log(theta)
        * (2.0 * torch.arange(half, dtype=torch.float32, device=x.device) / head_dim)
    )
    angles = positions[..., None].float() * freq  # [..., seq, half]
    cos = torch.cos(angles)[..., None, :]
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def embed_tokens(embed: torch.Tensor, tokens: torch.Tensor, cfg: GemmaConfig) -> torch.Tensor:
    x = embed[tokens.long()].to(torch_dtype(cfg.dtype))
    # torch.full fills on the device: no host copy, so a CUDA graph can
    # capture it. The scale is rounded to the model's dtype, as the
    # reference multiplies.
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def unembed(x: torch.Tensor, embed: torch.Tensor, subset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied unembedding, fp32 logits: x @ embed.T. ``subset`` [C] (token
    ids) restricts it to those rows of ``embed``: [..., C] logits, and the
    full-vocabulary product is never formed."""
    w = embed if subset is None else embed[subset.long()]
    return torch.matmul(x.float(), w.float().t())


def mlp(h: torch.Tensor, lp: dict[str, torch.Tensor], i: int) -> torch.Tensor:
    gate = torch.matmul(h, lp["w_gate"][i])
    up = torch.matmul(h, lp["w_up"][i])
    return torch.matmul(F.gelu(gate, approximate="tanh") * up, lp["w_down"][i])


def qkv(h: torch.Tensor, lp: dict[str, torch.Tensor], i: int):
    """[B, T, D] -> q [B, T, H, hd], k/v [B, T, K, hd]."""
    q = torch.einsum("btd,dkh->btkh", h, lp["wq"][i])
    k = torch.einsum("btd,dkh->btkh", h, lp["wk"][i])
    v = torch.einsum("btd,dkh->btkh", h, lp["wv"][i])
    return q, k, v


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """q: [B, T, K, G, hd]; k, v: [B, S, K, hd]; mask: [B, T, S] (True =
    keep). Returns [B, T, K, G, hd]; softmax in fp32."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.einsum("btkgh,bskh->btkgs", q.float(), k.float()) * scale
    logits = torch.where(mask[:, :, None, None, :], logits, torch.full_like(logits, -1e30))
    weights = torch.softmax(logits, dim=-1)
    return torch.einsum("btkgs,bskh->btkgh", weights.to(v.dtype), v)


def forward(
    params: Params,
    cfg: GemmaConfig,
    tokens: torch.Tensor,
    positions: torch.Tensor,
    kv_cache: KVCache,
    mask: torch.Tensor,
    logits_at: Optional[torch.Tensor] = None,
) -> tuple[torch.Tensor, KVCache]:
    """Forward over a [B, T] chunk against a dense [L, B, S, K, hd] cache.
    ``positions`` [B, T] are absolute and double as cache write slots;
    ``mask`` is [B, T, S] (True = attend). ``logits_at`` [B]: unembed only
    that position per row -> [B, V]. The cache is updated in place and
    returned."""
    B, T = tokens.shape
    lp = params["layers"]
    x = embed_tokens(params["embed"], tokens, cfg)
    b_idx = torch.arange(B, device=tokens.device)[:, None]
    for i in range(cfg.n_layers):
        h = rms_norm(x, lp["pre_attn_norm"][i], cfg.norm_eps)
        q, k, v = qkv(h, lp, i)
        q = apply_rope(q, positions, cfg.rope_theta)
        k = apply_rope(k, positions, cfg.rope_theta)
        kv_cache["k"][i][b_idx, positions] = k.to(kv_cache["k"].dtype)
        kv_cache["v"][i][b_idx, positions] = v.to(kv_cache["v"].dtype)
        qg = q.reshape(B, T, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)
        attn = _attend(qg, kv_cache["k"][i], kv_cache["v"][i], mask)
        attn = attn.reshape(B, T, cfg.n_heads * cfg.head_dim)
        wo = lp["wo"][i].reshape(cfg.n_heads * cfg.head_dim, cfg.d_model)
        x = x + torch.matmul(attn, wo)
        h = rms_norm(x, lp["pre_mlp_norm"][i], cfg.norm_eps)
        x = x + mlp(h, lp, i)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        x = x[torch.arange(B, device=x.device), logits_at.long()]  # [B, D]
    return unembed(x, params["embed"]), kv_cache


# -------------------------------------------------------------- entrypoints
def prefill(
    params: Params,
    cfg: GemmaConfig,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    kv_cache: KVCache,
    last_only: bool = False,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill a padded [B, T] batch; ``seq_lens`` [B] masks right-padding.
    Returns logits [B, T, V] (or [B, V], each row's last valid position,
    with ``last_only``) and the filled cache."""
    B, T = tokens.shape
    S = kv_cache["k"].shape[2]
    dev = tokens.device
    positions = torch.arange(T, device=dev).expand(B, T)
    s = torch.arange(S, device=dev)
    causal = s[None, None, :] <= positions[:, :, None]
    valid = s[None, None, :] < seq_lens.long().to(dev)[:, None, None]
    return forward(
        params, cfg, tokens, positions, kv_cache, causal & valid,
        logits_at=(seq_lens - 1) if last_only else None,
    )
