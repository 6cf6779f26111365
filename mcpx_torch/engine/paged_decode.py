"""Decode forward against the paged KV cache.

Port of ``mcpx/engine/paged_decode.py::decode_chunk_paged``: the same math
as ``models/gemma/model.py`` (shared RMSNorm, RoPE, projections), but each
layer writes its chunk's K/V into the page pools with one scatter and
attends through the ragged paged-attention wrapper, which launches the CUDA
kernel for CUDA tensors and takes its plain version for CPU tensors. On
int8 weights each layer is dequantized inside the layer loop, the
embedding rows are gathered as int8 with their scales, and the unembedding
(compact or not) scales its fp32 output; the KV pools stay in the model's
dtype.

On a ``parallel.mesh.ServeLayout`` (``layout=``) the forward is the
reference's per-coordinate program (``models/gemma/model.py``): for each
row block over ``data`` at its data coordinate, each model shard scatters
its K/V heads into its card's pools, and into every other data replica's
(``transfer.homes``; MQA's one KV head is projected once), and launches the
ragged kernel on its card over its own query heads against its leading-dim
view of those pools, and the shards' partial outputs are summed after
``wo`` and ``w_down``. A forward so launches the kernel ``n_layers`` times
per attention shard and row block, each on its card.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from mcpx_torch.engine.kernels.paged_attention import (
    paged_attention_chunk,
    ragged_paged_attention,
)
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import (
    apply_rope,
    embed_tokens,
    embed_tokens_sharded,
    kv_at,
    layer_weights,
    mlp,
    qkv,
    rms_norm,
    shard_layer_weights,
    sharded_layer,
    unembed,
    unembed_sharded,
)
from mcpx_torch.parallel.transfer import Inputs, count_forward, homes, send, tree_at


def decode_chunk_paged(
    params: dict[str, Any],
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B, S] chunk of new tokens per row
    positions: torch.Tensor,  # [B] slot tokens[:, 0] is written to
    page_table: torch.Tensor,  # [B, Pmax] int32
    paged_kv: dict[str, torch.Tensor],  # k/v: [K, L, N, Psz, hd]
    *,
    logits_at: Optional[torch.Tensor] = None,  # [B] chunk slot per row
    active_cols: Optional[torch.Tensor] = None,  # [C] token ids: compact unembed
    q_lens: Optional[torch.Tensor] = None,  # [B] live window slots per row
    layout=None,  # parallel.mesh.ServeLayout: the sharded forward
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """S new tokens per row in one forward. Query i of row b is written at
    cache position ``positions[b] + i`` and sees the cache through it.
    ``q_lens`` makes rows ragged: slots past a row's live width are pads
    (their K/V writes are garbage the next chunk overwrites; their
    attention outputs are zero), and ``q_lens = 0`` idles a row. None keeps
    every slot live. Returns ([B, S, V] fp32 logits, pools); with
    ``active_cols``, ([B, S, C] logits over those token ids at every slot,
    the draft verifier's input); else with ``logits_at``, ([B, V], pools)
    at one slot per row. ``active_cols`` takes precedence over
    ``logits_at``. The pools are updated in place."""
    if layout is not None:
        count_forward()
        S = tokens.shape[1]
        pos_mat = positions.long()[:, None] + torch.arange(S, device=tokens.device)
        outs = []
        for d, (r0, r1) in enumerate(layout.rows(tokens.shape[0])):
            inp = Inputs(
                layout, (0, 0), tokens=tokens[r0:r1], positions=pos_mat[r0:r1], start=positions[r0:r1],
                table=page_table[r0:r1], q_lens=None if q_lens is None else q_lens[r0:r1],
                logits_at=None if logits_at is None else logits_at[r0:r1], cols=active_cols,
            )
            outs.append(_decode_block(params, cfg, d, inp, paged_kv, layout, logits_at is not None,
                                      active_cols is not None, q_lens is not None))
        return (outs[0] if len(outs) == 1 else torch.cat(outs)), paged_kv
    B, S = tokens.shape
    K, L, N, psz, hd = paged_kv["k"].shape
    p_max = page_table.shape[1]
    dev = tokens.device
    x = embed_tokens(params["embed"], tokens, cfg)  # [B, S, D]

    pos_mat = positions.long()[:, None] + torch.arange(S, device=dev)  # [B, S]
    chunk = pos_mat // psz
    page = torch.gather(page_table.long(), 1, chunk.clamp(max=p_max - 1))
    # A slot past the table width (never reached by the engine's page
    # budget) goes to the null page rather than wrapping into a live page.
    page = torch.where(chunk < p_max, page, torch.zeros_like(page))
    flat_idx = page * psz + pos_mat % psz  # [B, S] slot in the [N*Psz] view
    k_flat = paged_kv["k"].view(K, L, N * psz, hd)
    v_flat = paged_kv["v"].view(K, L, N * psz, hd)
    table32 = page_table.to(torch.int32).contiguous()
    start32 = positions.to(torch.int32).contiguous()
    qlen32 = None if q_lens is None else q_lens.to(torch.int32).contiguous()

    for i in range(cfg.n_layers):
        w = layer_weights(params, i, cfg)
        h = rms_norm(x, w["pre_attn_norm"], cfg.norm_eps)
        q, k, v = qkv(h, w)
        q = apply_rope(q, pos_mat, cfg.rope_theta)
        k = apply_rope(k, pos_mat, cfg.rope_theta)
        k_flat[:, i, flat_idx] = k.permute(2, 0, 1, 3).to(k_flat.dtype)
        v_flat[:, i, flat_idx] = v.permute(2, 0, 1, 3).to(v_flat.dtype)
        qg = q.reshape(B, S, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim).contiguous()
        if qlen32 is not None:
            attn = ragged_paged_attention(
                qg, paged_kv["k"], paged_kv["v"], table32, start32, qlen32, i
            )
        else:
            attn = paged_attention_chunk(qg, paged_kv["k"], paged_kv["v"], table32, start32, i)
        attn = attn.reshape(B, S, cfg.n_heads * cfg.head_dim)
        wo = w["wo"].reshape(cfg.n_heads * cfg.head_dim, cfg.d_model)
        x = x + torch.matmul(attn, wo)
        h = rms_norm(x, w["pre_mlp_norm"], cfg.norm_eps)
        x = x + mlp(h, w)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if active_cols is not None:
        return unembed(x, params["embed"], subset=active_cols), paged_kv
    if logits_at is not None:
        x = x[torch.arange(B, device=dev), logits_at.long()]  # [B, D]
    return unembed(x, params["embed"]), paged_kv


def _slots(views: dict, p_max: int, psz: int) -> torch.Tensor:
    """Each query's slot in the flattened [N*Psz] pool view, from a row
    block's ``positions`` and ``table`` on one card (a slot past the table
    width goes to the null page)."""
    pos = views["positions"].long()
    chunk = pos // psz
    page = torch.gather(views["table"].long(), 1, chunk.clamp(max=p_max - 1))
    page = torch.where(chunk < p_max, page, torch.zeros_like(page))
    return page * psz + pos % psz


def _decode_block(params, cfg, d, inp, paged_kv, layout, at_slot: bool, compact: bool, ragged: bool):
    """Row block ``d`` of ``decode_chunk_paged`` on ``layout``'s model shards
    (``inp``: its ``transfer.Inputs``): the same slots, pages and kernel
    arguments as the unmeshed forward, each attention shard's kernel
    launched on its card over its KV-head view of that card's pools, each
    KV write mirrored to every data replica of its heads."""
    red = (d, 0)
    B, S = inp.at(red)["tokens"].shape
    _, L, N, psz, hd = kv_at(paged_kv, layout, red)[0].shape
    p_max = inp.at(red)["table"].shape[1]
    x = embed_tokens_sharded(params, cfg, layout, d, inp)

    for i in range(cfg.n_layers):

        def write_kv(a, src, k, v, i=i):
            h0 = 0 if a is None else layout.attn[a].kv[0]
            for dst, (k0, k1), fresh in homes(layout, a):
                kk = send(k[:, :, k0 - h0:k1 - h0], src, dst, layout)
                vv = send(v[:, :, k0 - h0:k1 - h0], src, dst, layout)
                slots = inp.derive(dst, "slots", lambda views: _slots(views, p_max, psz))
                if fresh:
                    pk, pv, base = kv_at(paged_kv, layout, dst)
                    kh = k1 - k0
                    pk[k0 - base:k1 - base].view(kh, L, N * psz, hd)[:, i, slots] = kk.permute(2, 0, 1, 3).to(pk.dtype)
                    pv[k0 - base:k1 - base].view(kh, L, N * psz, hd)[:, i, slots] = vv.permute(2, 0, 1, 3).to(pv.dtype)

        def attend(a, qg, i=i):
            c = (d, a)
            pk, pv, base = kv_at(paged_kv, layout, c)
            k0, k1 = layout.attn[a].kv
            pk, pv, views = pk[k0 - base:k1 - base], pv[k0 - base:k1 - base], inp.at(c)
            if ragged:
                return ragged_paged_attention(qg, pk, pv, views["table"], views["start"], views["q_lens"], i)
            return paged_attention_chunk(qg, pk, pv, views["table"], views["start"], i)

        x = sharded_layer(x, shard_layer_weights(params, layout, i, cfg, d), cfg, layout, d, inp, write_kv, attend)
    x = rms_norm(x, tree_at(params, layout, red)["final_norm"], cfg.norm_eps)
    if compact:
        return unembed_sharded(x, params, layout, d, inp, subset=True)
    if at_slot:
        x = x[torch.arange(B, device=x.device), inp.at(red)["logits_at"].long()]
    return unembed_sharded(x, params, layout, d, inp)


def decode_step_paged(
    params: dict[str, Any],
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B]
    positions: torch.Tensor,  # [B] slot this token is written to
    page_table: torch.Tensor,  # [B, Pmax] int32
    paged_kv: dict[str, torch.Tensor],  # k/v: [K, L, N, Psz, hd]
    *,
    layout=None,  # parallel.mesh.ServeLayout: the sharded forward
) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
    """One decode step for the whole batch; returns ([B, V] logits, pools),
    the pools updated in place. The S=1 case of ``decode_chunk_paged``, so
    one forward body serves both: each layer launches the kernel with one
    query a row (``paged_attention``'s case)."""
    logits, pools = decode_chunk_paged(
        params, cfg, tokens[:, None], positions, page_table, paged_kv, layout=layout
    )
    return logits[:, 0], pools
