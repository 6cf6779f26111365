"""Gemma-architecture decoder in PyTorch: plain functions on a dict of
layer-stacked tensors.

Port of ``mcpx/models/gemma/model.py`` with the same parameter keys and
layouts (``embed`` [V, D]; ``layers/wq`` [L, D, H, hd], ``wk``/``wv``
[L, D, K, hd], ``wo`` [L, H, hd, D], ``w_gate``/``w_up`` [L, D, F],
``w_down`` [L, F, D], norms [L, D]; ``final_norm`` [D]), so weights carry
across one-to-one (``params.params_from_numpy``). The layer stack is a
Python loop over the leading axis; on int8 weights (``quant.py``) each
layer is dequantized inside that loop, one layer at a time. Numerics follow the reference: RMSNorm in
fp32 with scale ``1 + w``; half-split RoPE; tanh-approximate GeLU; the
embedding scaled by ``sqrt(d_model)`` cast to the activation dtype first;
attention logits and softmax in fp32; the tied unembedding with fp32 output.

On a ``parallel.mesh.ServeLayout`` (``layout=``; weights laid out by
``params.shard_major``, and spread by ``params.on_cards`` on a mesh of
cards) the forward is the reference's per-coordinate program, each row
block over ``data`` at its data coordinate ``d``: each model shard projects
its query heads (and its KV heads where they split) and its ``d_ff`` columns
on its card, the partial outputs after ``wo`` and ``w_down`` are summed at
the block's reducing coordinate ``(d, 0)`` in shard order (in fp32 for a
bf16 model, as a psum), the embedding reads each token from the vocabulary
shard that holds it, and the unembedding's shards give the logits of their
vocabulary range, joined in vocabulary order on the control card. What
crosses between coordinates goes through ``parallel/transfer.py``; on a
virtual mesh every copy is the tensor itself.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch
import torch.nn.functional as F

from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.quant import (
    _CONTRACT_AXES,
    _dequant,
    _is_qleaf,
    dequant_layer,
    embed_lookup,
    unembed,
)
from mcpx_torch.parallel.transfer import Inputs, count_forward, homes, join, kv_tree, reduce, send, tree_at, trees

Params = dict[str, Any]
KVCache = dict[str, torch.Tensor]

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32, "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[str(name)]


# --------------------------------------------------------------------- init
def param_shapes(cfg: GemmaConfig) -> dict[str, tuple[int, ...]]:
    """Each parameter's shape by leaf name (the layer leaves stacked over
    ``n_layers``)."""
    L, D, H, K, hd, Fd, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.d_ff, cfg.vocab_size,
    )
    return {
        "embed": (V, D),
        "pre_attn_norm": (L, D),
        "pre_mlp_norm": (L, D),
        "wq": (L, D, H, hd),
        "wk": (L, D, K, hd),
        "wv": (L, D, K, hd),
        "wo": (L, H, hd, D),
        "w_gate": (L, D, Fd),
        "w_up": (L, D, Fd),
        "w_down": (L, Fd, D),
        "final_norm": (D,),
    }


def init_params(
    cfg: GemmaConfig,
    generator: torch.Generator,
    device: "torch.device | str" = "cpu",
    leaf_transform=None,
) -> Params:
    """Random-init parameters in ``cfg.dtype``, layer-stacked: normal draws
    scaled by 1/sqrt(fan_in) from ``generator`` (a seeded ``torch.Generator``
    on ``device``); norms start at zero (scale 1). ``leaf_transform(name,
    tensor)`` is applied to each leaf as it is created (``quant.
    leaf_quantizer`` for int8 serving), so the untransformed tree never
    exists at once. The draws differ from the reference package's
    ``jax.random`` ones; carry weights across with ``params_from_numpy``
    where equality matters."""
    dtype = torch_dtype(cfg.dtype)
    t = leaf_transform or (lambda _name, w: w)
    shapes = param_shapes(cfg)

    def normal(name):
        # Layer-stacked weights are drawn one layer at a time so the fp32
        # staging buffer stays one layer wide at full width.
        shape = shapes[name]
        # A weight's fan-in is the product of its contraction axes.
        fan_in = math.prod(shape[a] for a in _CONTRACT_AXES[name])
        if len(shape) == 2:
            w = torch.randn(shape, generator=generator, device=device)
            return t(name, (w / math.sqrt(fan_in)).to(dtype))
        out = torch.empty(shape, dtype=dtype, device=device)
        for i in range(shape[0]):
            w = torch.randn(shape[1:], generator=generator, device=device)
            out[i] = (w / math.sqrt(fan_in)).to(dtype)
        return t(name, out)

    def zeros(name):
        return t(name, torch.zeros(shapes[name], dtype=dtype, device=device))

    return {
        "embed": normal("embed"),
        "layers": {
            "pre_attn_norm": zeros("pre_attn_norm"),
            "pre_mlp_norm": zeros("pre_mlp_norm"),
            **{name: normal(name) for name in ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")},
        },
        "final_norm": zeros("final_norm"),
    }


def init_kv_cache(cfg: GemmaConfig, batch: int, max_len: int, device="cpu", dtype=None, layout=None) -> KVCache:
    """A dense [L, B, S, K, hd] cache; on a ``layout`` of several devices,
    one on each (``transfer.kv_tree``) over the KV heads its coordinates
    read, every row of the batch."""
    d = torch_dtype(dtype or cfg.dtype)

    def zeros(k_heads, dev):
        shape = (cfg.n_layers, batch, max_len, k_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=d, device=dev), "v": torch.zeros(shape, dtype=d, device=dev)}

    return kv_tree(layout, device, cfg.n_kv_heads, zeros)


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


def embed_tokens(embed: Any, tokens: torch.Tensor, cfg: GemmaConfig) -> torch.Tensor:
    """Embedding rows (int8 rows times their scales on a quantized table),
    scaled by sqrt(d_model)."""
    x = embed_lookup(embed, tokens, torch_dtype(cfg.dtype))
    # torch.full fills on the device: no host copy, so a CUDA graph can
    # capture it. The scale is rounded to the model's dtype, as the
    # reference multiplies.
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def layer_weights(params: Params, i: int, cfg: GemmaConfig) -> dict[str, torch.Tensor]:
    """Layer ``i``'s weights: slices of the stacked tree, dequantized to the
    model's dtype on int8 weights (the counterpart of the reference's
    ``dequant_layer`` in its scan body)."""
    return dequant_layer(params["layers"], i, torch_dtype(cfg.dtype))


def mlp(h: torch.Tensor, w: dict[str, torch.Tensor]) -> torch.Tensor:
    gate = torch.matmul(h, w["w_gate"])
    up = torch.matmul(h, w["w_up"])
    return torch.matmul(F.gelu(gate, approximate="tanh") * up, w["w_down"])


def qkv(h: torch.Tensor, w: dict[str, torch.Tensor]):
    """[B, T, D] -> q [B, T, H, hd], k/v [B, T, K, hd] with one layer's
    weights ``w``."""
    q = torch.einsum("btd,dkh->btkh", h, w["wq"])
    k = torch.einsum("btd,dkh->btkh", h, w["wk"])
    v = torch.einsum("btd,dkh->btkh", h, w["wv"])
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
    attend_fn=None,
    logits_at: Optional[torch.Tensor] = None,
    layout=None,
) -> tuple[torch.Tensor, KVCache]:
    """Forward over a [B, T] chunk against a dense [L, B, S, K, hd] cache.
    ``positions`` [B, T] are absolute and double as cache write slots;
    ``mask`` is [B, T, S] (True = attend). ``attend_fn(qg, k_cache,
    v_cache, mask)`` swaps the attention op over the layer's cache after
    this chunk's K/V are written into it (ring attention for
    sequence-parallel prefill); ``mask`` reaches only it. ``logits_at`` [B]:
    unembed only that position per row -> [B, V]. The cache is updated in
    place and returned. ``layout``: the sharded forward (module docstring),
    ``attend_fn`` called per attention shard on its heads of the cache."""
    if layout is not None:
        return _forward_sharded(params, cfg, tokens, positions, kv_cache, mask, attend_fn, logits_at, layout)
    B, T = tokens.shape
    x = embed_tokens(params["embed"], tokens, cfg)
    b_idx = torch.arange(B, device=tokens.device)[:, None]
    attend_fn = attend_fn or _attend
    for i in range(cfg.n_layers):

        def attend(qg, k, v, i=i):
            kv_cache["k"][i][b_idx, positions] = k.to(kv_cache["k"].dtype)
            kv_cache["v"][i][b_idx, positions] = v.to(kv_cache["v"].dtype)
            return attend_fn(qg, kv_cache["k"][i], kv_cache["v"][i], mask)

        x = _layer(x, layer_weights(params, i, cfg), cfg, positions, attend)
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    if logits_at is not None:
        x = x[torch.arange(B, device=x.device), logits_at.long()]  # [B, D]
    return unembed(x, params["embed"]), kv_cache


def _layer(
    x: torch.Tensor, w: dict[str, torch.Tensor], cfg: GemmaConfig, positions: torch.Tensor, attend
) -> torch.Tensor:
    """One decoder layer over [B, T, D]. ``attend(qg, k, v)`` takes the
    roped queries [B, T, K, G, hd] and this chunk's roped keys and values
    [B, T, K, hd] and returns the attention [B, T, K, G, hd]."""
    B, T = x.shape[:2]
    h = rms_norm(x, w["pre_attn_norm"], cfg.norm_eps)
    q, k, v = qkv(h, w)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    qg = q.reshape(B, T, cfg.n_kv_heads, cfg.q_per_kv, cfg.head_dim)
    attn = attend(qg, k, v).reshape(B, T, cfg.n_heads * cfg.head_dim)
    wo = w["wo"].reshape(cfg.n_heads * cfg.head_dim, cfg.d_model)
    x = x + torch.matmul(attn, wo)
    h = rms_norm(x, w["pre_mlp_norm"], cfg.norm_eps)
    return x + mlp(h, w)


# ------------------------------------------------------------ model shards
def _shard(leaf: Any, name: str, layout, m: int, i: Optional[int] = None, dtype=None) -> Any:
    """Model shard ``m``'s block of a leaf laid out by ``params.shard_major``
    (the whole leaf where ``layout`` does not split it), at layer ``i`` when
    given, dequantized to ``dtype`` when given on an int8 leaf. ``leaf`` is
    from the tree shard ``m``'s coordinate reads (``transfer.tree_at``)."""
    dim = layout.sharded.get(name)
    j = layout.local(m)

    def pick(t, split):
        t = t if i is None else t[i]
        return t[j] if split else t

    if _is_qleaf(leaf):
        q = pick(leaf["int8"], dim is not None)
        s = pick(leaf["scale"], dim is not None and dim not in _CONTRACT_AXES[name])
        return {"int8": q, "scale": s} if dtype is None else _dequant(q, s, dtype)
    return pick(leaf, dim is not None)


def shard_layer_weights(params: Params, layout, i: int, cfg: GemmaConfig, d: int = 0) -> list[dict[str, torch.Tensor]]:
    """Layer ``i``'s weights for each of ``layout``'s model shards at data
    coordinate ``d``: shard ``m``'s blocks of the split leaves, contiguous
    views of its card's tree, dequantized on int8 weights; the leaves kept
    whole go to shard 0 alone, whose coordinate reduces the shards'
    outputs and computes what does not split."""
    dtype = torch_dtype(cfg.dtype)
    out: list[dict[str, torch.Tensor]] = [{} for _ in range(layout.model)]
    for m, w in enumerate(out):
        for name, leaf in tree_at(params, layout, (d, m))["layers"].items():
            if name in layout.sharded or m == 0:
                w[name] = _shard(leaf, name, layout, m, i, dtype)
    return out


def whole_embed(params: Params, layout) -> Any:
    """The [V, D] embedding (or its int8 leaf) of a tree laid out for
    ``layout``: its vocabulary shards are consecutive rows, so this is a
    view on a virtual mesh; on several devices, the shards of data
    coordinate 0 copied to the control device and joined there."""
    if layout is None:
        return params["embed"]
    e = tree_at(params, layout, (0, 0))["embed"]
    if "embed" not in layout.sharded:
        return e
    if len(trees(params, layout)) == 1:
        return {k: v.flatten(0, 1) for k, v in e.items()} if _is_qleaf(e) else e.flatten(0, 1)
    blocks = [_shard(tree_at(params, layout, (0, m))["embed"], "embed", layout, m) for m in range(layout.model)]
    if _is_qleaf(e):
        return {k: torch.cat([b[k].to(layout.control) for b in blocks]) for k in e}
    return torch.cat([b.to(layout.control) for b in blocks])


def _vocab_shards(params: Params, layout, d: int):
    """(model coordinate, start, stop, block) of each distinct vocabulary
    shard of the embedding at data coordinate ``d``."""
    if layout.n_vocab == 1:
        return [(0, 0, layout.cfg.vocab_size, tree_at(params, layout, (d, 0))["embed"])]
    return [(m, v0, v1, _shard(tree_at(params, layout, (d, m))["embed"], "embed", layout, m))
            for m, (v0, v1) in enumerate(layout.vocab)]


def embed_tokens_sharded(params: Params, cfg: GemmaConfig, layout, d: int, inp) -> torch.Tensor:
    """``embed_tokens`` of row block ``d`` (``inp``: its ``transfer.
    Inputs``) with the table split over the vocabulary: each vocabulary
    shard gathers the rows it holds, and each token's row is selected from
    the shard that holds it at the reducing coordinate ``(d, 0)`` (exact)."""
    dtype = torch_dtype(cfg.dtype)
    red = (d, 0)
    x = None
    for m, v0, v1, block in _vocab_shards(params, layout, d):
        toks = inp.at((d, m))["tokens"]
        rows = send(embed_lookup(block, (toks.long() - v0).clamp(0, v1 - v0 - 1), dtype), (d, m), red, layout)
        if x is None:
            x = rows
        else:
            held = inp.at(red)["tokens"]
            x = torch.where(((held >= v0) & (held < v1))[..., None], rows, x)
    return x * torch.full((), math.sqrt(cfg.d_model), dtype=x.dtype, device=x.device)


def unembed_sharded(x: torch.Tensor, params: Params, layout, d: int, inp, subset: bool = False) -> torch.Tensor:
    """``quant.unembed`` of row block ``d``'s final activations ``x`` (at
    ``(d, 0)``) by vocabulary shard, on the control card: each shard's
    [.., V/M] logits joined in vocabulary order; with ``subset`` (``inp``'s
    ``cols`` [C] token ids), each shard's logits of the subset columns it
    holds, selected into [.., C]."""
    red, ctrl = (d, 0), (0, 0)
    parts = []
    for m, v0, v1, block in _vocab_shards(params, layout, d):
        xm = send(x, red, (d, m), layout)
        cols = (inp.at((d, m))["cols"].long() - v0).clamp(0, v1 - v0 - 1) if subset else None
        parts.append(((d, m), v0, v1, unembed(xm, block, subset=cols)))
    if not subset:
        return join([(c, p) for c, _, _, p in parts], ctrl, layout)
    out = None
    for c, v0, v1, p in parts:
        p = send(p, c, ctrl, layout)
        if out is None:
            out = p
        else:
            cols = inp.at(ctrl)["cols"]
            out = torch.where((cols >= v0) & (cols < v1), p, out)
    return out


def sharded_layer(
    x: torch.Tensor, ws: list[dict[str, torch.Tensor]], cfg: GemmaConfig, layout, d: int, inp, write_kv, attend,
) -> torch.Tensor:
    """One decoder layer of row block ``d`` over [B, T, D] as ``layout``'s
    model shards compute it, ``ws`` their weights (``shard_layer_weights``).
    ``x`` lives at the reducing coordinate ``(d, 0)``, which norms it, sends
    the normed activations to each shard and sums their partial outputs
    after ``wo`` and ``w_down`` in shard order. ``inp`` is the block's
    ``transfer.Inputs`` (``positions`` at every coordinate).
    ``write_kv(a, src, k, v)`` stores the roped keys and values [B, T, K',
    hd] that attention shard ``a`` projected at ``src`` (None: every KV
    head, projected once at ``(d, 0)`` where they do not split);
    ``attend(a, qg)`` returns shard ``a``'s attention [B, T, K', G', hd]."""
    B, T = x.shape[:2]
    red = (d, 0)
    h = rms_norm(x, ws[0]["pre_attn_norm"], cfg.norm_eps)
    sent = {red: h}

    def h_at(c):
        if c not in sent:
            sent[c] = send(h, red, c, layout)
        return sent[c]

    def kv(w, c):
        pos = inp.at(c)["positions"]
        k = apply_rope(torch.einsum("btd,dkh->btkh", h_at(c), w["wk"]), pos, cfg.rope_theta)
        return k, torch.einsum("btd,dkh->btkh", h_at(c), w["wv"])

    if not layout.kv_split:
        write_kv(None, red, *kv(ws[0], red))
    parts = []
    for a, shard in enumerate(layout.attn):
        c, w = (d, a), ws[a]
        q = apply_rope(torch.einsum("btd,dkh->btkh", h_at(c), w["wq"]), inp.at(c)["positions"], cfg.rope_theta)
        if layout.kv_split:
            write_kv(a, c, *kv(w, c))
        qg = q.reshape(B, T, shard.kv[1] - shard.kv[0], shard.groups, cfg.head_dim).contiguous()
        attn = attend(a, qg).reshape(B, T, -1)
        parts.append((c, torch.matmul(attn, w["wo"].reshape(-1, cfg.d_model))))
    x = x + reduce(parts, red, layout)
    h2 = rms_norm(x, ws[0]["pre_mlp_norm"], cfg.norm_eps)
    parts = [((d, f), mlp(send(h2, red, (d, f), layout), ws[f])) for f in range(layout.n_ff)]
    return x + reduce(parts, red, layout)


def kv_at(kv: KVCache, layout, coord) -> tuple[torch.Tensor, torch.Tensor, int]:
    """(k, v, first KV head) of the cache or pools coordinate ``coord``
    writes and reads: its device's (``transfer.tree_at``)."""
    card = layout.card(*coord)
    t = trees(kv, layout)[card]
    return t["k"], t["v"], layout.kv_range(card)[0]


def _forward_sharded(params, cfg, tokens, positions, kv_cache, mask, attend_fn, logits_at, layout):
    """``forward`` on ``layout``: each row block over ``data`` at its data
    coordinate, its rows of each card's cache written through views and
    mirrored to every data replica (``transfer.homes``); the logits joined
    on the control card."""
    count_forward()
    B, T = tokens.shape
    blocks = layout.rows(B)
    attend_fn = attend_fn or _attend
    ctrl = (0, 0)
    outs = []
    for d, (r0, r1) in enumerate(blocks):
        rows = slice(r0, r1)
        inp = Inputs(layout, ctrl, tokens=tokens[rows], positions=positions[rows],
                     logits_at=None if logits_at is None else logits_at[rows])
        msk = mask if len(blocks) == 1 else mask[rows]
        masks: dict = {}
        x = embed_tokens_sharded(params, cfg, layout, d, inp)
        for i in range(cfg.n_layers):

            def write_kv(a, src, k, v, i=i):
                h0 = 0 if a is None else layout.attn[a].kv[0]
                for dst, (k0, k1), fresh in homes(layout, a):
                    kk = send(k[:, :, k0 - h0:k1 - h0], src, dst, layout)
                    vv = send(v[:, :, k0 - h0:k1 - h0], src, dst, layout)
                    pos = inp.derive(dst, "pos", lambda views: views["positions"].long())
                    if fresh:
                        ck, cv, base = kv_at(kv_cache, layout, dst)
                        b_idx = inp.derive(dst, "b_idx", lambda _v: torch.arange(r1 - r0, device=pos.device)[:, None])
                        ck[i, rows][b_idx, pos, k0 - base:k1 - base] = kk.to(ck.dtype)
                        cv[i, rows][b_idx, pos, k0 - base:k1 - base] = vv.to(cv.dtype)

            def attend(a, qg, i=i):
                c = (d, a)
                ck, cv, base = kv_at(kv_cache, layout, c)
                k0, k1 = layout.attn[a].kv
                if c not in masks:
                    masks[c] = send(msk, ctrl, c, layout)
                return attend_fn(qg, ck[i, rows][:, :, k0 - base:k1 - base], cv[i, rows][:, :, k0 - base:k1 - base],
                                 masks[c])

            x = sharded_layer(x, shard_layer_weights(params, layout, i, cfg, d), cfg, layout, d, inp, write_kv,
                              attend)
        x = rms_norm(x, tree_at(params, layout, (d, 0))["final_norm"], cfg.norm_eps)
        if logits_at is not None:
            x = x[torch.arange(r1 - r0, device=x.device), inp.at((d, 0))["logits_at"].long()]
        outs.append(unembed_sharded(x, params, layout, d, inp))
    return (outs[0] if len(outs) == 1 else torch.cat(outs)), kv_cache


# -------------------------------------------------------------- entrypoints
def prefill(
    params: Params,
    cfg: GemmaConfig,
    tokens: torch.Tensor,
    seq_lens: torch.Tensor,
    kv_cache: KVCache,
    last_only: bool = False,
    layout=None,
) -> tuple[torch.Tensor, KVCache]:
    """Prefill a padded [B, T] batch; ``seq_lens`` [B] masks right-padding.
    Returns logits [B, T, V] (or [B, V], each row's last valid position,
    with ``last_only``) and the filled cache. ``layout``: the sharded
    forward."""
    B, T = tokens.shape
    S = (kv_cache["k"] if layout is None else kv_at(kv_cache, layout, (0, 0))[0]).shape[2]
    dev = tokens.device
    positions = torch.arange(T, device=dev).expand(B, T)
    s = torch.arange(S, device=dev)
    causal = s[None, None, :] <= positions[:, :, None]
    valid = s[None, None, :] < seq_lens.long().to(dev)[:, None, None]
    return forward(
        params, cfg, tokens, positions, kv_cache, causal & valid,
        logits_at=(seq_lens - 1) if last_only else None, layout=layout,
    )


def train_forward(params: Params, cfg: GemmaConfig, tokens: torch.Tensor, seq_lens: torch.Tensor) -> torch.Tensor:
    """Logits [B, T, V] of a padded [B, T] batch without a KV cache, for
    training: what ``prefill`` gives over a fresh cache of exactly ``T``
    slots (the reference trainer's loss, ``mcpx/models/train.py``), with the
    same mask (causal, and keys at or past ``seq_lens`` masked out). Each
    layer attends over its own keys and values, so nothing is written in
    place and autograd can differentiate it."""
    B, T = tokens.shape
    dev = tokens.device
    positions = torch.arange(T, device=dev).expand(B, T)
    s = torch.arange(T, device=dev)
    mask = (s[None, None, :] <= positions[:, :, None]) & (s[None, None, :] < seq_lens.long().to(dev)[:, None, None])
    dtype = torch_dtype(cfg.dtype)
    x = embed_tokens(params["embed"], tokens, cfg)
    for i in range(cfg.n_layers):
        x = _layer(x, layer_weights(params, i, cfg), cfg, positions,
                   lambda qg, k, v: _attend(qg, k.to(dtype), v.to(dtype), mask))
    x = rms_norm(x, params["final_norm"], cfg.norm_eps)
    return unembed(x, params["embed"])
