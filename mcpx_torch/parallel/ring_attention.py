"""Ring attention: sequence-parallel causal attention over a ``seq`` mesh axis.

The PyTorch port of ``mcpx/parallel/ring_attention.py``, driven from one
process as the reference's ``shard_map`` is:

  - tokens are sharded contiguously over the ``seq`` axis: shard ``i`` holds
    global positions ``[i*Tl, (i+1)*Tl)``, its queries on its coordinate's
    device;
  - each shard keeps its queries resident and passes its K/V block on to the
    next seq shard's device (``transfer.copy_to``, a counted
    ``.to(device, non_blocking=True)``, the reference's ``ppermute``); the
    last step makes no hop;
  - softmax is accumulated online (running max and sum in float32), so no
    shard ever holds the full [T, T] scores;
  - causality and right padding come from *global* positions; no [B, T, S]
    mask is ever built.

The batch splits over ``data`` and the KV heads over ``model`` where they
divide. On a virtual mesh (one device at every coordinate) the hops are
no-ops and the whole ring runs on that device. The block products are plain
torch, as the reference's are jnp: the reference has no Pallas kernel here.

``ring_prefill`` runs the Gemma forward with the attention op swapped
(``model.forward(attend_fn=...)``).
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from mcpx_torch.core.errors import ConfigError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import KVCache, Params, forward, init_kv_cache, kv_at
from mcpx_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, SEQ_AXIS, Mesh, _axis, canonical, indices_map
from mcpx_torch.parallel.transfer import copy_to

_NEG = -1e30


def _ring_block_attend(q, k_local, v_local, seq_lens, *, idx: int, n_shards: int, block_len: int):
    """The body of one (data, seq, model) coordinate: ``q`` [B, Tl, K, G,
    hd] local queries, ``k_local``/``v_local`` [B, Tl, K, hd] the local K/V
    block, ``seq_lens`` [B] global valid lengths, ``idx`` the shard's seq
    index. A generator: each ``yield`` is the body's half of the ring hop (it
    hands over its block and receives the previous shard's); it returns the
    [B, Tl, K, G, hd] float32 output. Queries past ``seq_lens`` get exact
    zeros (``l == 0``)."""
    B, Tl, K, G, hd = q.shape
    dev = q.device
    scale = 1.0 / math.sqrt(hd)
    ar = torch.arange(Tl, device=dev)
    q_pos = idx * block_len + ar  # [Tl] global query positions
    lens = seq_lens.long()
    qf = q.float()

    m = torch.full((B, Tl, K, G), _NEG, dtype=torch.float32, device=dev)
    l = torch.zeros((B, Tl, K, G), dtype=torch.float32, device=dev)
    o = torch.zeros((B, Tl, K, G, hd), dtype=torch.float32, device=dev)
    k_blk, v_blk = k_local, v_local
    for step in range(n_shards):
        # After `step` hops the resident block originated at shard
        # (idx - step) mod n: its global positions anchor the mask.
        src = (idx - step) % n_shards
        kv_pos = src * block_len + ar
        keep = (kv_pos[None, :] <= q_pos[:, None]) & (kv_pos[None, None, :] < lens[:, None, None])  # [B, Tl, Tl]
        keep_b = keep[:, :, None, None, :]
        scores = torch.einsum("btkgh,bskh->btkgs", qf, k_blk.float()) * scale
        scores = torch.where(keep_b, scores, _NEG)
        new_m = torch.maximum(m, scores.amax(dim=-1))
        # exp(NEG - NEG) = 1 on a fully masked row: the mask multiplies p so
        # such rows add nothing (l stays exact, no -inf NaNs).
        p = torch.exp(scores - new_m[..., None]) * keep_b
        alpha = torch.exp(m - new_m)
        l = l * alpha + p.sum(dim=-1)
        o = o * alpha[..., None] + torch.einsum("btkgs,bskh->btkgh", p, v_blk.float())
        m = new_m
        if step < n_shards - 1:
            k_blk, v_blk = yield k_blk, v_blk
    return o / torch.where(l == 0.0, 1.0, l)[..., None]


def _run_ring(bodies: list, devices: list) -> list:
    """Drive one ring's bodies in lockstep. Every body hops at the same
    step: each block goes to the next seq shard's device (``i -> i+1 mod
    n``). Returns each body's output."""
    n = len(bodies)
    out: list = [None] * n
    incoming: list = [None] * n
    while True:
        sent, done = [None] * n, False
        for i, body in enumerate(bodies):
            try:
                sent[i] = body.send(incoming[i])
            except StopIteration as stop:
                out[i], done = stop.value, True
        if done:
            return out
        incoming = [tuple(copy_to(t, devices[i]) for t in sent[i - 1]) for i in range(n)]


def ring_attention(q, k, v, seq_lens, mesh: Mesh) -> torch.Tensor:
    """Causal self-attention with T sharded over the ``seq`` mesh axis: q
    [B, T, K, G, hd], k/v [B, T, K, hd], ``seq_lens`` [B]. The contract of
    ``model._attend`` restricted to self-attention (S == T, causal and
    right-padding mask from ``seq_lens``). The output is [B, T, K, G, hd] in
    ``v``'s dtype on ``q``'s device."""
    if SEQ_AXIS not in mesh.shape:
        raise ConfigError("ring_attention requires a mesh with a 'seq' axis")
    n = mesh.shape[SEQ_AXIS]
    B, T, K = q.shape[:3]
    if T % n != 0:
        raise ConfigError(f"sequence length {T} must divide seq axis {n}")
    spec = (_axis(mesh, DATA_AXIS, B), SEQ_AXIS, _axis(mesh, MODEL_AXIS, K), None, None)
    s_pos = mesh.axis_names.index(SEQ_AXIS)
    # The coordinates of one ring differ only in their seq index. One ring
    # runs per distinct (batch, head) block: rings that replicate a block
    # (over an axis that does not divide) would compute the same output.
    by_rest: dict = {}
    for coord, idx in indices_map(tuple(q.shape), spec, mesh).items():
        by_rest.setdefault(coord[:s_pos] + coord[s_pos + 1:], {})[coord] = idx
    rings: dict = {}
    for ring in by_rest.values():
        first = next(iter(ring.values()))
        rings.setdefault((first[0].indices(B)[:2], first[2].indices(K)[:2]), ring)
    out = torch.empty(q.shape, dtype=v.dtype, device=q.device)
    for ring in rings.values():
        coords = sorted(ring, key=lambda c: c[s_pos])
        devices = [canonical(mesh.devices[c]) for c in coords]
        bodies = []
        for dev, c in zip(devices, coords):
            idx = ring[c]
            bodies.append(_ring_block_attend(
                copy_to(q[idx], dev), copy_to(k[idx[:4]], dev), copy_to(v[idx[:4]], dev),
                copy_to(seq_lens[idx[0]], dev), idx=c[s_pos], n_shards=n, block_len=T // n,
            ))
        for c, res in zip(coords, _run_ring(bodies, devices)):
            out[ring[c]] = copy_to(res.to(v.dtype), q.device)
    return out


def ring_prefill(
    params: Params,
    cfg: GemmaConfig,
    tokens: torch.Tensor,  # [B, T], T % mesh.seq == 0
    seq_lens: torch.Tensor,  # [B]
    mesh: Mesh,
    kv_cache: Optional[KVCache] = None,
    last_only: bool = False,
    layout=None,
) -> tuple[torch.Tensor, KVCache]:
    """Sequence-parallel prefill: ``model.prefill``'s contract with the
    attention op swapped for ring attention. The [B, T, S] mask is never
    built; the returned cache is the standard dense [L, B, T, K, hd] one.
    ``last_only`` returns [B, V] logits at each row's last valid position.
    ``layout`` (``parallel.mesh.ServeLayout``): the projections around the
    ring run per model shard, each shard's heads through a ring of their
    own; the batch stays whole (the data coordinates are the seq axis)."""
    B, T = tokens.shape
    layout = None if layout is None else layout.model_only()
    if kv_cache is None:
        kv_cache = init_kv_cache(cfg, B, T, device=tokens.device, dtype=cfg.dtype, layout=layout)
    width = (kv_cache["k"] if layout is None else kv_at(kv_cache, layout, (0, 0))[0]).shape[2]
    if width != T:
        raise ConfigError(f"ring_prefill requires cache length == T ({width} != {T})")
    dev = tokens.device
    positions = torch.arange(T, device=dev).expand(B, T)
    lens = seq_lens.to(dev)

    def attend(qg, k_cache, v_cache, _mask):
        return ring_attention(qg, k_cache, v_cache, lens, mesh)

    # forward() reads the mask only inside attend_fn: a scalar placeholder.
    placeholder = torch.zeros((), dtype=torch.bool, device=dev)
    return forward(
        params, cfg, tokens, positions, kv_cache, placeholder, attend,
        logits_at=(lens - 1) if last_only else None,
        layout=layout,
    )

