"""Planner-model training: an AdamW fine-tune of the in-tree decoder.

The PyTorch port of ``mcpx/models/train.py``. It teaches the in-tree
Gemma-architecture decoder the intent→plan mapping on the synthetic workload
corpus (``models/corpus.py``), step for step as the reference does:

  - the loss is shifted, masked next-token cross entropy in float32 over the
    logits of ``model.train_forward`` (the reference's ``prefill`` over a
    fresh cache of exactly ``L`` slots, without the cache);
  - the update is optax's chain, written out: ``clip_by_global_norm``
    (``g`` if ``‖g‖ < clip``, else ``g / ‖g‖ · clip``), then AdamW
    (``torch.optim.AdamW``: b1 0.9, b2 0.999, eps 1e-8 after the
    bias-corrected square root, decoupled decay times the learning rate),
    with no decay on any leaf whose path holds ``"norm"``, and a warmup-cosine
    learning rate evaluated at the update count *before* the update, so the
    first update has lr 0 while the moments still take its gradient;
  - batches are drawn with numpy as the reference draws them
    (``default_rng(seed)``: a permutation splits off the eval rows, then one
    ``choice`` a step), so both packages train on the same rows;
  - parameters are float32 leaf tensors on ``device`` (CUDA unless the caller
    asks for the CPU), and matmuls run in full float32: the port never turns
    on TF32 (``torch.backends.cuda.matmul.allow_tf32`` stays False);
  - no host sync a step: the losses stay device tensors, one is read back per
    ``log_every`` tick and the reported ones at the end;
  - ``mesh`` (``parallel/mesh.py``) is data parallelism: each batch splits
    over ``batch_axes(mesh)`` by the reference's per-axis divisibility rule,
    and each shard runs its forward and backward on the device of its first
    coordinate. On a virtual mesh of ``device`` the shards' backwards add
    their gradients into the parameters' in turn; on a mesh of cards each
    card holds a float32 replica of the parameters, its gradients are copied
    to ``device`` and added there in replica order, and the replicas take
    the stepped parameters back. One clip and one AdamW step follow, on
    ``device``. Each shard's loss divides by the *whole* batch's mask sum,
    so the sum of the shards' losses and gradients is the unsharded step's.

Random init draws from the port's generator (``init_params``), not the
reference's ``jax.random``; pass ``init`` to start both from one tree.
Checkpoints are the reference's ``.npz`` format: ``/``-joined keys, bfloat16
as ``uint16`` bit patterns under a ``bf16:`` prefix, ``savez_compressed``, so
each package's ``load_npz`` reads the other's file bit for bit.
"""

from __future__ import annotations

import dataclasses
import math
import os
from collections import deque
from dataclasses import dataclass
from typing import Any, Optional

import numpy as np
import torch
import torch.nn.functional as F

from mcpx_torch.core.errors import EngineError
from mcpx_torch.device import resolve_device
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import Params, init_params, torch_dtype, train_forward
from mcpx_torch.models.gemma.params import _tensor, load_npz  # noqa: F401  (load_npz reads save_npz's files)
from mcpx_torch.parallel.mesh import batch_axes, canonical, indices_map, serving_devices
from mcpx_torch.parallel.transfer import copy_into, copy_to


@dataclass
class TrainConfig:
    steps: int = 2000
    batch_size: int = 32
    lr: float = 3e-3
    warmup_steps: int = 100
    weight_decay: float = 0.01
    clip_norm: float = 1.0
    seed: int = 0
    # Fraction of rows held out for eval (never sampled into train batches).
    eval_fraction: float = 0.05
    log_every: int = 100


def lr_schedule(tcfg: TrainConfig):
    """optax's ``warmup_cosine_decay_schedule(0, lr, warmup, max(steps,
    warmup + 1))`` as a function of the update count, in float32."""
    lr, warmup = tcfg.lr, tcfg.warmup_steps
    decay = max(tcfg.steps, warmup + 1) - warmup

    def at(count: int) -> float:
        if count < warmup:  # linear_schedule(0, lr, warmup)
            return float(np.float32(-lr) * (np.float32(1) - np.float32(count) / np.float32(warmup)) + np.float32(lr))
        t = np.float32(min(count - warmup, decay))
        cosine = np.float32(0.5) * (np.float32(1) + np.cos(np.float32(math.pi) * t / np.float32(decay)))
        return float(np.float32(lr) * cosine)

    return at


def _loss(params: Params, cfg: GemmaConfig, tokens, seq_lens, loss_mask, denom=None) -> torch.Tensor:
    """Masked next-token cross entropy summed over the rows and divided by
    ``denom``: by default this batch's mask sum (at least 1); a data-parallel
    shard passes the whole batch's."""
    logits = train_forward(params, cfg, tokens, seq_lens)  # [B, L, V] f32
    labels = tokens[:, 1:].long()
    lp = F.log_softmax(logits[:, :-1].float(), dim=-1)
    ll = torch.gather(lp, -1, labels[..., None])[..., 0]
    m = loss_mask[:, :-1].float()
    return -(ll * m).sum() / (torch.clamp(m.sum(), min=1.0) if denom is None else denom)


def _batch_shards(mesh, n_rows: int) -> list[slice]:
    """The row blocks of an ``n_rows`` batch: the whole batch without a
    mesh; else split over every batch axis of the mesh that still divides,
    outer first (the reference's per-axis rule), one block per distinct
    slice."""
    return [rows for rows, _ in _shard_devices(mesh, n_rows)]


def _shard_devices(mesh, n_rows: int) -> list[tuple[slice, Optional[torch.device]]]:
    """``_batch_shards``' blocks in order, each with the device of the first
    mesh coordinate that holds it (None without a mesh)."""
    if mesh is None:
        return [(slice(0, n_rows), None)]
    axes: list[str] = []
    ways = 1
    for a in batch_axes(mesh):
        if n_rows % (ways * mesh.shape[a]) == 0:
            axes.append(a)
            ways *= mesh.shape[a]
    blocks: dict[tuple[int, int], torch.device] = {}
    for coord, (rows,) in indices_map((n_rows,), (tuple(axes) if axes else None,), mesh).items():
        blocks.setdefault(rows.indices(n_rows)[:2], mesh.devices[coord])
    return [(slice(lo, hi), blocks[(lo, hi)]) for lo, hi in sorted(blocks)]


def _leaves(params: Params, prefix: str = "") -> list[tuple[str, torch.Tensor]]:
    out = []
    for k, v in params.items():
        if isinstance(v, dict):
            out += _leaves(v, f"{prefix}{k}/")
        else:
            out.append((f"{prefix}{k}", v))
    return out


def _clip_by_global_norm(grads: list[torch.Tensor], clip: float) -> None:
    """optax's ``clip_by_global_norm`` in place, decided on the device: each
    gradient divided by ``‖g‖`` and multiplied by ``clip`` when ``‖g‖ >=
    clip``, else divided and multiplied by one (exact)."""
    norm = torch.sqrt(sum(torch.linalg.vector_norm(g).square() for g in grads))
    keep = norm < clip
    one = torch.ones((), device=norm.device)
    div = torch.where(keep, one, norm)
    mul = torch.where(keep, one, torch.full((), clip, device=norm.device))
    for g in grads:
        g.div_(div).mul_(mul)


def train(
    model_cfg: GemmaConfig,
    corpus,
    tcfg: Optional[TrainConfig] = None,
    *,
    device: "torch.device | str | None" = None,
    init: Optional[Params] = None,
    log_fn=None,
    mesh=None,
) -> tuple[Params, dict]:
    """Train and return (float32 params, report). ``corpus`` is a
    ``models.corpus.Corpus``; ``init`` warm-starts from existing params (a
    tree of tensors, cast to float32 on ``device``). ``mesh`` shards each
    batch over its data axes (data parallelism; the parameters and the
    optimizer state stay on ``device``, the mesh's first coordinate, and
    each other card of the mesh holds a replica)."""
    tcfg = tcfg or TrainConfig()
    dev = resolve_device(device)
    if mesh is not None:
        serving_devices(mesh)
        if canonical(mesh.devices.flat[0]) != canonical(dev):
            raise EngineError(f"train on {mesh}: the mesh's first coordinate, {mesh.devices.flat[0]}, is not the "
                              f"training device ({dev})")
    cfg = dataclasses.replace(model_cfg, dtype="float32")
    rng = np.random.default_rng(tcfg.seed)

    n = corpus.tokens.shape[0]
    n_eval = max(1, int(n * tcfg.eval_fraction)) if n > 8 else 0
    perm = rng.permutation(n)
    eval_idx, train_idx = perm[:n_eval], perm[n_eval:]
    if len(train_idx) == 0:
        raise ValueError("corpus too small to train on")

    if init is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(tcfg.seed)
        init = init_params(cfg, gen, dev)
    params = _map(init, lambda t: t.detach().to(device=dev, dtype=torch.float32).clone().requires_grad_(True))
    leaves = _leaves(params)
    opt = torch.optim.AdamW(
        [
            {"params": [t for path, t in leaves if "norm" not in path], "weight_decay": tcfg.weight_decay},
            # No weight decay on norm scales (Gemma RMSNorm scales sit at 0 = 1x).
            {"params": [t for path, t in leaves if "norm" in path], "weight_decay": 0.0},
        ],
        lr=0.0, betas=(0.9, 0.999), eps=1e-8,
    )
    sched = lr_schedule(tcfg)

    B = tcfg.batch_size
    # The batches' rows, drawn up front in the reference's order (its loop
    # draws nothing else), and the corpus placed once: a step copies nothing
    # from the host.
    takes = np.array([rng.choice(train_idx, size=B, replace=len(train_idx) < B) for _ in range(tcfg.steps)],
                     np.int64).reshape(tcfg.steps, B)
    tokens = torch.from_numpy(np.ascontiguousarray(corpus.tokens)).to(dev)
    seq_lens = torch.from_numpy(np.ascontiguousarray(corpus.seq_lens)).to(dev)
    loss_mask = torch.from_numpy(np.ascontiguousarray(corpus.loss_mask)).to(dev)
    takes_d = torch.from_numpy(takes).to(dev)

    first_loss = None
    tail_losses: "deque" = deque(maxlen=20)
    loss_log: list[tuple[int, float]] = []
    home = canonical(dev)
    shards = [(rows, canonical(d or dev)) for rows, d in _shard_devices(mesh, B)]
    # Each device the shards run on holds a float32 replica of the
    # parameters: the training device's is ``params`` itself, each other
    # card's a copy refreshed after every step.
    replicas = {home: params}
    for d in dict.fromkeys(d for _, d in shards):
        if d != home:
            replicas[d] = _map(params, lambda t, d=d: copy_to(t.detach(), d).requires_grad_(True))
    for step in range(tcfg.steps):
        take = takes_d[step]
        tk, sl, lm = tokens[take], seq_lens[take], loss_mask[take]
        denom = torch.clamp(lm[:, :-1].float().sum(), min=1.0)
        for rep in replicas.values():
            for _, t in _leaves(rep):
                t.grad = None
        loss = None
        for rows, d in shards:
            # Each shard's backward adds its gradients into its replica's.
            part = _loss(replicas[d], cfg, copy_to(tk[rows], d), copy_to(sl[rows], d), copy_to(lm[rows], d),
                         copy_to(denom, d))
            part.backward()
            part = copy_to(part.detach(), home)
            loss = part if loss is None else loss + part
        # The other replicas' gradients join the parameters' in replica
        # order, as the backwards on one device accumulate them.
        for rep in replicas.values():
            if rep is not params:
                for (_, t), (_, r) in zip(leaves, _leaves(rep)):
                    g = copy_to(r.grad, home)
                    t.grad = g if t.grad is None else t.grad + g
        _clip_by_global_norm([t.grad for _, t in leaves], tcfg.clip_norm)
        lr = sched(step)
        for group in opt.param_groups:
            group["lr"] = lr
        opt.step()
        with torch.no_grad():
            for rep in replicas.values():
                if rep is not params:
                    for (_, t), (_, r) in zip(leaves, _leaves(rep)):
                        copy_into(r, t)
        if first_loss is None:
            first_loss = loss
        tail_losses.append(loss)
        if tcfg.log_every and (step % tcfg.log_every == 0 or step == tcfg.steps - 1):
            loss_f = float(loss)  # one sync per log_every tick, not per step
            loss_log.append((step, loss_f))
            if log_fn is not None:
                log_fn(f"step {step}/{tcfg.steps} loss {loss_f:.4f}")

    out = _map(params, lambda t: t.detach())
    report = {
        "first_loss": float(first_loss),
        "final_loss": float(np.mean([float(x) for x in tail_losses])),
        "loss_log": loss_log,
    }
    if n_eval:
        # Accumulated on the device; one readback after the loop.
        hits = tot = 0
        with torch.no_grad():
            for s in range(0, n_eval, B):
                take = torch.from_numpy(eval_idx[s: s + B]).to(dev)
                tk = tokens[take]
                logits = train_forward(out, cfg, tk, seq_lens[take])
                pred = torch.argmax(logits[:, :-1], dim=-1)
                m = loss_mask[take][:, :-1]
                hits = hits + ((pred == tk[:, 1:].long()) & m).sum()
                tot = tot + m.sum()
        report["eval_token_accuracy"] = int(hits) / max(int(tot), 1)
    return out, report


def _map(tree: Params, fn) -> Params:
    return {k: _map(v, fn) if isinstance(v, dict) else fn(v) for k, v in tree.items()}


# ------------------------------------------------------------- checkpoints
def flatten_params(params: Params, prefix: str = "") -> dict[str, Any]:
    """Nested tree -> ``{"layers/wq": leaf, ...}`` (leaves as they are)."""
    return dict(_leaves(params, prefix))


def unflatten_params(flat: dict) -> Params:
    tree: Params = {}
    for key, v in flat.items():
        parts = key.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def save_npz(path: str, params: Params, dtype: str = "bfloat16") -> None:
    """Serving checkpoint: one compressed .npz, weights cast to the serving
    dtype (round to nearest even, as the reference casts). bfloat16 has no
    numpy dtype, so arrays are stored as uint16 bit patterns under a
    ``bf16:`` key prefix (decoded by ``load_npz``). Leaves may be tensors or
    numpy arrays (numpy bfloat16 too); keys are written in sorted order, as
    the reference's."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    flat = flatten_params(params)
    blob: dict[str, np.ndarray] = {}
    for k in sorted(flat):
        v = flat[k]
        t = v.detach().cpu() if isinstance(v, torch.Tensor) else _tensor(v, bf16_bits=False)
        if dtype == "bfloat16":
            blob["bf16:" + k] = t.to(torch.bfloat16).view(torch.int16).numpy().view(np.uint16)
        else:
            blob[k] = t.to(torch_dtype(dtype)).numpy()
    np.savez_compressed(path, **blob)
