"""Parameters: carry the reference package's weights across, or random-init.

``params_from_numpy`` takes a parameter tree as numpy arrays — nested, or
flat with ``"layers/wq"`` keys as ``.npz`` checkpoints store them, bf16
either as a numpy bfloat16 dtype or as ``uint16`` bit patterns under a
``bf16:`` key prefix — and returns the port's nested dict of tensors with
the same keys and layouts. A quantized tree (``quant.py``: ``{"int8",
"scale"}`` leaves) carries across as it is: its int8 codes and f32 scales
keep their types whatever ``dtype`` asks. ``load_or_init`` reads an
``.npz`` checkpoint through it, or draws random weights from a seed, in
int8 with ``quantize="int8"``, and with ``mesh`` lays every leaf that
``param_pspecs`` (``quant_pspecs`` for int8) splits over ``model`` out
shard-major (``shard_major``).
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import Params, init_params, param_shapes, torch_dtype
from mcpx_torch.models.gemma.quant import _is_qleaf, leaf_quantizer, quantize_params
from mcpx_torch.parallel.transfer import OnCards


def _tensor(arr: Any, bf16_bits: bool) -> torch.Tensor:
    arr = np.ascontiguousarray(np.asarray(arr))
    if bf16_bits or arr.dtype.name == "bfloat16":
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(arr.copy())


def params_from_numpy(
    tree: dict[str, Any],
    device: "torch.device | str" = "cpu",
    dtype: "torch.dtype | str | None" = None,
) -> Params:
    """Numpy parameter tree -> nested dict of tensors on ``device``, cast to
    ``dtype`` (None keeps each array's own type). The ``int8`` and ``scale``
    leaves of a quantized weight are never cast."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    out: Params = {}

    def put(path: list[str], value: torch.Tensor) -> None:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        keep = path[-1] in ("int8", "scale")
        node[path[-1]] = value.to(device=device, dtype=value.dtype if keep else dtype or value.dtype)

    def walk(node: dict[str, Any], prefix: list[str]) -> None:
        for key, value in node.items():
            bits = key.startswith("bf16:")
            name = key[len("bf16:"):] if bits else key
            path = prefix + name.split("/")
            if isinstance(value, dict):
                walk(value, path)
            else:
                put(path, _tensor(value, bits))

    walk(tree, [])
    return out


def expected_shapes(cfg: GemmaConfig) -> dict[str, tuple[int, ...]]:
    return {
        name if name in ("embed", "final_norm") else f"layers/{name}": shape
        for name, shape in param_shapes(cfg).items()
    }


def _check_shapes(params: Params, cfg: GemmaConfig, path: str) -> None:
    """A full-precision or quantized tree of ``cfg``'s shapes (an int8 leaf
    is checked by its codes)."""
    flat = {"embed": params.get("embed"), "final_norm": params.get("final_norm")}
    flat.update({f"layers/{k}": v for k, v in params.get("layers", {}).items()})
    flat = {k: v["int8"] if _is_qleaf(v) else v for k, v in flat.items()}
    exp = expected_shapes(cfg)
    problems = [f"missing {k}" for k in exp if flat.get(k) is None]
    problems += [
        f"{k}: shape {tuple(flat[k].shape)} != {s}"
        for k, s in exp.items()
        if flat.get(k) is not None and tuple(flat[k].shape) != s
    ]
    problems += [f"unexpected {k}" for k in sorted(set(flat) - set(exp))]
    if problems:
        raise EngineError(f"checkpoint {path} does not fit model config: {problems[:4]}")


def load_npz(path: str, device="cpu", dtype=None) -> Params:
    with np.load(path) as z:
        return params_from_numpy({k: z[k] for k in z.files}, device, dtype)


def load_or_init(
    cfg: GemmaConfig,
    checkpoint_path: str = "",
    *,
    device: "torch.device | str" = "cpu",
    seed: int = 0,
    quantize: str = "none",
    mesh=None,
) -> tuple[Params, str]:
    """(params, "checkpoint" | "random"): an ``.npz`` checkpoint cast to
    ``cfg.dtype``, or random weights drawn from ``seed``. With
    ``quantize="int8"`` the checkpoint is quantized after it is loaded, and
    the random path quantizes each leaf as it is created, so its
    full-precision tree never exists. ``mesh``: its model shards' leaves
    are laid out by ``shard_major`` (the same weights, each shard's block a
    contiguous view); on a mesh of cards, whose first coordinate is
    ``device``, the weights are made there and spread by ``on_cards``."""
    if quantize not in ("none", "int8"):
        raise EngineError(f"unknown quantize mode {quantize!r}")
    layout = None
    if mesh is not None:
        from mcpx_torch.parallel.mesh import ServeLayout, canonical

        layout = ServeLayout(mesh, cfg)
        if layout.control != canonical(device):
            raise EngineError(
                f"load_or_init on {mesh}: the mesh's first coordinate, {layout.control}, is not the device the "
                f"weights are made on ({device})"
            )
    params, source = _load_or_init(cfg, checkpoint_path, device, seed, quantize)
    if layout is None:
        return params, source
    params = shard_major(params, layout)
    return (on_cards(params, layout) if layout.cross else params), source


def on_cards(params: Params, layout):
    """A shard-major tree (``shard_major``) spread over ``layout``'s cards,
    as a ``transfer.OnCards``: card ``(d, m)`` holds model shard ``m``'s
    block of every split leaf (``[L, 1, *block]``; an int8 leaf's codes and
    the scales it dequantizes with) and, for ``m == 0``, every leaf that is
    not split, which only the reducing coordinate reads. Each block is a
    copy, so the whole tree can go once this returns; the data replicas of
    a shard hold equal copies."""
    from mcpx_torch.models.gemma.quant import _CONTRACT_AXES

    def copy(t: torch.Tensor, card) -> torch.Tensor:
        return torch.empty(t.shape, dtype=t.dtype, device=card).copy_(t, non_blocking=True)

    def block(t: torch.Tensor, m: int, stacked: bool) -> torch.Tensor:
        return t[:, m:m + 1] if stacked else t[m:m + 1]

    cards = {}
    for (d, m), card in sorted(layout.coords().items()):
        tree: Params = {"layers": {}}
        nodes = [("embed", params["embed"], tree), ("final_norm", params["final_norm"], tree)]
        nodes += [(name, leaf, tree["layers"]) for name, leaf in params["layers"].items()]
        for name, leaf, node in nodes:
            dim, stacked = layout.sharded.get(name), name != "embed"
            if dim is None:
                if m == 0:
                    node[name] = ({k: copy(v, card) for k, v in leaf.items()} if _is_qleaf(leaf)
                                  else copy(leaf, card))
                continue
            if _is_qleaf(leaf):
                scale = leaf["scale"]
                scale = scale if dim in _CONTRACT_AXES[name] else block(scale, m, stacked)
                node[name] = {"int8": copy(block(leaf["int8"], m, stacked), card), "scale": copy(scale, card)}
            else:
                node[name] = copy(block(leaf, m, stacked), card)
        cards[card] = tree
    return OnCards(cards)


def _shard_major_leaf(t: torch.Tensor, dim: int, n: int, stacked: bool) -> torch.Tensor:
    """``t`` with dimension ``dim`` split in ``n`` and the shard index moved
    in front of each layer's block: ``[L, n, *block]`` for a layer-stacked
    leaf, ``[n, *block]`` otherwise. Rewritten in place one layer at a time
    (a split of the first dimension of a layer is already in that order), so
    the reordering needs one layer's block of memory beside the tree."""
    x = t if stacked else t[None]
    d = dim - 1 if stacked else dim
    per = x.shape[1:][d] // n
    block = x.shape[1:][:d] + (per,) + x.shape[1:][d + 1:]
    if d > 0:
        for i in range(x.shape[0]):
            x[i].view(-1).copy_(x[i].unflatten(d, (n, per)).movedim(d, 0).reshape(-1))
    y = x.view(x.shape[0], n, *block)
    return y if stacked else y[0]


def shard_major(params: Params, layout) -> Params:
    """The tree laid out for ``layout``'s model shards: every leaf split over
    ``model`` (``layout.sharded``) becomes ``[L, M, *block]`` (``embed``:
    ``[M, V/M, D]``), so shard ``m``'s block of layer ``i`` is the
    contiguous view ``leaf[i, m]``. An int8 leaf's scales follow its codes
    where they are split too (``quant_pspecs``), else stay whole. The
    tensors are reordered in place; other leaves are returned as they are."""
    from mcpx_torch.models.gemma.quant import _CONTRACT_AXES

    n = layout.model
    out: Params = {**params, "layers": dict(params["layers"])}
    for name, dim in layout.sharded.items():
        stacked = name != "embed"
        node = out["layers"] if stacked else out
        leaf = node[name]
        if _is_qleaf(leaf):
            scale = leaf["scale"]
            if dim not in _CONTRACT_AXES[name]:
                scale = _shard_major_leaf(scale, dim, n, stacked)
            node[name] = {"int8": _shard_major_leaf(leaf["int8"], dim, n, stacked), "scale": scale}
        else:
            node[name] = _shard_major_leaf(leaf, dim, n, stacked)
    return out


def _load_or_init(cfg: GemmaConfig, checkpoint_path: str, device, seed: int, quantize: str) -> tuple[Params, str]:
    if checkpoint_path:
        path = os.path.abspath(checkpoint_path)
        if not os.path.exists(path):
            raise EngineError(f"checkpoint not found: {path}")
        if not path.endswith(".npz"):
            raise EngineError(f"the PyTorch port reads .npz checkpoints only, not {path}")
        params = load_npz(path, device, torch_dtype(cfg.dtype))
        _check_shapes(params, cfg, path)
        return (quantize_params(params) if quantize == "int8" else params), "checkpoint"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    transform = leaf_quantizer if quantize == "int8" else None
    return init_params(cfg, gen, device, leaf_transform=transform), "random"


def n_bytes(params: Optional[Params]) -> int:
    """The bytes of a tree's leaves (of every card's tree of a
    ``transfer.OnCards``)."""
    if params is None:
        return 0
    if isinstance(params, OnCards):
        return sum(n_bytes(t) for t in params.trees.values())
    total = 0
    for v in params.values():
        total += n_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
    return total
