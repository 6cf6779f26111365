"""Parameters: carry the reference package's weights across, or random-init.

``params_from_numpy`` takes a parameter tree as numpy arrays — nested, or
flat with ``"layers/wq"`` keys as ``.npz`` checkpoints store them, bf16
either as a numpy bfloat16 dtype or as ``uint16`` bit patterns under a
``bf16:`` key prefix — and returns the port's nested dict of tensors with
the same keys and layouts. ``load_or_init`` reads an ``.npz`` checkpoint
through it, or draws random weights from a seed.
"""

from __future__ import annotations

import os
from typing import Any, Optional

import numpy as np
import torch

from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.gemma.model import Params, init_params, torch_dtype


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
    ``dtype`` (None keeps each array's own type)."""
    if isinstance(dtype, str):
        dtype = torch_dtype(dtype)
    out: Params = {}

    def put(path: list[str], value: torch.Tensor) -> None:
        node = out
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[path[-1]] = value.to(device=device, dtype=dtype or value.dtype)

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
    L, D, H, K, hd, F, V = (
        cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
        cfg.head_dim, cfg.d_ff, cfg.vocab_size,
    )
    return {
        "embed": (V, D),
        "final_norm": (D,),
        "layers/pre_attn_norm": (L, D),
        "layers/pre_mlp_norm": (L, D),
        "layers/wq": (L, D, H, hd),
        "layers/wk": (L, D, K, hd),
        "layers/wv": (L, D, K, hd),
        "layers/wo": (L, H, hd, D),
        "layers/w_gate": (L, D, F),
        "layers/w_up": (L, D, F),
        "layers/w_down": (L, F, D),
    }


def _check_shapes(params: Params, cfg: GemmaConfig, path: str) -> None:
    flat = {"embed": params.get("embed"), "final_norm": params.get("final_norm")}
    flat.update({f"layers/{k}": v for k, v in params.get("layers", {}).items()})
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
) -> tuple[Params, str]:
    """(params, "checkpoint" | "random"): an ``.npz`` checkpoint cast to
    ``cfg.dtype``, or random weights drawn from ``seed``."""
    if checkpoint_path:
        path = os.path.abspath(checkpoint_path)
        if not os.path.exists(path):
            raise EngineError(f"checkpoint not found: {path}")
        if not path.endswith(".npz"):
            raise EngineError(f"the PyTorch port reads .npz checkpoints only, not {path}")
        params = load_npz(path, device, torch_dtype(cfg.dtype))
        _check_shapes(params, cfg, path)
        return params, "checkpoint"
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return init_params(cfg, gen, device), "random"


def n_bytes(params: Optional[Params]) -> int:
    if params is None:
        return 0
    total = 0
    for v in params.values():
        total += n_bytes(v) if isinstance(v, dict) else v.numel() * v.element_size()
    return total
