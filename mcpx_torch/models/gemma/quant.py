"""Weight-only int8 quantization for serving.

The port's copy of ``mcpx/models/gemma/quant.py`` in torch, with the same
arithmetic, so a quantized leaf is bit-equal in both packages.

Scheme: symmetric absmax per OUTPUT channel of each matmul (the scale axes
are every non-contracted dimension of the weight's serving product),
weights stored int8 with a float32 scale. The forwards dequantize one layer
at a time inside their layer loop (``dequant_layer``), so the int8 tensors
are what lives in device memory and the full-precision stack never exists.
The embedding gathers int8 rows with their per-row scales
(``embed_lookup``), and the tied unembedding applies the per-row scale on
its fp32 output (``unembed``). Exactness is not claimed: an opt-in serving
mode (``model.quantize="int8"``), default off, held close to the
full-precision model by the tests.

Representation: each quantized leaf becomes ``{"int8": i8, "scale": f32}``,
a plain dict, so the parameter tree stays a nested dict of tensors.
"""

from __future__ import annotations

import math
from typing import Any, Optional

import torch

from mcpx_torch.parallel.transfer import OnCards

Params = dict[str, Any]

# Contraction axes of each weight's serving product (model.py): scales
# broadcast over these, per channel over the rest.
_CONTRACT_AXES: dict[str, tuple[int, ...]] = {
    "embed": (1,),  # [V, D]: the unembedding contracts D; lookup scales per row V
    "wq": (1,),  # [L, D, H, hd]: contracts D
    "wk": (1,),
    "wv": (1,),
    "wo": (1, 2),  # [L, H, hd, D]: contracts H*hd
    "w_gate": (1,),  # [L, D, F]: contracts D
    "w_up": (1,),
    "w_down": (1,),  # [L, F, D]: contracts F
}


def _quantize_leaf(w: torch.Tensor, axes: tuple[int, ...]) -> dict[str, torch.Tensor]:
    """Absmax in f32 over ``axes``, ``max(absmax, 1e-8) / 127``, round half
    to even, clip to ±127: the reference's steps, bit for bit."""
    w32 = w.float()
    absmax = torch.amax(torch.abs(w32), dim=axes, keepdim=True)
    # A tensor divisor, not the Python float 127.0: on CUDA, PyTorch turns
    # division by a host scalar into multiplication by its reciprocal,
    # which is an ulp off in some scales and flips the codes at rounding
    # boundaries.
    scale = torch.clamp(absmax, min=1e-8) / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(w32 / scale), -127, 127).to(torch.int8)
    return {"int8": q, "scale": scale.float()}


def quantize_params(params: Params) -> Params:
    """Full-precision tree -> int8-weight tree. Norms stay as they are: they
    are O(D) and their 1 + w convention is precision-relevant."""
    out: Params = {"embed": _quantize_leaf(params["embed"], _CONTRACT_AXES["embed"])}
    out["layers"] = {
        name: _quantize_leaf(w, _CONTRACT_AXES[name]) if name in _CONTRACT_AXES else w
        for name, w in params["layers"].items()
    }
    out["final_norm"] = params["final_norm"]
    return out


def _is_qleaf(node: Any) -> bool:
    return isinstance(node, dict) and set(node.keys()) == {"int8", "scale"}


def is_quantized(params: Params) -> bool:
    """Whether the weights are int8 (any card's tree of a
    ``transfer.OnCards``)."""
    if isinstance(params, OnCards):
        return any(is_quantized(t) for t in params.trees.values())
    return _is_qleaf(params.get("embed"))


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    return (q.float() * scale).to(dtype)


def dequant_params(params: Params, dtype: torch.dtype = torch.float32) -> Params:
    """Whole-tree dequantization, for tests and offline tools only: the
    serving forwards dequantize one layer at a time (``dequant_layer``)."""

    def walk(node: Any) -> Any:
        if _is_qleaf(node):
            return _dequant(node["int8"], node["scale"], dtype)
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        return node

    return walk(params)


def dequant_layer(lp: dict[str, Any], i: int, dtype: torch.dtype) -> dict[str, torch.Tensor]:
    """Layer ``i`` of the stacked layer tree, its quantized weights
    dequantized to ``dtype`` (plain leaves sliced as they are). Called inside
    the forwards' layer loop, so at most one layer's dequantized weights
    exist at a time."""
    return {
        k: _dequant(v["int8"][i], v["scale"][i], dtype) if _is_qleaf(v) else v[i]
        for k, v in lp.items()
    }


def embed_lookup(embed: Any, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Embedding rows for ``tokens``: int8 rows times their per-row scales on
    a quantized embedding (the full table is never dequantized), a plain
    gather otherwise."""
    idx = tokens.long()
    if _is_qleaf(embed):
        return _dequant(embed["int8"][idx], embed["scale"][idx], dtype)
    return embed[idx].to(dtype)


def unembed(x: torch.Tensor, embed: Any, subset: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Tied unembedding, fp32 logits: x @ embed.T. On a quantized embedding
    the per-row scale multiplies the fp32 output (s_v · Σ_d x_d q_vd), so no
    dequantized table is formed. ``subset`` [C] (token ids) restricts it to
    those rows: [..., C] logits."""
    if _is_qleaf(embed):
        q, s = embed["int8"], embed["scale"]
        if subset is not None:
            q, s = q[subset.long()], s[subset.long()]
        return torch.matmul(x.float(), q.float().t()) * s[..., 0]
    w = embed if subset is None else embed[subset.long()]
    return torch.matmul(x.float(), w.float().t())


def quant_pspecs(cfg, mesh) -> Params:
    """Spec tree matching the QUANTIZED parameter structure: int8 leaves keep
    ``param_pspecs``'s layout; scales drop the sharding on the contraction
    axes (their keepdims-1 dims)."""
    from mcpx_torch.parallel.mesh import param_pspecs

    base = param_pspecs(cfg, mesh)

    def q(name: str, spec):
        if name not in _CONTRACT_AXES:
            return spec
        axes = _CONTRACT_AXES[name]
        return {"int8": spec, "scale": tuple(None if i in axes else s for i, s in enumerate(spec))}

    return {
        "embed": q("embed", base["embed"]),
        "layers": {k: q(k, v) for k, v in base["layers"].items()},
        "final_norm": base["final_norm"],
    }


def leaf_quantizer(name: str, w: torch.Tensor) -> Any:
    """Per-leaf transform for ``init_params(leaf_transform=...)``: quantize
    the named weight as it is created, so the full-precision tree never
    exists (peak memory: the int8 tree plus one full-precision leaf)."""
    if name in _CONTRACT_AXES:
        return _quantize_leaf(w, _CONTRACT_AXES[name])
    return w


def quantized_param_bytes(cfg: Any) -> int:
    """Bytes at rest of the int8 serving parameters of a ``GemmaConfig``,
    from shapes alone: nothing is allocated. ``math.prod`` on Python ints,
    which never wrap."""
    from mcpx_torch.models.gemma.model import param_shapes, torch_dtype

    elt = torch.empty((), dtype=torch_dtype(cfg.dtype)).element_size()
    total = 0
    for name, shape in param_shapes(cfg).items():
        if name in _CONTRACT_AXES:
            axes = _CONTRACT_AXES[name]
            scale = [1 if i in axes else d for i, d in enumerate(shape)]
            total += math.prod(shape) + 4 * math.prod(scale)
        else:
            total += math.prod(shape) * elt
    return total
