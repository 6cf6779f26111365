"""The port's Gemma converter (``mcpx_torch.models.gemma.convert``) against
the reference's, on the reference's synthetic trees of the published Flax
layout (``tests/test_convert.py``): the MQA split and the MHA fused
projections convert bit-equal, a bfloat16 conversion gives the reference's
bfloat16 values, the layer count is refused as the reference refuses it,
and the chain convert → ``save_npz`` → engine with a SentencePiece vocab
plans on the CPU."""

import asyncio
import sys

import numpy as np
import pytest

from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.convert import convert_flax_gemma as jconvert
from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma import convert as tconvert
from mcpx_torch.models.gemma.config import GemmaConfig

from test_convert import _published_tree

DIMS = dict(vocab_size=384, d_model=16, n_heads=4, head_dim=8, d_ff=32)


def _flat(params) -> dict:
    out = {"embed": params["embed"], "final_norm": params["final_norm"]}
    out.update({f"layers/{k}": v for k, v in params["layers"].items()})
    return out


@pytest.mark.parametrize("n_layers,n_kv_heads,fused,v_src,dtype", [
    (3, 1, False, 300, "float32"),
    (2, 4, True, 384, "float32"),
    (3, 1, False, 300, "bfloat16"),
], ids=["mqa", "mha_fused", "mqa_bf16"])
def test_conversion_is_bit_equal_to_the_reference(n_layers, n_kv_heads, fused, v_src, dtype):
    kw = dict(DIMS, n_layers=n_layers, n_kv_heads=n_kv_heads, dtype=dtype)
    tree = _published_tree(JGemmaConfig(**kw), fused_qkv=fused, v_src=v_src)
    ref, port = _flat(jconvert(tree, JGemmaConfig(**kw))), _flat(tconvert.convert_flax_gemma(tree, GemmaConfig(**kw)))
    assert ref.keys() == port.keys()
    for k, v in ref.items():
        # numpy has no bfloat16 of its own: the port's bfloat16 conversion
        # holds the bfloat16 values in float32 arrays.
        assert port[k].dtype == np.float32 and port[k].shape == v.shape, k
        np.testing.assert_array_equal(port[k], np.asarray(v, np.float32), err_msg=k)
    assert not port["embed"][v_src:].any()


def test_layer_count_mismatch_rejected():
    small = _published_tree(JGemmaConfig(**DIMS, n_layers=2, n_kv_heads=1), fused_qkv=False, v_src=300)
    with pytest.raises(EngineError, match="2 layers"):
        tconvert.convert_flax_gemma(small, GemmaConfig(**DIMS, n_layers=4, n_kv_heads=1))
    assert tconvert.infer_n_layers({f"transformer/layer_{i}/x": 0 for i in range(5)}) == 5
    with pytest.raises(EngineError, match="not a Gemma Flax checkpoint"):
        tconvert.infer_n_layers({"embedder/x": 0})
    assert tconvert._flatten({"a": {"b": 1}, "c": 2}) == {"a/b": 1, "c": 2}


def test_convert_checkpoint_without_orbax_is_refused(monkeypatch, tmp_path):
    """The published checkpoint is an Orbax directory; without the package
    the port says so by name."""
    monkeypatch.setitem(sys.modules, "orbax", None)
    monkeypatch.setitem(sys.modules, "orbax.checkpoint", None)
    with pytest.raises(EngineError, match="orbax"):
        tconvert.convert_checkpoint(str(tmp_path / "src"), str(tmp_path / "dst.npz"), "test", 384)
    with pytest.raises(EngineError, match="orbax"):
        tconvert.main([str(tmp_path / "src"), str(tmp_path / "dst.npz"), "--size", "test"])


def test_chain_convert_save_serve_sp_vocab(tmp_path):
    """Published layout -> convert -> ``save_npz`` -> the port's engine with a
    SentencePiece vocab (the in-tree codec) -> a grammar-constrained LLM
    plan, on the CPU: the chain a user with downloaded weights runs."""
    from mcpx_torch.core.config import MCPXConfig
    from mcpx_torch.engine.engine import InferenceEngine
    from mcpx_torch.models.sp_model import tiny_model
    from mcpx_torch.models.tokenizer import SentencePieceTokenizer
    from mcpx_torch.models.train import save_npz
    from mcpx_torch.planner.base import PlanContext
    from mcpx_torch.planner.llm import LLMPlanner
    from mcpx_torch.registry.base import ServiceRecord
    from mcpx_torch.registry.memory import InMemoryRegistry

    sp_path = str(tmp_path / "tiny.model")
    tiny_model().save(sp_path)
    tok = SentencePieceTokenizer(sp_path)
    cfg = GemmaConfig.named("test", vocab_size=tok.vocab_size)
    tree = _published_tree(JGemmaConfig.named("test", vocab_size=tok.vocab_size), fused_qkv=False, v_src=tok.n_real)
    ckpt = str(tmp_path / "converted.npz")
    save_npz(ckpt, tconvert.convert_flax_gemma(tree, cfg))
    mcfg = MCPXConfig.from_dict({
        "model": {"size": "test", "max_seq_len": 256, "vocab": f"sp:{sp_path}", "checkpoint_path": ckpt},
        "engine": {"max_batch_size": 2, "max_decode_len": 48, "kv_page_size": 16, "max_pages_per_seq": 16,
                   "temperature": 0.0},
        "planner": {"kind": "llm", "max_plan_retries": 0},
    })

    async def go():
        reg = InMemoryRegistry()
        await reg.put(ServiceRecord(name="auth-fetch-0001", endpoint="http://svc/auth", output_schema={"user": "str"}))
        await reg.put(ServiceRecord(name="billing-score-0002", endpoint="http://svc/billing",
                                    input_schema={"user": "str"}))
        eng = InferenceEngine(mcfg, device="cpu")
        planner = LLMPlanner(eng, mcfg.planner)
        try:
            plan = await planner.plan("please fetch then score", PlanContext(registry=reg))
        finally:
            await eng.aclose()
        assert eng.model_cfg.vocab_size == tok.vocab_size
        return plan

    plan = asyncio.run(go())
    assert plan.origin == "llm", plan.explanation
    assert plan.nodes and all(n.service in ("auth-fetch-0001", "billing-score-0002") for n in plan.nodes)
