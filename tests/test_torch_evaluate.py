"""The port's offline plan-quality eval (``mcpx_torch.planner.evaluate``)
against the reference's, on the CPU over the committed checkpoint: the
registry and shortlist tiers, served in bfloat16 and in int8, give the
reference's quality dicts exactly. Both engines run the checkpoint in
float32: in bfloat16 near-ties flip greedy picks between the packages (and
with the CPU's thread count). ``model.dtype`` is read by neither package's
engine, so each package's ``GemmaConfig.named`` is wrapped for the test;
the checkpoint's bf16 weights are exact in float32."""

import asyncio
import dataclasses

import pytest

from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.planner.evaluate import evaluate_planner as jevaluate
from mcpx_torch.core.errors import EngineError
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.planner.evaluate import evaluate_planner

from test_torch_model import CKPT

PROTOCOL = dict(registry_size=120, n_intents=4)


def _pin_float32(monkeypatch):
    for cls in (JGemmaConfig, GemmaConfig):
        named = cls.named.__func__
        monkeypatch.setattr(cls, "named", classmethod(
            lambda c, *a, _named=named, **kw: dataclasses.replace(_named(c, *a, **kw), dtype="float32")))


@pytest.mark.parametrize("constrain_names,quantize", [
    ("registry", "none"),
    ("shortlist", "none"),
    ("shortlist", "int8"),
])
def test_quality_dicts_equal_the_reference(monkeypatch, constrain_names, quantize):
    _pin_float32(monkeypatch)
    kw = dict(checkpoint=CKPT, constrain_names=constrain_names, quantize=quantize, **PROTOCOL)
    ref = asyncio.run(jevaluate(use_pallas=False, **kw))
    port = asyncio.run(evaluate_planner(device="cpu", **kw))
    assert port == ref
    assert port["quantize"] == quantize and port["llm_share"] == 1.0 and port["node_f1_n"] == PROTOCOL["n_intents"]


def test_default_device_is_the_card(monkeypatch):
    """``device=None`` is CUDA, and without a card the eval raises rather
    than falling back to the CPU."""
    monkeypatch.setattr("torch.cuda.is_available", lambda: False)
    with pytest.raises(EngineError, match="CUDA is not available"):
        asyncio.run(evaluate_planner(checkpoint=CKPT, **PROTOCOL))
