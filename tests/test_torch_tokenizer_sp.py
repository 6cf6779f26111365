"""The SentencePiece vocabulary of the port against the reference's, on the
CPU: the in-tree ``ModelProto`` codec writes the same model (with
``byte_fallback`` declared where the reference's writer omits it), the unigram
encoder gives the same ids and the decoder the same text over a seeded set
of strings (NFKC and whitespace cases among them), ``token_bytes()`` is the
same list, ``make_tokenizer("sp:<path>")`` serves it, and a greedy float32
``/plan`` over the vocab, with the reference's random weights carried
across through a checkpoint file, is byte-identical to the reference's.
"""

import asyncio
import dataclasses
import random

import jax
import jax.numpy as jnp
import pytest

from mcpx.core.config import MCPXConfig as JConfig
from mcpx.engine.engine import InferenceEngine as JEngine
from mcpx.models import sp_model as jsp
from mcpx.models.gemma.config import GemmaConfig as JGemmaConfig
from mcpx.models.gemma.params import load_or_init as jload_or_init
from mcpx.models.tokenizer import make_tokenizer as jmake_tokenizer
from mcpx.models.train import save_npz
from mcpx.planner.llm import LLMPlanner as JPlanner
from mcpx.server.factory import build_control_plane as jbuild
from mcpx_torch.core.config import MCPXConfig
from mcpx_torch.engine.engine import InferenceEngine
from mcpx_torch.models import sp_model
from mcpx_torch.models.gemma.config import GemmaConfig
from mcpx_torch.models.tokenizer import SentencePieceTokenizer, make_tokenizer
from mcpx_torch.planner.llm import LLMPlanner
from mcpx_torch.registry.base import ServiceRecord
from mcpx_torch.server.factory import build_control_plane

ALPHABET = (
    list("abcdefghijklmnopqrstuvwxyz0123456789-_ ") + list('{}[]":,')
    + ["fetch", "auth", "then", "please", "summarize", '{"steps":[{"s":"', '"],"next":[]}']
    # NFKC and NMT cases: ligature, fullwidth, circled digit, superscript,
    # NBSP, tab, CR, zero-width space, BOM, ideographic space, soft hyphen.
    + ["ﬁ", "ｆｅｔｃｈ", "①", "²", " ", "\t", "\r", "​", "﻿", "　", "­", "é", "Ω", "🙂"]
)


def _strings(n: int = 64, seed: int = 11) -> list:
    rng = random.Random(seed)
    return [
        "".join(rng.choice(ALPHABET) for _ in range(rng.randint(0, 24))) for _ in range(n)
    ] + ["", " ", "  fetch  then  ", "FETCH Auth", '{"steps":[{"s":"auth-fetch-0001","in":["query"],"next":[]}]}']


def _model(pkg, variant: str):
    m = pkg.tiny_model()
    if variant in ("nmt_nfkc", "nmt_nfkc_cf"):
        m.normalizer_name = variant
        m.precompiled_charsmap = b"\x01"  # a non-empty charsmap arms the normalizer
    elif variant == "dummy_prefix":
        m.add_dummy_prefix = True
        m.remove_extra_whitespaces = True
    return m


VARIANTS = ["plain", "nmt_nfkc", "nmt_nfkc_cf", "dummy_prefix"]


@pytest.mark.parametrize("variant", VARIANTS + ["no_byte_pieces"])
def test_codec_matches_reference(variant):
    """The port's file is the reference's, with ``TrainerSpec.byte_fallback``
    declared when the model has byte pieces (the sentencepiece library
    refuses the reference's file without it); each package reads the
    other's file to the same model, and without byte pieces the bytes are
    the reference's exactly."""
    ref, port = _model(jsp, variant), _model(sp_model, variant)
    if variant == "no_byte_pieces":
        for m in (ref, port):
            m.pieces = [p for p in m.pieces if p.type != sp_model.BYTE]
    blob, ours = ref.dumps(), port.dumps()
    assert (ours == blob) == (variant == "no_byte_pieces")
    assert jsp.SPModel.loads(ours).dumps() == blob
    again = sp_model.SPModel.loads(blob)
    assert again.dumps() == ours
    pb = pytest.importorskip("transformers.utils.sentencepiece_model_pb2_new")
    proto = pb.ModelProto()
    proto.ParseFromString(ours)
    assert proto.trainer_spec.byte_fallback == (variant != "no_byte_pieces")
    assert (proto.trainer_spec.unk_id, proto.trainer_spec.bos_id, proto.trainer_spec.eos_id) == (0, 1, 2)
    assert [(p.piece, p.score, p.type) for p in again.pieces] == [
        (p.piece, p.score, p.type) for p in jsp.SPModel.loads(blob).pieces
    ]
    jenc, enc = jsp.UnigramEncoder(ref), sp_model.UnigramEncoder(again)
    for text in _strings():
        ids = enc.encode(text)
        assert ids == jenc.encode(text), repr(text)
        assert enc.decode(ids) == jenc.decode(ids), repr(text)
    assert [enc.piece_bytes(i) for i in range(len(port.pieces))] == [
        jenc.piece_bytes(i) for i in range(len(ref.pieces))
    ]


@pytest.mark.parametrize("backend", ["auto", "intree"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_tokenizer_matches_reference(tmp_path, variant, backend):
    path = str(tmp_path / "tiny.model")
    _model(jsp, variant).save(path)
    ref = jmake_tokenizer(f"sp:{path}")
    tok = make_tokenizer(f"sp:{path}") if backend == "auto" else SentencePieceTokenizer(path, backend="intree")
    assert isinstance(tok, SentencePieceTokenizer)
    assert (tok.bos_id, tok.eos_id, tok.pad_id, tok.n_real, tok.vocab_size) == (
        ref.bos_id, ref.eos_id, ref.pad_id, ref.n_real, ref.vocab_size,
    )
    assert tok.token_bytes() == ref.token_bytes()
    tb = tok.token_bytes()
    for text in _strings():
        ids = tok.encode(text, bos=True, eos=True)
        assert ids == ref.encode(text, bos=True, eos=True), repr(text)
        assert tok.decode(ids) == ref.decode(ids)
        body = ids[1:-1]
        if variant == "dummy_prefix":
            continue  # decode strips the dummy prefix's space, in both packages
        # The grammar product's contract: concatenated surfaces = decode.
        assert b"".join(tb[i] for i in body if tb[i] is not None) == tok.decode(body).encode("utf-8")


def test_package_backend_is_refused_without_the_package(tmp_path):
    """``backend="package"`` needs the ``sentencepiece`` package; an unknown
    backend is refused."""
    path = str(tmp_path / "tiny.model")
    sp_model.tiny_model().save(path)
    try:
        import sentencepiece  # noqa: F401
    except ImportError:
        with pytest.raises(ImportError):
            SentencePieceTokenizer(path, backend="package")
    with pytest.raises(ValueError, match="backend"):
        SentencePieceTokenizer(path, backend="nope")


# ------------------------------------------------------------ /plan over SP
SERVICES = [
    {"name": "auth-fetch-0001", "endpoint": "http://svc/auth", "output_schema": {"user": "str"}},
    {"name": "billing-score-0002", "endpoint": "http://svc/billing", "input_schema": {"user": "str"}},
    {"name": "order-validate-0003", "endpoint": "http://svc/order", "input_schema": {"user": "str"}},
]
INTENTS = ["please fetch then score", "validate the order then score billing", "fetch auth user"]


def _config(sp_path: str, ckpt: str) -> dict:
    return {
        "model": {"size": "test", "max_seq_len": 256, "vocab": f"sp:{sp_path}", "checkpoint_path": ckpt},
        "engine": {
            "use_pallas": False, "max_batch_size": 4, "max_decode_len": 48, "kv_page_size": 16,
            "max_pages_per_seq": 16, "temperature": 0.0, "data_axis": 1, "model_axis": 1,
        },
        "planner": {"kind": "llm", "max_plan_retries": 0},
        "tracing": {"enabled": False},
    }


async def _plans(cp, record_cls) -> list:
    for svc in SERVICES:
        await cp.registry.put(record_cls.from_dict(svc))
    await cp.startup()
    try:
        return [(await cp.plan(i, use_cache=False))[0] for i in INTENTS]
    finally:
        await cp.planner.engine.aclose()


def test_greedy_plan_over_sp_vocab_matches_reference_in_float32(tmp_path):
    """Random weights of the test preset at the SP vocab's width, drawn by
    the reference and written to a float32 checkpoint that both packages
    load: every plan LLM-authored and byte-identical as ``Plan.to_json()``."""
    from mcpx.registry.base import ServiceRecord as JRecord

    sp_path = str(tmp_path / "tiny.model")
    jsp.tiny_model().save(sp_path)
    vocab = jmake_tokenizer(f"sp:{sp_path}").vocab_size
    jmodel = dataclasses.replace(JGemmaConfig.named("test", vocab_size=vocab, max_seq_len=256), dtype="float32")
    params, _ = jload_or_init(jmodel, seed=0)
    ckpt = str(tmp_path / "random_f32.npz")
    save_npz(ckpt, jax.tree.map(lambda a: jnp.asarray(a, jnp.float32), params), dtype="float32")
    cfg = _config(sp_path, ckpt)
    jcfg = JConfig.from_dict(cfg)
    ref = asyncio.run(_plans(jbuild(jcfg, planner=JPlanner(JEngine(jcfg, model_cfg=jmodel), jcfg.planner)), JRecord))
    tcfg = MCPXConfig.from_dict(cfg)
    model = dataclasses.replace(GemmaConfig.named("test", vocab_size=vocab, max_seq_len=256), dtype="float32")
    engine = InferenceEngine(tcfg, model_cfg=model, device="cpu")
    port = asyncio.run(_plans(build_control_plane(tcfg, planner=LLMPlanner(engine, tcfg.planner), device="cpu"),
                              ServiceRecord))
    assert isinstance(engine.tokenizer, SentencePieceTokenizer)
    assert engine.model_cfg.dtype == "float32"
    assert [p.origin for p in ref] == ["llm"] * len(INTENTS), [p.explanation for p in ref]
    assert [p.to_json() for p in port] == [p.to_json() for p in ref]
    assert [p.to_steps_json() for p in port] == [p.to_steps_json() for p in ref]
