"""The port's planner corpus (``mcpx_torch.models.corpus``) and BPE
trainer (``mcpx_torch.models.bpe``) against the reference's: the same
seeds give the same packed rows, loss masks, texts, intents and counters,
exactly; the same texts give the same merges and the same vocab file."""

import json

import numpy as np
import pytest

from mcpx.models import bpe as jbpe
from mcpx.models.corpus import CorpusConfig as JCorpusConfig
from mcpx.models.corpus import build_corpus_sync as jbuild
from mcpx_torch.core.dag import Plan
from mcpx_torch.models import bpe as tbpe
from mcpx_torch.models.corpus import CorpusConfig, build_corpus_sync
from mcpx_torch.utils.synth import synth_registry

ARRAYS = ("tokens", "loss_mask", "seq_lens", "prompt_lens")
COUNTERS = ("texts", "intents", "n_dropped", "n_filtered", "teacher_coverage")


def _assert_same(port, ref):
    for name in ARRAYS:
        a, b = getattr(port, name), getattr(ref, name)
        assert a.dtype == b.dtype and a.shape == b.shape, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    for name in COUNTERS:
        assert getattr(port, name) == getattr(ref, name), name


@pytest.mark.parametrize("kw", [dict(n_examples=96, registry_size=120, seed=3),
                                dict(n_examples=12, registry_size=50, seed=3, intent_seed=99)],
                         ids=["seed3", "intent_seed"])
def test_corpus_equals_the_reference(kw):
    """``CorpusConfig(n_examples=96, registry_size=120, seed=3)`` and the
    ``intent_seed`` case: every array, text and counter equal; on the CPU
    the index ranks on the host, and ``intent_seed`` keeps the registry."""
    port = build_corpus_sync(tbpe.BPETokenizer(), CorpusConfig(**kw), device="cpu")
    _assert_same(port, jbuild(jbpe.BPETokenizer(), JCorpusConfig(**kw)))
    assert port.tokens.shape[0] > 0 and port.tokens.dtype == np.int32
    if "intent_seed" in kw:
        base = build_corpus_sync(tbpe.BPETokenizer(), CorpusConfig(**{**kw, "intent_seed": None}), device="cpu")
        assert base.intents != port.intents
        names = {r.name for r in synth_registry(kw["registry_size"], seed=kw["seed"])}
        assert all(n.service in names for text in port.texts for n in Plan.from_json(text).nodes)


def test_corpus_filter_and_drop_counters_equal_the_reference():
    """A short row budget drops rows and a coverage floor above 1 filters
    every row: the counters and the (empty) arrays equal the reference's."""
    for kw, counter in ((dict(seq_len=110), "n_dropped"), (dict(min_teacher_coverage=1.01), "n_filtered")):
        cfg = dict(n_examples=16, registry_size=60, seed=5, **kw)
        port = build_corpus_sync(tbpe.BPETokenizer(), CorpusConfig(**cfg), device="cpu")
        _assert_same(port, jbuild(jbpe.BPETokenizer(), JCorpusConfig(**cfg)))
        assert getattr(port, counter) > 0, counter


def test_train_bpe_merges_equal_the_reference():
    """The same texts give the same merges, in order, at several budgets and
    frequency floors (ties broken the same way)."""
    texts = jbpe.default_corpus()[:200] + ["héllo wörld ☃ " * 3, "aaaa bbbb aaaa", ""]
    assert tbpe.default_corpus() == jbpe.default_corpus()
    for n_merges, min_freq in ((60, 2), (40, 5), (3000, 4)):
        assert tbpe.train_bpe(texts, n_merges, min_freq) == jbpe.train_bpe(texts, n_merges, min_freq)


def test_train_default_writes_the_reference_vocab_file(tmp_path):
    """``train_default`` at a small budget writes the reference's file byte
    for byte, and the port's tokenizer reads it as the reference's does."""
    port, ref = tmp_path / "port.json", tmp_path / "ref.json"
    blob = tbpe.train_default(str(port), vocab_total=320)
    assert jbpe.train_default(str(ref), vocab_total=320) == blob
    assert port.read_bytes() == ref.read_bytes()
    assert json.loads(port.read_text())["format"] == "mcpx-bpe-v1" and len(blob["tokens"]) == 320 - 259
    text = 'auth-fetch-0001 in:query out:status err=0.01 p50=12 c=0.5'
    assert tbpe.BPETokenizer(str(port)).encode(text) == jbpe.BPETokenizer(str(ref)).encode(text)
