"""In-tree trainable byte-pair tokenizer (the high-throughput serving vocab).

Why this exists: the default ``ByteTokenizer`` makes grammar-constrained
decoding trivial but costs one token per byte — planner prompts (~500 chars)
land in the 512-token prefill bucket and a plan JSON spends ~90 decode
tokens, and prefill is the compute-bound side of serving (the reference
outsources all of this to OpenAI, ``control_plane.py:69-73``). A subword
vocab cuts both counts ~3x. The real-checkpoint SentencePiece path stays in
``models/tokenizer.py`` but is gated on an external package and a ``.model``
file; this BPE is self-contained: trained once on the framework's own
synthetic workload corpus (service lines, plan JSON, intents), committed as
a ~60KB JSON artifact, zero external dependencies.

Vocab layout — a strict superset of ``ByteTokenizer`` (same special ids, so
``byte_id`` and grammar byte anchors keep working):

    ids 0..255     raw bytes
    256/257/258    PAD / BOS / EOS
    259..n_real-1  learned multi-byte tokens
    n_real..V-1    MXU padding (V rounded up to a multiple of 128)

Encoding is greedy longest-match over the token byte strings (deterministic;
no merge ranks needed at runtime — the merge procedure only DISCOVERS the
vocab). Every single byte is a token, so byte-level round-trip is exact.
``token_bytes()`` exposes each id's byte surface; the grammar's token-DFA
product (``planner/grammar.py``) already handles multi-byte tokens, so
constrained decoding stays exact on this vocab.

Train/regenerate the committed artifact (deterministic corpus, ~1 min):

    python -m mcpx_torch.models.bpe mcpx_torch/models/bpe_vocab.json
"""

from __future__ import annotations

import base64
import json
import os
from collections import Counter
from typing import Iterable, Optional

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
_N_SPECIAL = 3
_MXU_PAD = 128

_DEFAULT_VOCAB = os.path.join(os.path.dirname(__file__), "bpe_vocab.json")


class BPETokenizer:
    """Greedy longest-match subword tokenizer over a trained byte vocab."""

    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def __init__(self, vocab_path: Optional[str] = None) -> None:
        path = vocab_path or _DEFAULT_VOCAB
        with open(path, "r", encoding="utf-8") as f:
            blob = json.load(f)
        if blob.get("format") != "mcpx-bpe-v1":
            raise ValueError(f"{path}: not an mcpx-bpe-v1 vocab file")
        merged: list[bytes] = [base64.b64decode(t) for t in blob["tokens"]]
        # id -> byte surface (specials covered by None).
        self._surfaces: list[Optional[bytes]] = (
            [bytes([i]) for i in range(256)] + [None] * _N_SPECIAL + merged
        )
        raw = len(self._surfaces)
        self.n_real = raw
        self.vocab_size = ((raw + _MXU_PAD - 1) // _MXU_PAD) * _MXU_PAD
        # Longest-match byte trie: node = {byte: child}, with the token id
        # ending at a node stored under the -1 key. Encoding walks bytes
        # forward remembering the deepest token match — O(len * avg_depth)
        # dict lookups, vs the naive per-candidate startswith scan that
        # profiled as the single hottest function on the /plan host path.
        self._trie: dict = {}
        for tid, s in enumerate(self._surfaces):
            if s is None or len(s) < 2:
                continue
            node = self._trie
            for b in s:
                node = node.setdefault(b, {})
            node[-1] = tid

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        data = text.encode("utf-8")
        ids: list[int] = [BOS_ID] if bos else []
        trie = self._trie
        i, n = 0, len(data)
        while i < n:
            node = trie.get(data[i])
            best_id, best_end = data[i], i + 1  # single byte always matches
            j = i + 1
            while node is not None:
                tid = node.get(-1)
                if tid is not None:
                    best_id, best_end = tid, j
                if j >= n:
                    break
                node = node.get(data[j])
                j += 1
            ids.append(best_id)
            i = best_end
        if eos:
            ids.append(EOS_ID)
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        parts = []
        for i in ids:
            if 0 <= i < self.n_real:
                s = self._surfaces[i]
                if s is not None:
                    parts.append(s)
        return b"".join(parts).decode("utf-8", errors="replace")

    def byte_id(self, char: str) -> int:
        b = char.encode("utf-8")
        if len(b) != 1:
            raise ValueError(f"{char!r} is not a single byte")
        return b[0]

    def token_bytes(self) -> list[bytes | None]:
        """Per-id byte surface (None for specials/MXU padding) — the
        interface the grammar's token-DFA product compiles against."""
        out = list(self._surfaces)
        out += [None] * (self.vocab_size - len(out))
        return out


# --------------------------------------------------------------- training
def train_bpe(texts: Iterable[str], n_merges: int, min_freq: int = 2) -> list[bytes]:
    """Classic byte-pair merging over whitespace-chunked words (leading
    whitespace stays attached to its word, GPT-style, so learned tokens can
    span the space before a word). Returns the learned multi-byte surfaces
    in merge order — which is also their id order, making the artifact
    reproducible byte-for-byte from the same corpus."""
    import re

    words: Counter = Counter()
    for t in texts:
        for m in re.finditer(rb"\s*\S+", t.encode("utf-8")):
            w = m.group(0)
            words[tuple(w[i : i + 1] for i in range(len(w)))] += 1

    merges: list[bytes] = []
    for _ in range(n_merges):
        pairs: Counter = Counter()
        for w, c in words.items():
            for a, b in zip(w, w[1:]):
                pairs[(a, b)] += c
        if not pairs:
            break
        (a, b), freq = max(pairs.items(), key=lambda kv: (kv[1], kv[0]))
        if freq < min_freq:
            break
        merged = a + b
        merges.append(merged)
        new_words: Counter = Counter()
        for w, c in words.items():
            out: list[bytes] = []
            i = 0
            while i < len(w):
                if i + 1 < len(w) and w[i] == a and w[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(w[i])
                    i += 1
            new_words[tuple(out)] += c
        words = new_words
    return merges


def default_corpus() -> list[str]:
    """Deterministic training corpus shaped like the serving workload: the
    planner's fixed header, per-service prompt lines for the synthetic 1k
    registry (with telemetry features), intents, and grammar-wire plan
    JSONs. Everything derives from seeded generators so retraining
    reproduces the committed artifact exactly."""
    import random

    from mcpx_torch.planner.llm import _PROMPT_HEADER
    from mcpx_torch.utils.synth import intent_for, synth_registry

    rng = random.Random(1234)
    records = synth_registry(1000, seed=0)
    texts: list[str] = [_PROMPT_HEADER * 50]
    for s in records:
        ins = ",".join(sorted(s.input_schema))
        outs = ",".join(sorted(s.output_schema))
        feat = (
            f" err={rng.random():.2f} p50={rng.uniform(4, 90):.0f}"
            f" c={s.cost_profile.get('cost', 1.0):g}"
        )
        texts.append(f"{s.name} in:{ins} out:{outs}{feat}\n")
    for _ in range(600):
        texts.append(f"Intent: {intent_for(records, rng)}\nJSON:\n")
    for _ in range(400):
        steps = []
        picks = rng.sample(records, rng.randint(1, 4))
        for i, s in enumerate(picks):
            nxt = [p.name for p in picks[i + 1 : i + 2]]
            steps.append(
                {
                    "s": s.name,
                    "in": sorted(s.input_schema),
                    "next": nxt,
                }
            )
        texts.append(json.dumps({"steps": steps}, separators=(",", ":")))
    return texts


def train_default(out_path: str, vocab_total: int = 4096) -> dict:
    """Train on the default corpus targeting ``vocab_total`` ids and write
    the artifact. The merge loop stops early when no pair clears min_freq
    (the committed artifact lands at n_real=3017 → vocab 3072 after MXU
    rounding), so treat ``vocab_total`` as a ceiling, not a guarantee —
    size embeddings from ``BPETokenizer.vocab_size``."""
    n_merges = vocab_total - 256 - _N_SPECIAL
    merges = train_bpe(default_corpus(), n_merges=n_merges, min_freq=2)
    blob = {
        "format": "mcpx-bpe-v1",
        "tokens": [base64.b64encode(m).decode("ascii") for m in merges],
    }
    with open(out_path, "w", encoding="utf-8") as f:
        json.dump(blob, f)
    return blob


if __name__ == "__main__":
    import sys

    out = sys.argv[1] if len(sys.argv) > 1 else _DEFAULT_VOCAB
    total = int(sys.argv[2]) if len(sys.argv) > 2 else 4096
    blob = train_default(out, total)
    tok = BPETokenizer(out)
    sample = 'auth-fetch-0001 in:query out:status err=0.01 p50=12 c=0.5'
    ids = tok.encode(sample)
    print(
        f"wrote {out}: {len(blob['tokens'])} merges, vocab {tok.vocab_size}, "
        f"sample compression {len(sample.encode('utf-8'))}B -> {len(ids)} tokens"
    )
