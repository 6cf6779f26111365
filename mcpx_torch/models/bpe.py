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

    python -m mcpx_torch.models.bpe mcpx/models/bpe_vocab.json
"""

from __future__ import annotations

import base64
import json
import os
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
