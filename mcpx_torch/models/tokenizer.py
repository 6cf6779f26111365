"""In-tree byte-level tokenizer.

The reference outsources tokenisation to OpenAI (reference
``control_plane.py:69-73``); this framework runs fully self-contained on its
accelerator host (north star: "no external API in the loop"), so the default tokenizer
ships in-tree with zero external files: UTF-8 bytes are token ids 0..255,
plus special tokens. Byte-level tokens make grammar-constrained JSON decoding
(``mcpx_torch.planner.grammar``) exact — every JSON byte is one token, so the
grammar automaton masks logits without any subword-boundary ambiguity.

The vocab is padded to a multiple of 128, as in the reference package, so
token ids and vocab sizes match it exactly.
"""

from __future__ import annotations

from typing import Iterable

PAD_ID = 256
BOS_ID = 257
EOS_ID = 258
_N_SPECIAL = 3
_MXU_PAD = 128


class ByteTokenizer:
    """UTF-8 byte tokenizer: ids 0..255 are bytes, then PAD/BOS/EOS."""

    pad_id = PAD_ID
    bos_id = BOS_ID
    eos_id = EOS_ID

    def __init__(self) -> None:
        raw = 256 + _N_SPECIAL
        # Real (denoting) ids; the rest is MXU padding — samplers must mask
        # ids >= n_real on unconstrained paths (their logits are ordinary
        # numbers, not "never chosen").
        self.n_real = raw
        self.vocab_size = ((raw + _MXU_PAD - 1) // _MXU_PAD) * _MXU_PAD  # 384

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        ids = list(text.encode("utf-8"))
        if bos:
            ids = [BOS_ID] + ids
        if eos:
            ids = ids + [EOS_ID]
        return ids

    def decode(self, ids: Iterable[int]) -> str:
        data = bytes(i for i in ids if 0 <= i < 256)
        return data.decode("utf-8", errors="replace")

    def byte_id(self, char: str) -> int:
        b = char.encode("utf-8")
        if len(b) != 1:
            raise ValueError(f"{char!r} is not a single byte")
        return b[0]

    def token_bytes(self) -> list[bytes | None]:
        """Per-id byte string each token denotes (None for specials/padding)
        — the interface the grammar's token-DFA product compiles against."""
        out: list[bytes | None] = [bytes([i]) for i in range(256)]
        out += [None] * (self.vocab_size - 256)
        return out


def make_tokenizer(vocab: str = "byte"):
    """``model.vocab`` config -> tokenizer: "byte" (in-tree, default),
    or "bpe"/"bpe:<path>" (in-tree trained subword vocab, models/bpe.py)."""
    if vocab in ("", "byte"):
        return ByteTokenizer()
    if vocab == "bpe" or vocab.startswith("bpe:"):
        from mcpx_torch.models.bpe import BPETokenizer

        return BPETokenizer(vocab[4:] or None)
    if vocab.startswith("sp:"):
        raise ValueError(
            "SentencePiece vocabularies are not supported by the PyTorch port yet"
        )
    raise ValueError(
        f"unknown tokenizer spec {vocab!r}; expected 'byte', 'bpe[:<path>]' "
        "or 'sp:<path>'"
    )
