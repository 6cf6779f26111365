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


class SentencePieceTokenizer:
    """SentencePiece tokenizer for real Gemma checkpoints (vocab 256000,
    padded to a multiple of 128: 256128), through the same four-method interface
    as ``ByteTokenizer`` (encode/decode/token_bytes + ids).

    Two backends, chosen at construction:
      - the ``sentencepiece`` package when importable (exact parity with the
        shipped model, including NFKC normalization);
      - otherwise the in-tree ``ModelProto`` codec + unigram Viterbi
        (``models/sp_model.py``) — no external package; applies the model's
        declared ``nmt_nfkc``/``nfkc`` normalizer via Python's Unicode
        tables (an approximation of the shipped ``precompiled_charsmap``
        snapshot — see ``sp_model`` module docstring), so the
        real-checkpoint chain serves and tests without the package.
    """

    def __init__(self, model_path: str, *, backend: str = "auto") -> None:
        """``backend``: "auto" (package if importable, else in-tree),
        "package", or "intree" (parity tests pin each explicitly)."""
        if backend not in ("auto", "package", "intree"):
            raise ValueError(f"unknown SentencePiece backend {backend!r}")
        spm = None
        if backend in ("auto", "package"):
            try:
                import sentencepiece as spm  # noqa: F401
            except ImportError:
                if backend == "package":
                    raise
        if spm is None:
            from mcpx_torch.models.sp_model import SPModel, UnigramEncoder

            m = SPModel.load(model_path)
            self._sp = None
            self._enc = UnigramEncoder(m)
            self._raw = len(m.pieces)
            self._ids(model_path, m.bos_id, m.eos_id, m.pad_id)
        else:
            self._sp = spm.SentencePieceProcessor(model_file=model_path)
            self._enc = None
            self._raw = self._sp.vocab_size()
            self._ids(
                model_path, self._sp.bos_id(), self._sp.eos_id(), self._sp.pad_id()
            )

    def _ids(self, model_path: str, bos: int, eos: int, pad: int) -> None:
        self.bos_id = bos if bos >= 0 else self._raw
        self.eos_id = eos
        if self.eos_id < 0:
            raise ValueError(f"{model_path}: SentencePiece model has no EOS id")
        # Gemma's <pad> is id 0; otherwise synthesise one in the padding tail.
        self.pad_id = pad if pad >= 0 else self._raw + 1
        raw_total = max(self._raw, self.bos_id + 1, self.pad_id + 1)
        self.n_real = raw_total
        self.vocab_size = ((raw_total + _MXU_PAD - 1) // _MXU_PAD) * _MXU_PAD

    def encode(self, text: str, *, bos: bool = True, eos: bool = False) -> list[int]:
        if self._sp is not None:
            ids = list(self._sp.encode(text))
        else:
            ids = self._enc.encode(text)
        if bos:
            ids = [self.bos_id] + ids
        if eos:
            ids = ids + [self.eos_id]
        return ids

    def decode(self, ids) -> str:
        kept = [i for i in ids if 0 <= i < self._raw]
        if self._sp is not None:
            return self._sp.decode(kept)
        return self._enc.decode(kept)

    def token_bytes(self) -> list[bytes | None]:
        """Per-id byte surface as ``decode()`` will render it.

        The grammar product requires: for any generated id sequence, the
        concatenation of ``token_bytes`` equals the bytes of ``decode()``'s
        output. On the in-tree backend that holds by construction (its
        decoder concatenates exactly ``piece_bytes``). On the package
        backend, naively mapping ``id_to_piece(i).replace("▁", " ")`` breaks
        it for pieces containing a literal U+2581 (corrupted surfaces) — so each piece is rendered through the *decoder itself*
        behind a known single-byte anchor: ``decode([anchor, i]) ==
        anchor_text + surface(i)`` byte-exactly; the anchor also defeats the
        decoder's leading-whitespace strip so "▁foo" keeps its space. Falls
        back to the replace heuristic only when the model has no byte pieces
        to anchor with.
        """
        if self._sp is None:
            out = [self._enc.piece_bytes(i) for i in range(self._raw)]
            out += [None] * (self.vocab_size - self._raw)
            return out
        anchor_id, anchor_text = None, ""
        for i in range(self._raw):
            if self._sp.is_byte(i) and self._sp.id_to_piece(i) == "<0x41>":
                anchor_id, anchor_text = i, "A"
                break
        out: list[bytes | None] = []
        for i in range(self._raw):
            if self._sp.is_control(i) or self._sp.is_unknown(i):
                out.append(None)
            elif self._sp.is_byte(i):
                piece = self._sp.id_to_piece(i)  # "<0xNN>"
                out.append(bytes([int(piece[3:-1], 16)]))
            elif anchor_id is not None:
                s = self._sp.decode([anchor_id, i])
                if s.startswith(anchor_text):
                    out.append(s[len(anchor_text):].encode("utf-8"))
                else:  # unexpected decoder behavior; heuristic fallback
                    out.append(self._sp.id_to_piece(i).replace("▁", " ").encode("utf-8"))
            else:
                out.append(self._sp.id_to_piece(i).replace("▁", " ").encode("utf-8"))
        out += [None] * (self.vocab_size - self._raw)
        return out


def make_tokenizer(vocab: str = "byte"):
    """``model.vocab`` config -> tokenizer: "byte" (in-tree, default),
    "bpe"/"bpe:<path>" (in-tree trained subword vocab, models/bpe.py) or
    "sp:<path-to-model>" (SentencePiece checkpoint vocab)."""
    if vocab in ("", "byte"):
        return ByteTokenizer()
    if vocab == "bpe" or vocab.startswith("bpe:"):
        from mcpx_torch.models.bpe import BPETokenizer

        return BPETokenizer(vocab[4:] or None)
    if vocab.startswith("sp:"):
        return SentencePieceTokenizer(vocab[3:])
    raise ValueError(
        f"unknown tokenizer spec {vocab!r}; expected 'byte', 'bpe[:<path>]' "
        "or 'sp:<path>'"
    )
