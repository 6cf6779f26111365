"""In-tree SentencePiece ``.model`` codec + unigram encoder.

The PyTorch port's copy of ``mcpx/models/sp_model.py``, whole. Real Gemma
checkpoints ship their vocab as a serialized SentencePiece ``ModelProto``.
The ``sentencepiece`` package is optional, so serving an ``sp:`` vocab
without it needs an in-tree reader: this module parses the protobuf wire format directly (field layout
per the public ``sentencepiece_model.proto``; cross-validated in tests
against the schema vendored by ``transformers``), encodes with the standard
unigram Viterbi, and can also *write* tiny models for fixtures.

Scope: unigram/BPE inference (piece table + scores), byte-fallback, the
``add_dummy_prefix``/``escape_whitespaces`` normalizer flags, and the
``nmt_nfkc``/``nmt_nfkc_cf`` normalizers (Gemma ships ``nmt_nfkc``):
NFKC via ``unicodedata`` plus the NMT control/whitespace rules. Matching
the real library's semantics, normalization fires only when the model
SHIPS a non-empty ``precompiled_charsmap`` (inference normalizes via the
charsmap bytes; an empty charsmap is identity and the name is
informational) — the declared ``name`` then tells this codec WHICH recipe
those bytes encode. APPROXIMATION NOTE: the charsmap itself (a frozen
Unicode snapshot compiled into a double-array trie) is NOT decoded — this
host Python's Unicode tables stand in for it, which can differ on
codepoints whose NFKC mapping changed between Unicode versions (none of
which appear in planner/JSON text). When the ``sentencepiece`` package is
present the tokenizer prefers it (exact parity with the shipped model);
this codec is the always-available fallback.

Wire cheat-sheet (all that is needed here):

    ModelProto:      1 repeated SentencePiece, 2 TrainerSpec, 3 NormalizerSpec
    SentencePiece:   1 piece (string), 2 score (float32), 3 type (enum)
    TrainerSpec:     40 unk_id, 41 bos_id, 42 eos_id, 43 pad_id (int32)
    NormalizerSpec:  1 name (string), 2 precompiled_charsmap (bytes),
                     3 add_dummy_prefix, 4 remove_extra_whitespaces,
                     5 escape_whitespaces (bool)
    Type enum:       1 NORMAL, 2 UNKNOWN, 3 CONTROL, 4 USER_DEFINED,
                     5 UNUSED, 6 BYTE
"""

from __future__ import annotations

import re
import struct
import unicodedata
from dataclasses import dataclass, field

NORMAL, UNKNOWN, CONTROL, USER_DEFINED, UNUSED, BYTE = 1, 2, 3, 4, 5, 6

_WS = "▁"  # ▁ — SentencePiece's escaped space
_RUNS_RE = re.compile(r"  +")

# NMT normalization rules (applied by the nmt_nfkc* normalizers before
# NFKC; modeled on the public sentencepiece builder's AddRulesForNMT):
# controls and zero-width/format marks are dropped; every flavour of
# horizontal whitespace and the line/paragraph separators become plain
# spaces (which remove_extra_whitespaces then collapses). One translate()
# table so the per-encode pass runs in C, not a Python char loop.
_NMT_TABLE = {
    # C0 controls minus \t \n \r, DEL, C1 controls minus NEL,
    **dict.fromkeys(
        [*range(0x00, 0x09), 0x0B, 0x0C, *range(0x0E, 0x20), 0x7F,
         *(c for c in range(0x80, 0xA0) if c != 0x85),
         # soft hyphen, zero-width space/joiners/marks, word joiner, BOM.
         0x00AD, *range(0x200B, 0x2010), 0x2060, 0xFEFF, 0xFFFE]
    ),
    **dict.fromkeys(
        [0x09, 0x0A, 0x0D, 0x85, 0x00A0, 0x1680, *range(0x2000, 0x200B),
         0x2028, 0x2029, 0x202F, 0x205F, 0x3000],
        " ",
    ),
}


def nmt_nfkc_normalize(text: str, casefold: bool = False) -> str:
    """``nmt_nfkc`` (and ``_cf``) normalization without the shipped
    charsmap: NMT control/whitespace cleanup, then ``unicodedata`` NFKC
    (this Python's Unicode tables stand in for the frozen snapshot the
    real ``precompiled_charsmap`` encodes), then optional casefold."""
    text = unicodedata.normalize("NFKC", text.translate(_NMT_TABLE))
    return text.casefold() if casefold else text


# ----------------------------------------------------------------- wire io
def _read_varint(buf: bytes, i: int) -> tuple[int, int]:
    out = shift = 0
    while True:
        b = buf[i]
        i += 1
        out |= (b & 0x7F) << shift
        if not b & 0x80:
            return out, i
        shift += 7


def _write_varint(n: int) -> bytes:
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _skip(buf: bytes, i: int, wire_type: int) -> int:
    if wire_type == 0:
        _, i = _read_varint(buf, i)
    elif wire_type == 1:
        i += 8
    elif wire_type == 2:
        n, i = _read_varint(buf, i)
        i += n
    elif wire_type == 5:
        i += 4
    else:
        raise ValueError(f"unsupported protobuf wire type {wire_type}")
    return i


def _fields(buf: bytes):
    """Iterate (field_number, wire_type, value_or_span) over a message."""
    i = 0
    while i < len(buf):
        tag, i = _read_varint(buf, i)
        fn, wt = tag >> 3, tag & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield fn, wt, v
        elif wt == 5:
            yield fn, wt, buf[i : i + 4]
            i += 4
        elif wt == 2:
            n, i = _read_varint(buf, i)
            yield fn, wt, buf[i : i + n]
            i += n
        else:
            i = _skip(buf, i, wt)


# -------------------------------------------------------------------- model
@dataclass
class SPPiece:
    piece: str
    score: float = 0.0
    type: int = NORMAL


@dataclass
class SPModel:
    pieces: list[SPPiece] = field(default_factory=list)
    unk_id: int = -1
    bos_id: int = -1
    eos_id: int = -1
    pad_id: int = -1
    # Proto defaults (absent fields mean TRUE for all three).
    add_dummy_prefix: bool = True
    escape_whitespaces: bool = True
    remove_extra_whitespaces: bool = True
    # NormalizerSpec.name: "nmt_nfkc" (Gemma/most models), "nmt_nfkc_cf"
    # (+casefold), "nfkc", or "identity". Names WHICH recipe the shipped
    # charsmap encodes; normalization fires only when a non-empty charsmap
    # is present (the real library normalizes via the charsmap bytes — an
    # empty charsmap is identity regardless of name, so a name-less or
    # charsmap-less model keeps its historical identity behavior).
    normalizer_name: str = "nmt_nfkc"
    precompiled_charsmap: bytes = b""

    # ------------------------------------------------------------- parsing
    @classmethod
    def loads(cls, blob: bytes) -> "SPModel":
        m = cls()
        for fn, wt, v in _fields(blob):
            if fn == 1 and wt == 2:  # SentencePiece
                piece, score, typ = "", 0.0, NORMAL
                for pfn, pwt, pv in _fields(v):
                    if pfn == 1 and pwt == 2:
                        piece = pv.decode("utf-8")
                    elif pfn == 2 and pwt == 5:
                        score = struct.unpack("<f", pv)[0]
                    elif pfn == 3 and pwt == 0:
                        typ = pv
                m.pieces.append(SPPiece(piece, score, typ))
            elif fn == 2 and wt == 2:  # TrainerSpec
                for tfn, twt, tv in _fields(v):
                    if twt != 0:
                        continue
                    if tfn == 40:
                        m.unk_id = _i32(tv)
                    elif tfn == 41:
                        m.bos_id = _i32(tv)
                    elif tfn == 42:
                        m.eos_id = _i32(tv)
                    elif tfn == 43:
                        m.pad_id = _i32(tv)
            elif fn == 3 and wt == 2:  # NormalizerSpec
                for nfn, nwt, nv in _fields(v):
                    if nfn == 1 and nwt == 2:
                        m.normalizer_name = nv.decode("utf-8")
                    elif nfn == 2 and nwt == 2:
                        m.precompiled_charsmap = bytes(nv)
                    elif nfn == 3 and nwt == 0:
                        m.add_dummy_prefix = bool(nv)
                    elif nfn == 4 and nwt == 0:
                        m.remove_extra_whitespaces = bool(nv)
                    elif nfn == 5 and nwt == 0:
                        m.escape_whitespaces = bool(nv)
        if not m.pieces:
            raise ValueError("not a SentencePiece model (no pieces)")
        # Ids may be absent from TrainerSpec (old models): recover control
        # ids from the conventional piece names.
        names = {p.piece: i for i, p in enumerate(m.pieces)}
        if m.unk_id < 0:
            for i, p in enumerate(m.pieces):
                if p.type == UNKNOWN:
                    m.unk_id = i
                    break
        if m.bos_id < 0:
            m.bos_id = names.get("<s>", names.get("<bos>", -1))
        if m.eos_id < 0:
            m.eos_id = names.get("</s>", names.get("<eos>", -1))
        if m.pad_id < 0:
            m.pad_id = names.get("<pad>", -1)
        return m

    @classmethod
    def load(cls, path: str) -> "SPModel":
        with open(path, "rb") as f:
            return cls.loads(f.read())

    # --------------------------------------------------------- serialization
    def dumps(self) -> bytes:
        def ld(fn: int, payload: bytes) -> bytes:
            return _write_varint(fn << 3 | 2) + _write_varint(len(payload)) + payload

        def vi(fn: int, v: int) -> bytes:
            return _write_varint(fn << 3 | 0) + _write_varint(v & 0xFFFFFFFFFFFFFFFF)

        out = bytearray()
        for p in self.pieces:
            body = (
                ld(1, p.piece.encode("utf-8"))
                + _write_varint(2 << 3 | 5)
                + struct.pack("<f", p.score)
                + vi(3, p.type)
            )
            out += ld(1, body)
        # TrainerSpec.byte_fallback (35) is declared whenever the model has
        # byte pieces: the sentencepiece library refuses a model whose byte
        # pieces lack it ("byte piece <0x00> is found although
        # `byte_fallback` is false"). The reference's writer omits it.
        byte_fallback = any(p.type == BYTE for p in self.pieces)
        trainer = b"".join(
            vi(fn, v)
            for fn, v in (
                (35, 1 if byte_fallback else -1),
                (40, self.unk_id), (41, self.bos_id), (42, self.eos_id), (43, self.pad_id),
            )
            if v >= 0
        )
        out += ld(2, trainer)
        norm = (
            ld(1, self.normalizer_name.encode("utf-8"))
            + (ld(2, self.precompiled_charsmap) if self.precompiled_charsmap else b"")
            + vi(3, int(self.add_dummy_prefix))
            + vi(4, int(self.remove_extra_whitespaces))
            + vi(5, int(self.escape_whitespaces))
        )
        out += ld(3, norm)
        return bytes(out)

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            f.write(self.dumps())


def _i32(v: int) -> int:
    return v - (1 << 64) if v >= (1 << 63) else v


# ----------------------------------------------------------------- encoder
class UnigramEncoder:
    """Viterbi segmentation over piece scores with byte fallback — the
    standard SentencePiece unigram inference (greedy longest-match would be
    wrong for unigram models: the score table, not surface length, decides
    segmentation)."""

    def __init__(self, model: SPModel) -> None:
        self.model = model
        self._byte_ids = [-1] * 256
        # Trie over piece byte surfaces: node = {byte: child}, id under -1.
        self._trie: dict = {}
        self._scores = [p.score for p in model.pieces]
        for i, p in enumerate(model.pieces):
            if p.type == BYTE:
                self._byte_ids[int(p.piece[3:-1], 16)] = i
                continue
            if p.type not in (NORMAL, USER_DEFINED):
                continue
            node = self._trie
            for b in p.piece.encode("utf-8"):
                node = node.setdefault(b, {})
            node[-1] = i
        # Unk cost: below any real piece so it's used only when nothing
        # covers a byte (byte pieces participate at their TRAINED scores —
        # real unigram inference puts them in the lattice like any piece).
        min_score = min(self._scores, default=0.0)
        self._unk_score = min_score - 10.0

    def normalize(self, text: str) -> str:
        name = self.model.normalizer_name
        if self.model.precompiled_charsmap and "nfkc" in name:
            # Charsmap present = the model really normalizes (the package
            # backend normalizes via these bytes; empty = identity even if
            # the name says otherwise — parity demands the same here).
            # "nmt_nfkc" / "nfkc" / "nmt_nfkc_cf" — NMT rules only apply to
            # the nmt_* variants; bare "nfkc" is NFKC alone.
            if name.startswith("nmt_"):
                text = nmt_nfkc_normalize(text, casefold=name.endswith("_cf"))
            else:
                text = unicodedata.normalize("NFKC", text)
                if name.endswith("_cf"):
                    text = text.casefold()
        if self.model.remove_extra_whitespaces:
            # Proto-default normalization: collapse space runs, strip ends.
            text = _RUNS_RE.sub(" ", text).strip(" ")
        if self.model.escape_whitespaces:
            text = text.replace(" ", _WS)
        if self.model.add_dummy_prefix:
            text = _WS + text
        return text

    def encode(self, text: str) -> list[int]:
        data = self.normalize(text).encode("utf-8")
        n = len(data)
        NEG = float("-inf")
        best = [NEG] * (n + 1)
        back: list[tuple[int, int]] = [(-1, -1)] * (n + 1)  # (prev_pos, id)
        best[0] = 0.0
        for i in range(n):
            if best[i] == NEG:
                continue
            # Trie walk: all pieces starting at i.
            node = self._trie.get(data[i])
            j = i + 1
            while node is not None:
                pid = node.get(-1)
                if pid is not None:
                    s = best[i] + self._scores[pid]
                    if s > best[j]:
                        best[j], back[j] = s, (i, pid)
                if j >= n:
                    break
                node = node.get(data[j])
                j += 1
            # Byte pieces compete at their trained scores; unk is the
            # floor-cost fallback of last resort.
            bid = self._byte_ids[data[i]]
            if bid >= 0:
                s = best[i] + self._scores[bid]
                if s > best[i + 1]:
                    best[i + 1], back[i + 1] = s, (i, bid)
            elif self.model.unk_id >= 0:
                s = best[i] + self._unk_score
                if s > best[i + 1]:
                    best[i + 1], back[i + 1] = s, (i, self.model.unk_id)
        ids: list[int] = []
        j = n
        while j > 0:
            i, pid = back[j]
            if pid < 0:
                raise ValueError("unsegmentable input (no byte/unk fallback)")
            ids.append(pid)
            j = i
        ids.reverse()
        return ids

    def piece_bytes(self, i: int) -> "bytes | None":
        """Byte surface id ``i`` denotes in decoded output (None for
        control/unknown/unused) — ``token_bytes()`` ground truth, exact by
        construction because ``decode`` concatenates exactly these."""
        p = self.model.pieces[i]
        if p.type == BYTE:
            return bytes([int(p.piece[3:-1], 16)])
        if p.type in (NORMAL, USER_DEFINED):
            return p.piece.replace(_WS, " ").encode("utf-8")
        return None

    def decode(self, ids) -> str:
        buf = bytearray()
        for i in ids:
            if 0 <= i < len(self.model.pieces):
                s = self.piece_bytes(i)
                if s is not None:
                    buf += s
        text = bytes(buf).decode("utf-8", errors="replace")
        if self.model.add_dummy_prefix and text.startswith(" "):
            # Mirror the real decoder's dummy-prefix strip. (Boundary note:
            # a generated id sequence BEGINNING with a "▁..." piece then
            # decodes without its leading space while token_bytes keeps it —
            # same divergence the package backend has; grammar-constrained
            # JSON always starts with '{' so the serving path never hits it.)
            text = text[1:]
        return text


def tiny_model(extra_pieces: "list[tuple[str, float]] | None" = None) -> SPModel:
    """A small, fully-valid unigram model: 4 controls, full byte fallback,
    and JSON/planner-shaped subword pieces — the shape of a real Gemma
    vocab at fixture scale. Used by tests and as a committed-fixture
    generator; parseable by the real ``sentencepiece`` library."""
    pieces = [
        SPPiece("<unk>", 0.0, UNKNOWN),
        SPPiece("<s>", 0.0, CONTROL),
        SPPiece("</s>", 0.0, CONTROL),
        SPPiece("<pad>", 0.0, CONTROL),
    ]
    pieces += [SPPiece(f"<0x{b:02X}>", -12.0, BYTE) for b in range(256)]
    words = extra_pieces or [
        ('{"steps":[{"s":"', -1.0),
        ('","in":["', -1.0),
        ('"],"next":["', -1.0),
        ('"],"next":[]}', -1.5),
        ('"]}]}', -1.5),
        ("fetch", -2.0),
        ("auth", -2.0),
        ("user", -2.0),
        ("order", -2.0),
        ("billing", -2.0),
        ("validate", -2.5),
        ("enrich", -2.5),
        ("score", -2.5),
        ("query", -2.5),
        ("summar", -3.0),
        ("ize", -3.0),
        (_WS + "then", -2.0),
        (_WS + "please", -2.0),
        (_WS, -4.0),
        ("-", -3.5),
        ("00", -3.0),
        ("0", -3.5),
        ("1", -3.5),
        ("2", -3.5),
        ('"', -3.5),
        (":", -3.5),
        ("{", -3.5),
        ("}", -3.5),
        ("[", -3.5),
        ("]", -3.5),
        (",", -3.5),
    ]
    pieces += [SPPiece(w, s, NORMAL) for w, s in words]
    return SPModel(
        pieces=pieces,
        unk_id=0,
        bos_id=1,
        eos_id=2,
        pad_id=3,
        add_dummy_prefix=False,
        escape_whitespaces=True,
    )
