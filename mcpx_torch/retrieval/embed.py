"""Deterministic schema/intent embedder — signed feature hashing.

The reference's retrieval layer is a pgvector table of "schema embeddings"
that is connected but never queried (reference ``control_plane.py:46-55``,
dead component #3 in SURVEY.md §2.1). Here embeddings are real and in-tree:
word unigrams + character trigrams of the schema text are sign-hashed into a
fixed ``dim``-bucket vector (Weinberger et al. feature hashing), L2
normalised. Properties that matter for the control plane:

  - deterministic across processes (BLAKE2b, not Python's salted ``hash``),
    so a persisted table snapshot is valid for any server replica;
  - no external checkpoint/vocab files — a registry record is embeddable the
    moment it is registered;
  - featurization is host-side (strings never reach the device); scoring is
    a single [N, d] x [d] dot + top-k on device (``index.py``).

A learned encoder (e.g. pooled Gemma embeddings) can replace this behind the
same two-method interface; lexical hashing is the latency-tier default and
matches the heuristic planner's notion of relevance.
"""

from __future__ import annotations

import hashlib
import re

import numpy as np

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def _features(text: str) -> list[str]:
    words = _TOKEN_RE.findall(text.lower())
    feats = list(words)
    joined = " ".join(words)
    feats.extend(joined[i : i + 3] for i in range(len(joined) - 2))
    return feats


def _bucket_sign(feature: str, dim: int) -> tuple[int, float]:
    h = int.from_bytes(hashlib.blake2b(feature.encode(), digest_size=8).digest(), "little")
    return (h >> 1) % dim, 1.0 if h & 1 else -1.0


class HashedNGramEmbedder:
    def __init__(self, dim: int = 256) -> None:
        self.dim = dim

    def embed(self, text: str) -> np.ndarray:
        """[dim] float32, unit-norm (zero vector for empty text)."""
        v = np.zeros(self.dim, np.float32)
        for f in _features(text):
            idx, sign = _bucket_sign(f, self.dim)
            v[idx] += sign
        n = float(np.linalg.norm(v))
        return v / n if n > 0 else v

    def embed_texts(self, texts: list[str]) -> np.ndarray:
        """[N, dim] float32 matrix of unit-norm embeddings."""
        if not texts:
            return np.zeros((0, self.dim), np.float32)
        return np.stack([self.embed(t) for t in texts])
