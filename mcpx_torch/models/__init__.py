"""Model layer: the Gemma-architecture decoder (models/gemma), tokenizers
(byte / in-tree BPE / SentencePiece: models/tokenizer.py, models/bpe.py)
and the published-checkpoint converter (models/gemma/convert.py)."""

from mcpx_torch.models.tokenizer import ByteTokenizer, make_tokenizer

__all__ = ["ByteTokenizer", "make_tokenizer"]
