from mcpx_torch.retrieval.embed import HashedNGramEmbedder
from mcpx_torch.retrieval.index import RetrievalIndex

__all__ = ["HashedNGramEmbedder", "RetrievalIndex"]
