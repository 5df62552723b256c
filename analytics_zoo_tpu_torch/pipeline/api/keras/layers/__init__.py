from .attention import MultiHeadSelfAttention, PositionalEmbedding
from .core import Activation, Dense, Dropout
from .embedding import Embedding
from .merge import Merge
from .normalization import LayerNorm

__all__ = ["Activation", "Dense", "Dropout", "Embedding", "LayerNorm",
           "Merge", "MultiHeadSelfAttention", "PositionalEmbedding"]
