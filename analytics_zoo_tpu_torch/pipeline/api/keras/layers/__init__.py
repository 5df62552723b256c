from .....core.graph import Input, InputLayer
from .attention import MultiHeadSelfAttention, PositionalEmbedding
from .convolutional import Convolution1D, Convolution2D
from .core import Activation, Dense, Dropout, Flatten
from .embedding import Embedding
from .merge import Merge
from .normalization import LayerNorm
from .pooling import MaxPooling2D

__all__ = ["Activation", "Convolution1D", "Convolution2D", "Dense",
           "Dropout", "Embedding", "Flatten", "Input", "InputLayer",
           "LayerNorm", "Merge",
           "MaxPooling2D", "MultiHeadSelfAttention", "PositionalEmbedding"]
