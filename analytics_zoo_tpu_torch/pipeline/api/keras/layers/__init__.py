from .....core.graph import Input, InputLayer
from .attention import MultiHeadSelfAttention, PositionalEmbedding
from .convolutional import (Convolution1D, Convolution2D,
                            SeparableConvolution2D, SpaceToDepth2D,
                            ZeroPadding2D)
from .core import Activation, Dense, Dropout, Flatten, Reshape
from .embedding import Embedding
from .merge import Merge
from .normalization import BatchNormalization, LayerNorm
from .pooling import (AveragePooling2D, GlobalAveragePooling1D,
                      GlobalAveragePooling2D, GlobalAveragePooling3D,
                      GlobalMaxPooling1D, GlobalMaxPooling2D,
                      GlobalMaxPooling3D, MaxPooling2D)

__all__ = ["Activation", "AveragePooling2D", "BatchNormalization",
           "Convolution1D", "Convolution2D", "Dense", "Dropout", "Embedding",
           "Flatten", "GlobalAveragePooling1D", "GlobalAveragePooling2D",
           "GlobalAveragePooling3D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "GlobalMaxPooling3D", "Input", "InputLayer",
           "LayerNorm", "Merge", "MaxPooling2D", "MultiHeadSelfAttention",
           "PositionalEmbedding", "Reshape", "SeparableConvolution2D",
           "SpaceToDepth2D", "ZeroPadding2D"]
