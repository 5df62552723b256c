from .....core.graph import Input, InputLayer
from .attention import MultiHeadSelfAttention, PositionalEmbedding
from .convolutional import (Convolution1D, Convolution2D,
                            SeparableConvolution2D, SpaceToDepth2D,
                            ZeroPadding2D)
from .core import Activation, Dense, Dropout, Flatten, Reshape
from .embedding import Embedding, SparseEmbedding, WordEmbedding
from .merge import Merge
from .moe import SwitchMoE
from .normalization import BatchNormalization, LayerNorm
from .pooling import (AveragePooling2D, GlobalAveragePooling1D,
                      GlobalAveragePooling2D, GlobalAveragePooling3D,
                      GlobalMaxPooling1D, GlobalMaxPooling2D,
                      GlobalMaxPooling3D, MaxPooling2D)
from .recurrent import GRU, LSTM, Bidirectional, ConvLSTM2D, SimpleRNN

__all__ = ["Activation", "AveragePooling2D", "BatchNormalization",
           "Bidirectional", "ConvLSTM2D", "Convolution1D", "Convolution2D",
           "Dense", "Dropout", "Embedding", "Flatten", "GRU",
           "GlobalAveragePooling1D", "GlobalAveragePooling2D",
           "GlobalAveragePooling3D", "GlobalMaxPooling1D",
           "GlobalMaxPooling2D", "GlobalMaxPooling3D", "Input", "InputLayer",
           "LSTM", "LayerNorm", "Merge", "MaxPooling2D",
           "MultiHeadSelfAttention", "PositionalEmbedding", "Reshape",
           "SeparableConvolution2D", "SimpleRNN", "SpaceToDepth2D",
           "SparseEmbedding", "SwitchMoE", "WordEmbedding", "ZeroPadding2D"]
