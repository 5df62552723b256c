from .....core.graph import Input, InputLayer
from .core import (
    Dense, SparseDense, Activation, Dropout, SpatialDropout1D,
    SpatialDropout2D, SpatialDropout3D, Flatten, Reshape, Permute,
    RepeatVector, Masking, Highway, MaxoutDense, TimeDistributed)
from .convolutional import (
    Convolution1D, Convolution2D, Convolution3D, AtrousConvolution1D,
    AtrousConvolution2D, ShareConvolution2D, SeparableConvolution2D,
    Deconvolution2D, LocallyConnected1D, LocallyConnected2D,
    ZeroPadding1D, ZeroPadding2D, ZeroPadding3D, Cropping1D, Cropping2D,
    Cropping3D, UpSampling1D, UpSampling2D, UpSampling3D, ResizeBilinear,
    SpaceToDepth2D)
from .pooling import (
    MaxPooling1D, MaxPooling2D, MaxPooling3D, AveragePooling1D,
    AveragePooling2D, AveragePooling3D, GlobalMaxPooling1D,
    GlobalMaxPooling2D, GlobalMaxPooling3D, GlobalAveragePooling1D,
    GlobalAveragePooling2D, GlobalAveragePooling3D)
from .normalization import (BatchNormalization, WithinChannelLRN2D, LRN2D,
                            LayerNorm)
from .embedding import Embedding, SparseEmbedding, WordEmbedding
from .merge import Merge, merge
from .advanced_activations import (ELU, LeakyReLU, PReLU, SReLU,
                                   ThresholdedReLU)
from .noise import GaussianNoise, GaussianDropout
from .recurrent import SimpleRNN, LSTM, GRU, ConvLSTM2D, Bidirectional
from .torch_style import (
    AddConstant, MulConstant, BinaryThreshold, Threshold, HardShrink,
    SoftShrink, HardTanh, RReLU, Exp, Log, Sqrt, Square, Negative, Identity,
    Power, Mul, CAdd, CMul, Scale, GaussianSampler, KerasLayerWrapper,
    Narrow, Select, Squeeze)
from .moe import SwitchMoE
from .attention import MultiHeadSelfAttention, PositionalEmbedding


def __getattr__(name):
    # Sequential and Model, as the JAX package's layers export them; the
    # engine imports the trainer, so it loads at first use
    if name in ("Sequential", "Model"):
        from .. import engine
        return getattr(engine, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
