from .common import (Preprocessing, ChainedPreprocessing, SeqToTensor,
                     ArrayToTensor, ScalarToTensor, MLlibVectorToTensor,
                     TensorToSample, FeatureLabelPreprocessing,
                     FeatureToTupleAdapter, BigDLAdapter, ToTuple)
