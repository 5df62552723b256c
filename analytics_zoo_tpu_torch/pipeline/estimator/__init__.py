from .nn_estimator import (NNEstimator, NNModel, NNClassifier,
                           NNClassifierModel, NNImageReader, read_images)
