from .decode import (DecodeEngine, DecodeEngineClosedError, TokenStream,
                     skeleton_draft)
from .inference_model import AbstractInferenceModel, InferenceModel, JTensor
from .serving import (BucketedExecutableCache, CoalescerClosedError,
                      Replica, ReplicaSet, RequestCoalescer, bucket_ladder)
