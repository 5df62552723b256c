from .common import ZooModel, register_zoo_model
from .image import (ImageClassifier, ImageConfigure, ObjectDetector,
                    PaddingParam, ScaleDetection, Visualizer, decode_output,
                    label_output, read_coco_label_map,
                    read_imagenet_label_map, read_label_map,
                    read_pascal_label_map, resnet50, ssd_mobilenet,
                    ssd_vgg16, visualize)
from .jax_params import (from_jax_params, to_jax_params, to_jax_state)
from .recommendation import (ColumnFeatureInfo, NeuralCF, Recommender,
                             UserItemFeature, UserItemPrediction,
                             WideAndDeep)
from .recommendation_utils import (categorical_from_vocab_list,
                                   features_to_arrays, get_boundaries,
                                   get_deep_tensor, get_negative_samples,
                                   get_wide_tensor, hash_bucket,
                                   row_to_feature, row_to_sample,
                                   to_user_item_feature)
from .textclassification import TextClassifier
from .textgeneration import TransformerLM

__all__ = ["ColumnFeatureInfo", "ImageClassifier", "ImageConfigure",
           "NeuralCF", "ObjectDetector", "PaddingParam", "Recommender",
           "ScaleDetection", "TextClassifier", "TransformerLM",
           "UserItemFeature", "UserItemPrediction", "Visualizer",
           "WideAndDeep", "ZooModel", "categorical_from_vocab_list",
           "decode_output", "features_to_arrays", "from_jax_params",
           "get_boundaries", "get_deep_tensor", "get_negative_samples",
           "get_wide_tensor", "hash_bucket", "label_output",
           "read_coco_label_map", "read_imagenet_label_map", "read_label_map",
           "read_pascal_label_map", "register_zoo_model", "resnet50",
           "row_to_feature", "row_to_sample", "ssd_mobilenet", "ssd_vgg16",
           "to_jax_params", "to_jax_state", "to_user_item_feature", "visualize"]
