from .classification import (ImageClassifier, densenet161, inception_v1,
                             inception_v3, label_output, mobilenet,
                             mobilenet_v2, resnet50,
                             space_to_depth_stem_kernel, squeezenet, vgg16,
                             vgg19)
from .detection import (ObjectDetector, ScaleDetection, Visualizer,
                        decode_output, ssd_mobilenet, ssd_vgg16, visualize)

__all__ = ["ImageClassifier", "ObjectDetector", "ScaleDetection",
           "Visualizer", "decode_output", "densenet161", "inception_v1",
           "inception_v3", "label_output", "mobilenet", "mobilenet_v2",
           "resnet50", "space_to_depth_stem_kernel", "squeezenet",
           "ssd_mobilenet", "ssd_vgg16", "vgg16", "vgg19", "visualize"]
