from .classification import (ImageClassifier, densenet161, inception_v1,
                             inception_v3, label_output, mobilenet,
                             mobilenet_v2, resnet50,
                             space_to_depth_stem_kernel, squeezenet, vgg16,
                             vgg19)
from .config import (COCO_CLASSES, PASCAL_CLASSES, ImageConfigure,
                     PaddingParam, read_coco_label_map,
                     read_imagenet_label_map, read_label_map,
                     read_pascal_label_map)
from .detection import (ObjectDetector, ScaleDetection, Visualizer,
                        decode_output, ssd_mobilenet, ssd_vgg16, visualize)

__all__ = ["COCO_CLASSES", "ImageClassifier", "ImageConfigure",
           "ObjectDetector", "PASCAL_CLASSES", "PaddingParam",
           "ScaleDetection", "Visualizer", "decode_output", "densenet161",
           "inception_v1", "inception_v3", "label_output", "mobilenet",
           "mobilenet_v2", "read_coco_label_map", "read_imagenet_label_map",
           "read_label_map", "read_pascal_label_map", "resnet50",
           "space_to_depth_stem_kernel", "squeezenet", "ssd_mobilenet",
           "ssd_vgg16", "vgg16", "vgg19", "visualize"]
