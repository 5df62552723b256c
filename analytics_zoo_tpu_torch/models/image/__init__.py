from .classification import (ImageClassifier, densenet161, inception_v1,
                             inception_v3, label_output, mobilenet,
                             mobilenet_v2, resnet50,
                             space_to_depth_stem_kernel, squeezenet, vgg16,
                             vgg19)

__all__ = ["ImageClassifier", "densenet161", "inception_v1", "inception_v3",
           "label_output", "mobilenet", "mobilenet_v2", "resnet50",
           "space_to_depth_stem_kernel", "squeezenet", "vgg16", "vgg19"]
