from .transforms import (ImageFeature3D, Rotate3D, AffineTransform3D,
                         Crop3D, CenterCrop3D, RandomCrop3D,
                         rotation_matrix, ImageProcessing3D,
                         ImagePreprocessing3D)
