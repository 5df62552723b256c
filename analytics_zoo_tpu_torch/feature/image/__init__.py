from .imageset import ImageSet, LocalImageSet, DistributedImageSet
from .transforms import (
    ImageFeature, ImageProcessing, ImageBytesToMat, ImageResize,
    BufferedImageResize, ImageAspectScale, ImageCenterCrop, ImageRandomCrop,
    ImageFixedCrop, ImageChannelNormalize, ImagePixelNormalizer,
    ImageChannelOrder, ImageBrightness, ImageHue, ImageSaturation,
    ImageContrast, ImageColorJitter, ImageExpand, ImageFiller, ImageHFlip,
    ImageRandomPreprocessing, ImageMatToFloats, ImageMatToTensor,
    ImageSetToSample, ImageRandomAspectScale, ImagePreprocessing,
    ImagePixelNormalize, ImageFeatureToTensor, RowToImageFeature,
    resize_branch)
