"""mx.image — image loading + augmenters (counterpart of
``mxnet_tpu/image/``; parity: python/mxnet/image/).  cv2 is optional;
PIL/numpy fallbacks keep it working in minimal environments.  The
detection augmenters and ``ImageDetIter`` are not ported yet."""
from .image import (imread, imdecode, imresize, imrotate, copyMakeBorder,
                    resize_short, fixed_crop,
                    center_crop, random_crop, color_normalize, scale_down,
                    random_size_crop, ImageIter, CreateAugmenter, Augmenter,
                    ResizeAug, ForceResizeAug, CenterCropAug, RandomCropAug,
                    RandomSizedCropAug, HorizontalFlipAug, CastAug,
                    ColorNormalizeAug, BrightnessJitterAug,
                    ContrastJitterAug, SaturationJitterAug, HueJitterAug,
                    ColorJitterAug, LightingAug, RandomGrayAug,
                    SequentialAug, RandomOrderAug)

__all__ = ["imread", "imdecode", "imresize", "resize_short", "fixed_crop",
           "center_crop", "random_crop", "color_normalize", "scale_down",
           "random_size_crop", "ImageIter", "CreateAugmenter", "Augmenter",
           "ResizeAug", "ForceResizeAug", "CenterCropAug", "RandomCropAug",
           "RandomSizedCropAug", "HorizontalFlipAug", "CastAug",
           "ColorNormalizeAug", "BrightnessJitterAug", "ContrastJitterAug",
           "SaturationJitterAug", "HueJitterAug", "ColorJitterAug",
           "LightingAug", "RandomGrayAug", "SequentialAug",
           "RandomOrderAug", "imrotate", "copyMakeBorder"]
