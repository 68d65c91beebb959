from .builder import build_model, build_backbone, __AVAI_MODELS__
from .efficientnet_lite import EfficientNetLite
from .layers import (ConvBN, InvertedResidual, SqueezeExcite, global_pool,
                     hard_sigmoid, hard_swish, init_weights, make_divisible)
from .mobilenetv2 import MobileNetV2
from .mobilenetv3 import MobileNetV3
from .swin import SwinTransformer
from .wrapper import MultiHeadRegressor

__all__ = ['build_model', 'build_backbone', '__AVAI_MODELS__', 'ConvBN',
           'EfficientNetLite', 'InvertedResidual', 'SqueezeExcite',
           'global_pool', 'hard_sigmoid', 'hard_swish', 'init_weights',
           'make_divisible', 'MobileNetV2', 'MobileNetV3',
           'MultiHeadRegressor', 'SwinTransformer']
