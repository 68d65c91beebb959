"""Model factory (counterpart of ``tpudet3d/models/builder.py``): the
MobileNetV3 and EfficientNet-lite backbones, and Swin-T (the port's own:
the JAX package has no Swin), under the multi-head regressor."""

import torch

from .efficientnet_lite import EFFNET_LITE_PARAMS, EfficientNetLite
from .layers import init_weights
from .mobilenetv3 import MobileNetV3, model_params
from .swin import SWIN_PARAMS, SwinTransformer
from .wrapper import MultiHeadRegressor

__AVAI_MODELS__ = {
    'mobilenetv3_large', 'mobilenetv3_small', 'efficientnet-lite0',
    'efficientnet-lite1', 'efficientnet-lite2', 'mobilenetv3_large_21k',
    'swin_tiny_patch4_window7_224',
}

__all__ = ['build_model', '__AVAI_MODELS__', 'build_backbone']


def build_backbone(name, drop_path_rate=0.0):
    """The backbone ``name``; ``drop_path_rate`` is the stochastic depth of
    a Swin backbone's last block (the others have none)."""
    if name not in __AVAI_MODELS__:
        raise ValueError(f'Wrong model name parameter. Expected one of '
                         f'{__AVAI_MODELS__}')
    if name in SWIN_PARAMS:
        return SwinTransformer(**SWIN_PARAMS[name],
                               drop_path_rate=drop_path_rate)
    if drop_path_rate:
        raise ValueError(f'{name} has no stochastic depth')
    if name.startswith('efficientnet'):
        width, depth, _res, _drop = EFFNET_LITE_PARAMS[name]
        return EfficientNetLite(width_mult=width, depth_mult=depth)
    params = model_params[name]
    return MobileNetV3(cfgs=params['cfgs'], mode=params['mode'],
                       timm_arch=params.get('timm_arch', False))


def build_model(config, dtype=None, generator=None):
    """Multi-head regressor from a config.  ``dtype`` defaults to bf16 when
    ``config.model.bf16`` is set; ``config.model.drop_path_rate`` (default
    0) sets a Swin backbone's stochastic depth; ``generator`` seeds the
    random init (default: ``torch.Generator().manual_seed(0)``)."""
    if dtype is None:
        dtype = (torch.bfloat16 if config.model.get('bf16', False)
                 else torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    # the rate is passed only when set, so that a stand-in for
    # build_backbone taking the name alone (perfbench's backbone tests)
    # still builds
    rate = float(config.model.get('drop_path_rate', 0.0) or 0.0)
    model = MultiHeadRegressor(
        build_backbone(config.model.name,
                       **({'drop_path_rate': rate} if rate else {})),
        num_classes=int(config.model.num_classes or 9),
        pooling_mode=config.model.get('pooling_mode', 'avg'),
        dtype=dtype)
    init_weights(model, generator)
    model.init_heads(generator)
    return model.eval()
