"""Model factory (counterpart of ``tpudet3d/models/builder.py``).

Builds the MobileNetV3 family.  EfficientNet-lite belongs to a later slice
of the port (ROADMAP.md, Queue 1).
"""

import torch

from .layers import init_weights
from .mobilenetv3 import MobileNetV3, model_params
from .wrapper import MultiHeadRegressor

__AVAI_MODELS__ = {
    'mobilenetv3_large', 'mobilenetv3_small', 'efficientnet-lite0',
    'efficientnet-lite1', 'efficientnet-lite2', 'mobilenetv3_large_21k',
}

__all__ = ['build_model', '__AVAI_MODELS__', 'build_backbone']


def build_backbone(name):
    if name not in __AVAI_MODELS__:
        raise ValueError(f'Wrong model name parameter. Expected one of '
                         f'{__AVAI_MODELS__}')
    if name.startswith('efficientnet'):
        raise NotImplementedError(
            f'{name}: EfficientNet-lite is not ported yet; it belongs to a '
            'later slice (ROADMAP.md, Queue 1)')
    params = model_params[name]
    return MobileNetV3(cfgs=params['cfgs'], mode=params['mode'],
                       timm_arch=params.get('timm_arch', False))


def build_model(config, dtype=None, generator=None):
    """Multi-head regressor from a config.  ``dtype`` defaults to bf16 when
    ``config.model.bf16`` is set; ``generator`` seeds the random init
    (default: ``torch.Generator().manual_seed(0)``)."""
    if dtype is None:
        dtype = (torch.bfloat16 if config.model.get('bf16', False)
                 else torch.float32)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    model = MultiHeadRegressor(
        build_backbone(config.model.name),
        num_classes=int(config.model.num_classes or 9),
        pooling_mode=config.model.get('pooling_mode', 'avg'),
        dtype=dtype)
    init_weights(model, generator)
    model.init_heads(generator)
    return model.eval()
