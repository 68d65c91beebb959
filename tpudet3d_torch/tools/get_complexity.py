"""Model complexity of a regressor config (counterpart of
``scripts/get_complexity.py``):

    python -m tpudet3d_torch.tools.get_complexity \\
        --config configs/scene_regressor.py [--device cpu]

The multi-head regressor in float32 at batch 1 of the config's input
size, in the serving convention (every head and the logits): its
parameter count and its multiply-accumulates as
``torch.utils.flop_counter.FlopCounterMode`` counts them, i.e. the
convolutions and matrix products only.  The JAX script's count is XLA's
``cost_analysis`` over the compiled program, which also counts the
elementwise work (batch norm, activations, pooling) and counts
convolutions its own way: the two part by a few percent.
``--device`` defaults to the card.
"""

import argparse

import torch

from ..core import read_py_config
from ..core.device import resolve_device
from ..models import build_model
from ..train import param_count
from ..utils.profiling import flops_of

__all__ = ['main', 'complexity']


def complexity(cfg, device=None):
    """``{'input_shape', 'params', 'macs'}`` of ``cfg``'s regressor."""
    device = resolve_device(device)
    model = build_model(cfg, dtype=torch.float32).to(
        device, memory_format=torch.channels_last)
    shape = (1, *cfg.data.resize, 3)
    x = torch.zeros(shape, dtype=torch.float32, device=device)
    with torch.no_grad():
        flops = flops_of(model, x)
    return {'input_shape': shape, 'params': param_count(model),
            'macs': flops // 2}


def main(argv=None):
    parser = argparse.ArgumentParser(description='Estimating model complexity')
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--device', type=str, default=None,
                        choices=['cpu', 'cuda'],
                        help='device to count on (default: the card)')
    args = parser.parse_args(argv)
    res = complexity(read_py_config(args.config), args.device)
    print(f'{"Input shape:":<30} {str(res["input_shape"]):<8}')
    print(f'{"Computational complexity:":<30} {res["macs"] / 1e6:.2f} MMac '
          f'({2 * res["macs"] / 1e9:.3f} GFLOPs; convolutions and matrix '
          f'products, FlopCounterMode)')
    print(f'{"Number of parameters:":<30} {res["params"] / 1e6:.2f} M '
          f'({res["params"]:,})')
    return res


if __name__ == '__main__':
    main()
