"""Export the regressor as a deployment artifact (counterpart of
``scripts/export.py``):

    python -m tpudet3d_torch.tools.export --config CONFIG \\
        [--model_export_path ./converted_models] [--snapshot SNAP] \\
        [--img_size H W] [--batch_size 1] [--device cpu]

Builds the config's regressor, loads the converted snapshot ``--snapshot``
(a ``snap_N.pt`` file or the orbax ``snap_N`` directory beside it) or else
the newest one of the config's ``output_dir``, with the served weights of
``infer/build.py`` (the EMA where the config keeps one), and writes
``model.pt2`` and ``model.graph.txt`` (``infer/export.py``).  Without a
snapshot it warns and exports seeded random weights.  Runs on the card
unless ``--device cpu``.
"""

import argparse

import torch

from ..core.config import read_py_config
from ..core.device import resolve_device
from ..infer.build import regressor_weights
from ..infer.export import export_regressor
from ..models.builder import build_model
from ..utils.checkpoint import (latest_snapshot, load_converted,
                                resolve_converted)
from ..utils.convert import load_state_dict_strict

__all__ = ['main']


def _parser():
    parser = argparse.ArgumentParser(description='model export')
    parser.add_argument('--config', type=str, required=True)
    parser.add_argument('--model_export_path', type=str,
                        default='./converted_models')
    parser.add_argument('--snapshot', type=str, default='',
                        help='explicit checkpoint; default = newest snap in '
                             'cfg.output_dir')
    parser.add_argument('--img_size', type=int, nargs=2, default=None,
                        help='export input size; default 128x128 like the '
                             'JAX export')
    parser.add_argument('--batch_size', type=int, default=1)
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' exports on the CPU; default: the card")
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    cfg = read_py_config(args.config)
    device = resolve_device(args.device)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0))
    snap = args.snapshot or (latest_snapshot(cfg.output_dir)
                             if cfg.get('output_dir') else None)
    if snap:
        path = resolve_converted(snap)
        load_state_dict_strict(model, regressor_weights(
            load_converted(path, kind='regressor'), cfg))
        print(f'loaded weights from {path}')
    else:
        print('WARNING: no snapshot found, exporting random weights')
    img_size = tuple(args.img_size) if args.img_size else (128, 128)
    return export_regressor(model.to(device).eval(), args.model_export_path,
                            img_size=img_size, batch_size=args.batch_size)


if __name__ == '__main__':
    main()
