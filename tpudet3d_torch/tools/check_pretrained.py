"""Vet a downloaded pretrained torch checkpoint against its pinned contract
(counterpart of ``scripts/check_pretrained.py``):

    python -m tpudet3d_torch.tools.check_pretrained \\
        --model mobilenetv3_large_21k --ckpt pretrained/x.pth \\
        [--strip_prefix module.] [--device cpu]

Compares the file's full key/shape list and order with the published
layout's contract (``utils/pretrained_contract.py``), then imports it
strictly into the port's backbone (``utils/torch_import.py``), failing on
any desync of the matcher.  The file is read with ``weights_only=True``:
a checkpoint that needs an unrestricted unpickle fails the vetting.
Exits 0 when the checkpoint passes, 1 when it does not.
"""

import argparse
import os
import sys
import tempfile

import torch

from ..core.device import resolve_device
from ..models.builder import build_backbone
from ..models.layers import init_weights
from ..utils import pretrained_contract as pc
from ..utils.torch_import import load_torch_checkpoint_into, read_checkpoint

__all__ = ['main', 'CONTRACTS', 'ALLOW_UNUSED', 'get_contract']

CONTRACTS = {
    'mobilenetv3_large': [('dli14', None)],
    'mobilenetv3_small': [('dli14', None)],
    'mobilenetv3_large_21k': [('timm', 11221), ('timm', 1000)],
    'efficientnet-lite0': [('lite', None)],
    'efficientnet-lite1': [('lite', None)],
    'efficientnet-lite2': [('lite', None)],
}

ALLOW_UNUSED = {
    'dli14': (r'classifier\.3\.(weight|bias)',),
    'timm': (r'classifier\.(weight|bias)',),
    'lite': (r'_fc\.(weight|bias)',),
}


def get_contract(model, kind, num_classes):
    if kind == 'dli14':
        return pc.dli14_mobilenetv3(model.rsplit('_', 1)[-1])
    if kind == 'timm':
        return pc.timm_mobilenetv3_large_100(num_classes)
    return pc.efficientnet_lite(model)


def main(argv=None):
    ap = argparse.ArgumentParser(description='vet a pretrained checkpoint')
    ap.add_argument('--model', required=True, choices=sorted(CONTRACTS))
    ap.add_argument('--ckpt', required=True)
    ap.add_argument('--strip_prefix', default='',
                    help="key prefix to strip, e.g. 'module.' or 'model.'")
    ap.add_argument('--device', type=str, default=None,
                    choices=['cpu', 'cuda'],
                    help='device of the backbone (default: the card)')
    args = ap.parse_args(argv)
    device = resolve_device(args.device)

    ckpt = read_checkpoint(args.ckpt)
    path, tmp = args.ckpt, None
    if args.strip_prefix:
        n = len(args.strip_prefix)
        ckpt = {k[n:] if k.startswith(args.strip_prefix) else k: v
                for k, v in ckpt.items()}
        fd, tmp = tempfile.mkstemp(suffix='.pth')
        os.close(fd)
        torch.save({'state_dict': ckpt}, tmp)
        path = tmp
    try:
        chosen = None
        for kind, nc in CONTRACTS[args.model]:
            contract = get_contract(args.model, kind, nc)
            rep = pc.verify_state_dict(ckpt, contract)
            label = kind + (f'@{nc}cls' if nc else '')
            if rep['ok']:
                print(f'contract check [{label}]: OK '
                      f'({len(contract)} keys, order verified)')
                chosen = (kind, contract)
                break
            print(f'contract check [{label}]: MISMATCH — '
                  f'missing={rep["missing"][:5]} extra={rep["extra"][:5]} '
                  f'shape={rep["shape_mismatch"][:5]} '
                  f'order_ok={rep["order_ok"]}')
        if chosen is None:
            print('FAIL: checkpoint matches no pinned contract')
            return 1
        kind, contract = chosen
        backbone = init_weights(build_backbone(args.model),
                                torch.Generator().manual_seed(0)).to(device)
        report = {}
        load_torch_checkpoint_into(backbone, path, contract=contract,
                                   allow_unused=ALLOW_UNUSED[kind],
                                   report=report)
        print(f"strict import: OK — matched {report['matched']}, "
              f"port tensors left at init {report['skipped']}, "
              f"expected leftovers {sorted(report['leftovers'])}")
        return 0
    finally:
        if tmp is not None:
            os.remove(tmp)


if __name__ == '__main__':
    sys.exit(main())
