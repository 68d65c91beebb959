"""Convert orbax training snapshots into the PyTorch port's snapshot files.

    python scripts/snapshot_to_torch.py SNAP_DIR [--out FILE]
    python scripts/snapshot_to_torch.py --all OUTPUT_DIR

Restores a ``snap_{epoch}`` directory written by
``tpudet3d/utils/checkpoint.py`` ``save_snap`` (raw, no template, as
``tpudet3d/detect/load.py`` does), takes its ``state`` when present, and
writes ``params`` and, when the snapshot has them, ``ema_params`` (each
with the snapshot's ``batch_stats``) through
``tpudet3d_torch.utils.convert.jax_to_state_dict`` to ``SNAP_DIR.pt``
(``tpudet3d_torch.utils.checkpoint`` describes the file).  The kind is
``regressor`` when the weights have ``head_kernel`` and ``detector`` when
they have ``cls_heads_0``.  Which weights to serve (EMA or raw) is decided
when the port loads the file.  ``--all`` converts every ``snap_*``
directory of OUTPUT_DIR.
"""

import argparse
import os
import os.path as osp
import re
import sys

sys.path.insert(0, osp.join(osp.dirname(osp.abspath(__file__)), '..'))

import numpy as np

from tpudet3d_torch.utils.checkpoint import converted_path, save_converted
from tpudet3d_torch.utils.convert import jax_to_state_dict


def _numpy(tree):
    return {k: _numpy(v) if isinstance(v, dict) else np.asarray(v)
            for k, v in tree.items()}


def snapshot_kind(params):
    if 'head_kernel' in params:
        return 'regressor'
    if 'cls_heads_0' in params:
        return 'detector'
    raise ValueError('neither a regressor (head_kernel) nor a detector '
                     f'(cls_heads_0) snapshot: top-level keys '
                     f'{sorted(params)[:8]}')


def convert(snap_dir, out=None):
    """One orbax snapshot → its converted file; returns the file's path."""
    import orbax.checkpoint as ocp
    with ocp.StandardCheckpointer() as ckptr:
        restored = ckptr.restore(osp.abspath(snap_dir))
    saved = restored['state'] if 'state' in restored else restored
    kind = snapshot_kind(saved['params'])
    stats = _numpy(saved.get('batch_stats') or {})

    def state_dict(params):
        return jax_to_state_dict({'params': _numpy(params),
                                  'batch_stats': stats})

    if 'epoch' in restored:
        epoch = int(np.asarray(restored['epoch']))
    else:
        epoch = int(re.search(r'(\d+)$', osp.normpath(snap_dir)).group(1))
    ema = saved.get('ema_params') or None     # absent, None or {}: no EMA
    out = out or converted_path(snap_dir)
    save_converted(out, kind, epoch, state_dict(saved['params']),
                   state_dict(ema) if ema else None)
    print(f'{snap_dir} → {out} ({kind}, epoch {epoch}, '
          f'{"with" if ema else "without"} EMA)')
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('snap_dir', nargs='?', help='an orbax snap_{epoch} dir')
    ap.add_argument('--out', default='', help='default: SNAP_DIR.pt')
    ap.add_argument('--all', default='', metavar='OUTPUT_DIR',
                    help='convert every snap_* directory of OUTPUT_DIR')
    args = ap.parse_args(argv)
    if bool(args.snap_dir) == bool(args.all):
        ap.error('give either SNAP_DIR or --all OUTPUT_DIR')
    if args.all:
        if args.out:
            ap.error('--out names one file; it does not go with --all')
        snaps = sorted((d for d in os.listdir(args.all)
                        if re.match(r'snap_\d+$', d)
                        and osp.isdir(osp.join(args.all, d))),
                       key=lambda d: int(d.split('_')[1]))
        if not snaps:
            raise SystemExit(f'no snap_* directory under {args.all}')
        return [convert(osp.join(args.all, d)) for d in snaps]
    return [convert(args.snap_dir, args.out or None)]


if __name__ == '__main__':
    main()
