"""Objectron → COCO conversion (counterpart of
``scripts/objectron_2_coco.py``):

    python -m tpudet3d_torch.tools.objectron_2_coco --data_root RAW \\
        --output_folder OUT [--fps_divisor N] [--res_divisor N] \\
        [--obj_classes all|bike ...] [--subsets train test]

Host ETL only: cv2 reads the videos and writes the JPEGs.
"""

import argparse

from ..core import OBJECTRON_CLASSES
from ..data.converter import convert

__all__ = ['main']


def main(argv=None):
    parser = argparse.ArgumentParser(description='Objectron → COCO converter')
    parser.add_argument('--data_root', type=str, required=True,
                        help='raw Objectron root (annotation/, videos/, index/)')
    parser.add_argument('--output_folder', type=str, required=True)
    parser.add_argument('--fps_divisor', type=int, default=1)
    parser.add_argument('--res_divisor', type=int, default=1)
    parser.add_argument('--obj_classes', type=str, nargs='+', default=['all'])
    parser.add_argument('--subsets', type=str, nargs='+',
                        default=['train', 'test'])
    parser.add_argument('--limit_videos', type=int, default=0)
    args = parser.parse_args(argv)

    classes = (OBJECTRON_CLASSES if args.obj_classes == ['all']
               else args.obj_classes)
    return [convert(args.data_root, args.output_folder, subset,
                    obj_classes=classes, fps_divisor=args.fps_divisor,
                    res_divisor=args.res_divisor,
                    limit_videos=args.limit_videos)
            for subset in args.subsets]


if __name__ == '__main__':
    main()
