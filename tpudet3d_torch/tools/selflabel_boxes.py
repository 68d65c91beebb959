"""Self-labelled detector boxes for regressor training (counterpart of
``scripts/selflabel_boxes.py``):

    python -m tpudet3d_torch.tools.selflabel_boxes \\
        --config configs/scene_regressor_selflabel.py \\
        --det_checkpoint output/detector_scene/snap_39.pt \\
        --out output/selflabel_boxes.npz [--device cpu]

Runs the trained detector over the training scene stream of a regressor
config (the scenes ``tools/main.py`` trains on) and writes the matched
per-object predicted boxes (frame pixels) to the npz that
``SceneCrops(det_boxes=...)`` reads (``data/selflabel.py``).  The
checkpoint is a port snapshot (its own trainer's, or one converted from
the JAX package).  ``--device`` defaults to the card.
"""

import argparse

from ..core import read_py_config

__all__ = ['main']


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description='self-label detector boxes')
    parser.add_argument('--config', type=str, required=True,
                        help='regressor config (scene_* family)')
    parser.add_argument('--det_checkpoint', type=str, required=True)
    parser.add_argument('--out', type=str, required=True)
    parser.add_argument('--score_thr', type=float, default=0.05,
                        help='detector confidence floor (the protocol '
                             'runner deploys at det_tresh 0.05)')
    parser.add_argument('--iou_match', type=float, default=0.25)
    parser.add_argument('--batch', type=int, default=32)
    parser.add_argument('--device', type=str, default=None,
                        choices=['cpu', 'cuda'],
                        help='device to run the detector on (default: the '
                             'card)')
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    cfg = read_py_config(args.config)
    if cfg.data.get('synthetic') != 'scene':
        raise ValueError('self-labelling takes a scene config '
                         "(data.synthetic='scene')")
    from ..data.selflabel import generate_selflabel_boxes
    from ..data.synthetic_scene import SyntheticScene
    # the training split's scenes, at the raw scene seed (data/loader.py)
    scene = SyntheticScene(
        length=int(cfg.data.get('synthetic_length', 1024)),
        seed=int(cfg.data.get('scene_seed', 23)),
        cache_dir=cfg.data.get('scene_cache', ''))
    matched, total = generate_selflabel_boxes(
        scene, args.det_checkpoint, args.out, score_thr=args.score_thr,
        iou_match=args.iou_match, batch=args.batch, device=args.device)
    print(f'matched {matched}/{total} objects '
          f'({100.0 * matched / max(total, 1):.1f}%) -> {args.out}')
    return matched, total


if __name__ == '__main__':
    main()
