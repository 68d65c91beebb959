"""Objectron-protocol evaluation over TFRecord shards (counterpart of
``scripts/objectron_eval.py``):

    python -m tpudet3d_torch.tools.objectron_eval --eval_data RECORDS \\
        [--classes bike book ...] [--preset recall] [--device cpu] \\
        [--reg_config configs/scene_regressor_el0_hpo.py] \\
        [--det_checkpoint output/<run>/snap_N] [--reg_checkpoint ...]

Walks the per-class shards ``RECORDS/<class>/*``, runs the two-stage
engine on each frame in batches of ``--batch`` (K1–K4), lifts every
prediction to 3D with the batched EPnP (portrait), scores it with the
protocol evaluator (K5, one call per example), and writes
``report_<class>.txt`` under ``--report_dir``.  ``--reg_config`` takes any
regressor config (MobileNetV3 or EfficientNet-lite); the checkpoints are
converted snapshots (``scripts/snapshot_to_torch.py``), named by the file
or by the orbax ``snap_N`` directory beside it, and without
``--reg_checkpoint`` the newest snapshot of the config's ``output_dir`` is
served (``infer/build.py``).  Everything runs on the card unless
``--device cpu``.  Decoding JPEG frames needs cv2, imported when
the first record is decoded.

Expected feature keys (Objectron eval shards): image/encoded (JPEG),
point_2d, point_3d (flat float lists), instance_num, object/visibility,
plane/center, plane/normal.

Not ported: ``--int8`` (int8 serving) raises ``NotImplementedError``.
"""

import argparse
import glob
import os.path as osp
import time

import numpy as np
import torch

from ..core import OBJECTRON_CLASSES, mkdir_if_missing
from ..eval.protocol import (ObjectronProtocolEvaluator, parse_example,
                             read_tfrecord)
from ..infer.build import build_engine
from ..ops.geometry import lift_2d_batched

__all__ = ['decode_example', 'engine_from_args', 'evaluate_category', 'main',
           'parse_args']


def decode_example(payload):
    """One ``tf.train.Example`` → ``(image BGR uint8 or None, gt2d [n,9,2],
    gt3d [n,9,3], visibility [n], (plane_center, plane_normal))``."""
    import cv2 as cv
    feats = parse_example(payload)
    img_bytes = feats.get('image/encoded', {}).get('bytes', [None])[0]
    image = None
    if img_bytes is not None:
        image = cv.imdecode(np.frombuffer(img_bytes, np.uint8),
                            cv.IMREAD_COLOR)
    n = int(feats.get('instance_num', {}).get('ints', [0])[0])
    p2 = np.asarray(feats.get('point_2d', {}).get('floats', []),
                    np.float32).reshape(n, 9, 3)[..., :2] if n else \
        np.zeros((0, 9, 2), np.float32)
    p3 = np.asarray(feats.get('point_3d', {}).get('floats', []),
                    np.float32).reshape(n, 9, 3) if n else \
        np.zeros((0, 9, 3), np.float32)
    vis = np.asarray(feats.get('object/visibility', {}).get('floats', []),
                     np.float32)
    plane_c = np.asarray(feats.get('plane/center', {}).get('floats',
                                                           [0, 0, 0]),
                         np.float32)
    plane_n = np.asarray(feats.get('plane/normal', {}).get('floats',
                                                           [0, 1, 0]),
                         np.float32)
    return image, p2, p3, vis, (plane_c, plane_n)


def _chunks(examples, batch):
    """Runs of at most ``batch`` examples whose frames share one shape."""
    chunk = []
    for ex in examples:
        if chunk and ex[0].shape != chunk[0][0].shape:
            yield chunk
            chunk = []
        chunk.append(ex)
        if len(chunk) == batch:
            yield chunk
            chunk = []
    if chunk:
        yield chunk


def _gt_box_results(regressor, chunk):
    """The --gt_boxes diagnostic: crop from the GT keypoint extent + 10 px
    instead of the detector's boxes."""
    results = []
    for image, gt2d, _, _, _ in chunk:
        h, w = image.shape[:2]
        dets = []
        for g in gt2d:
            ext = g * np.asarray([w, h], np.float32)
            lo = np.clip(ext.min(0) - 10.0, 0, [w - 1, h - 1])
            hi = np.clip(ext.max(0) + 10.0, 0, [w, h])
            dets.append((lo[0], lo[1], hi[0], hi[1], 1.0, 0))
        outs = regressor.get_detections(image, dets)
        results.append({
            'boxes': np.asarray([d[:4] for d in dets], np.float32),
            'kp': np.asarray([o[0] for o in outs], np.float32),
        })
    return results


def evaluate_category(engine, examples, batch, vis_thresh,
                      gt_box_regressor=None, evaluator=None, timings=None):
    """Evaluate one category.

    ``examples`` yields ``(image, gt2d, gt3d, visibility, plane)`` with at
    least one GT instance each.  Frames run through the engine in server
    batches of ``batch`` (a lone frame, a shape change or host downscaling
    runs per frame), or through ``gt_box_regressor`` when given.  Returns
    the finalised evaluator (a new ``ObjectronProtocolEvaluator`` on the
    engine's device unless ``evaluator`` is given).  ``timings``, a dict,
    gains the wall seconds of the engine, the lift and the protocol
    (``'engine'``, ``'lift'``, ``'protocol'``)."""
    if evaluator is None:
        evaluator = ObjectronProtocolEvaluator(device=engine.device)
    timings = {} if timings is None else timings
    for key in ('engine', 'lift', 'protocol'):
        timings.setdefault(key, 0.0)
    force_per_frame = int(engine.cfg.host_downscale) != 1
    for chunk in _chunks(examples, batch):
        t0 = time.perf_counter()
        if gt_box_regressor is not None:
            results = _gt_box_results(gt_box_regressor, chunk)
        elif len(chunk) > 1 and not force_per_frame:
            pad = chunk + chunk[-1:] * (batch - len(chunk))
            results = engine.infer_batch(
                np.stack([e[0] for e in pad]))[:len(chunk)]
        else:   # lone frame (odd tail / shape change)
            results = [engine(e[0]) for e in chunk]
        timings['engine'] += time.perf_counter() - t0
        for (image, gt2d, gt3d, vis, plane), result in zip(chunk, results):
            h, w = image.shape[:2]
            pred2d = []
            for box, kp in zip(result['boxes'], result['kp']):
                x0, y0, x1, y1 = box
                abs_kp = kp * np.asarray([x1 - x0, y1 - y0]) + \
                    np.asarray([x0, y0])
                pred2d.append(abs_kp / np.asarray([w, h], np.float32))
            t0 = time.perf_counter()
            if pred2d:
                pred3d = lift_2d_batched(
                    torch.as_tensor(np.asarray(pred2d, np.float32),
                                    device=engine.device),
                    portrait=True).cpu().numpy()
            else:
                pred3d = np.zeros((0, 9, 3), np.float32)
            t1 = time.perf_counter()
            evaluator.evaluate_example(
                [p for p in pred2d], [p for p in pred3d],
                [g for g in gt2d], [g for g in gt3d], plane=plane,
                visibilities=vis, vis_thresh=vis_thresh)
            timings['lift'] += t1 - t0
            timings['protocol'] += time.perf_counter() - t1
    evaluator.finalize()
    return evaluator


def _parser():
    parser = argparse.ArgumentParser(description='Objectron-protocol eval')
    parser.add_argument('--eval_data', type=str, required=True,
                        help='root with per-class TFRecord shards, '
                             '<eval_data>/<class>/*')
    parser.add_argument('--reg_config', type=str, default='')
    parser.add_argument('--det_checkpoint', type=str, default='')
    parser.add_argument('--reg_checkpoint', type=str, default='')
    parser.add_argument('--classes', type=str, nargs='+', default=['all'])
    parser.add_argument('--max_num', type=int, default=-1,
                        help='max examples per class')
    parser.add_argument('--report_dir', type=str, default='./eval_reports')
    parser.add_argument('--det_tresh', type=float, default=0.6)
    parser.add_argument('--vis_thresh', type=float, default=0.1)
    parser.add_argument('--batch', type=int, default=8,
                        help='frames per engine call (same-shape frames run '
                             'batched; a shape change runs per frame)')
    parser.add_argument('--refine_passes', type=int, default=0,
                        help='keypoint-refinement passes in the engine '
                             '(re-crop around the predicted extent)')
    parser.add_argument('--refine_margin', type=float, default=10.0)
    parser.add_argument('--det_score_thr', type=float, default=0.02,
                        help='detector decode score floor (pre-NMS); must '
                             'be <= det_tresh to have predictions survive')
    parser.add_argument('--soft_nms', type=float, default=0.0,
                        help='gaussian soft-NMS sigma (0 = hard NMS)')
    parser.add_argument('--soft_nms_dup', type=float, default=0.75,
                        help='soft-NMS duplicate cutoff: overlaps above '
                             'this IoU are zeroed, not decayed')
    parser.add_argument('--max_detections', type=int, default=8)
    parser.add_argument('--box_vote', type=float, default=0.0,
                        help='box-voting IoU threshold (0 = off)')
    parser.add_argument('--host_downscale', type=int, default=1,
                        help='host-side 1/d frame downscale before upload; '
                             'frames run through the per-frame engine path '
                             'and boxes are rescaled to source pixels')
    parser.add_argument('--tta_flip', action='store_true',
                        help='horizontal-flip test-time augmentation for '
                             'the regressor (one doubled batch, predictions '
                             'averaged)')
    parser.add_argument('--int8', action='store_true',
                        help='int8 serving: not ported, raises')
    parser.add_argument('--int8_calib', type=int, default=9,
                        help='number of calibration frames for --int8')
    parser.add_argument('--preset', type=str, default='',
                        choices=['', 'recall'],
                        help="'recall' sets det_tresh 0.01, det_score_thr "
                             '0.005, soft_nms 0.5, soft_nms_dup 0.75 and '
                             'refine_passes 1 wherever the caller left the '
                             'default')
    parser.add_argument('--gt_boxes', action='store_true',
                        help='DIAGNOSTIC (not the vendor protocol): bypass '
                             'the detector and crop from GT-keypoint-extent '
                             '+10px boxes')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain versions on the CPU; "
                             'default: the card')
    return parser


def parse_args(argv=None):
    """The CLI's arguments, with ``--preset`` applied."""
    parser = _parser()
    args = parser.parse_args(argv)
    if args.preset == 'recall':
        # only fill knobs the caller left at parser defaults, so explicit
        # flags always win over the preset
        for knob, value in [('det_tresh', 0.01), ('det_score_thr', 0.005),
                            ('soft_nms', 0.5), ('soft_nms_dup', 0.75),
                            ('refine_passes', 1)]:
            if getattr(args, knob) == parser.get_default(knob):
                setattr(args, knob, value)
    return args


def engine_from_args(args):
    """The serving engine the CLI's arguments ask for (``build_engine``:
    the default full-width build unless a config or checkpoint is given)."""
    if args.int8:
        raise NotImplementedError('--int8: int8 serving is not ported yet')
    return build_engine(args.reg_config, args.det_checkpoint,
                        args.reg_checkpoint, det_conf=args.det_tresh,
                        refine_passes=args.refine_passes,
                        refine_margin_px=args.refine_margin,
                        score_thr=min(args.det_score_thr, args.det_tresh),
                        soft_nms_sigma=args.soft_nms,
                        soft_nms_dup_iou=args.soft_nms_dup,
                        max_detections=args.max_detections,
                        box_vote_iou=args.box_vote,
                        host_downscale=args.host_downscale,
                        tta_flip=args.tta_flip, device=args.device)


def main(argv=None):
    args = parse_args(argv)
    engine = engine_from_args(args)
    gt_box_regressor = None
    if args.gt_boxes:
        if args.tta_flip:
            raise ValueError('--gt_boxes bypasses the engine (plain '
                             'Regressor wrapper): --tta_flip would be '
                             'ignored')
        from ..infer.wrappers import Regressor
        gt_box_regressor = Regressor(engine.reg_model,
                                     crop_size=engine.cfg.crop_size,
                                     device=engine.device)

    classes = (OBJECTRON_CLASSES if args.classes == ['all'] else args.classes)
    mkdir_if_missing(args.report_dir)

    for category in classes:
        shards = sorted(glob.glob(osp.join(args.eval_data, category, '*')))
        if not shards:
            print(f'[{category}] no shards under {args.eval_data}, skipping')
            continue

        def stream_examples():
            n = 0
            for shard in shards:
                for payload in read_tfrecord(shard):
                    if 0 <= args.max_num <= n:
                        return
                    image, gt2d, gt3d, vis, plane = decode_example(payload)
                    if image is None or len(gt2d) == 0:
                        continue
                    if not len(vis):
                        vis = np.ones(len(gt2d), np.float32)
                    n += 1
                    yield image, gt2d, gt3d, vis, plane

        evaluator = evaluate_category(engine, stream_examples(), args.batch,
                                      args.vis_thresh, gt_box_regressor)
        report_path = osp.join(args.report_dir, f'report_{category}.txt')
        with open(report_path, 'w') as f:
            evaluator.write_report(category, f)
        evaluator.write_report(category)
        print(f'[{category}] evaluated {evaluator.num_examples} examples → '
              f'{report_path}')


if __name__ == '__main__':
    main()
