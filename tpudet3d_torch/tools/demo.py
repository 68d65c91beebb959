"""Live two-stage 3D-object-detection demo (counterpart of
``scripts/demo.py``):

    python -m tpudet3d_torch.tools.demo --video clip.mp4 [--benchmark]
        [--reg_config CONFIG] [--det_checkpoint SNAP] [--reg_checkpoint SNAP]
        [--int8]

A video file or a webcam in, tracked 3D boxes drawn out, an optional mp4
writer.  Inference is pipelined in software: frame N is dispatched to the
card before the host waits for frame N-1's result, then tracks and draws
it.  ``--benchmark`` runs headless (no window).  ``run`` takes any iterator
of BGR frames, so a caller without cv2 drives the same loop over decoded
frames; cv2 is imported only to read video, draw, show or write.  Without
snapshots both stages have random weights.  ``--int8`` calibrates both
stages on the first captured frame, resized to ``--resolution`` (which is
then not shown), and serves their dense convs through the int8 path
(``infer/quant.py``).  Runs on the card unless ``--device cpu``.
"""

import argparse
import time
from dataclasses import asdict

import numpy as np

from ..infer.build import build_engine
from ..infer.quant import serve_int8
from ..infer.tracker import IOUTracker, IOUTrackerConfig
from ..utils.drawing import draw_kp

__all__ = ['track_frame', 'draw_frame', 'run', 'capture_frames', 'main']


def track_frame(tracker, result):
    """Feed one frame's engine result to the tracker; returns the tracked
    objects it reports for that frame."""
    tracker.process(None, [tuple(map(int, b)) for b in result['boxes']],
                    [kp.reshape(-1) for kp in result['kp']])
    return tracker.get_tracked_objects()


def draw_frame(frame, objects):
    """Boxes, labels and keypoint wireframes of the tracked objects."""
    import cv2 as cv
    for obj in objects:
        x0, y0, x1, y1 = map(int, obj.rect[:4])
        color = (0, 255, 0) if obj.label != 'ID -1' else (100, 100, 100)
        cv.rectangle(frame, (x0, y0), (x1, y1), color, 2)
        if obj.label != 'ID -1':
            kp = np.asarray(obj.kp).reshape(9, 2)
            kp_px = kp * np.array([x1 - x0, y1 - y0]) + np.array([x0, y0])
            frame = draw_kp(frame, kp_px, None, RGB=False, normalized=False)
        cv.putText(frame, obj.label, (x0, max(y0 - 5, 12)),
                   cv.FONT_HERSHEY_SIMPLEX, 0.8, (255, 255, 255), 2)
    return frame


def run(frames, engine, tracker, draw=False, show=False, writer=None,
        max_frames=0, stats=None):
    """Pipelined inference and tracking over ``frames`` (an iterator of BGR
    uint8 frames).  Yields ``(frame, result, objects)`` for every frame in
    order: the engine's result and the tracked objects.  Frame N is
    dispatched (``engine.run_async``) before frame N-1's result is waited
    for (``wait_and_grab``).  As in ``scripts/demo.py``, the clock starts
    once the first frame is dispatched; unlike it, whose loop leaves the
    last frame in flight and drops it, the last frame's result is read and
    yielded when the input ends (so with ``max_frames`` below the input's
    length both give the same frames).  ``draw`` draws the objects onto
    the frame, ``show`` also shows it (Esc stops), ``writer`` (a
    ``cv2.VideoWriter``) gets every drawn frame; ``max_frames`` > 0 stops
    after that many frames.  ``stats``, a dict, gains ``frames`` and
    ``seconds``."""
    frames = iter(frames)
    stats = {} if stats is None else stats
    prev = next(frames, None)
    if prev is None:
        return
    engine.run_async(prev)         # software pipelining: one frame in flight
    t0 = time.perf_counter()
    n, stop = 0, False
    while prev is not None:
        frame = None
        if not stop and not (max_frames and n + 1 >= max_frames):
            frame = next(frames, None)
        if frame is not None:
            engine.run_async(frame)          # dispatch frame N first...
        result = engine.wait_and_grab()      # ...then block on frame N-1
        objects = track_frame(tracker, result)
        if draw or show or writer is not None:
            prev = draw_frame(prev, objects)
        n += 1
        stats.update(frames=n, seconds=time.perf_counter() - t0)
        yield prev, result, objects
        if show:
            import cv2 as cv
            cv.imshow('3D-object-detection', prev)
            stop = stop or cv.waitKey(1) == 27
        if writer is not None:
            writer.write(prev)
        prev = frame


def capture_frames(capture, resolution):
    """The frames of a ``cv2.VideoCapture``, resized to ``resolution``."""
    import cv2 as cv
    while True:
        ok, frame = capture.read()
        if not ok:
            return
        yield cv.resize(frame, tuple(resolution))


def _parser():
    parser = argparse.ArgumentParser(
        description='3d object detection live demo')
    parser.add_argument('--video', type=str, default=None)
    parser.add_argument('--cam_id', type=int, default=-1)
    parser.add_argument('--resolution', type=int, nargs='+',
                        default=[1280, 720])
    parser.add_argument('--reg_config', type=str, default='')
    parser.add_argument('--det_checkpoint', type=str, default='')
    parser.add_argument('--reg_checkpoint', type=str, default='')
    parser.add_argument('--det_tresh', type=float, default=0.7)
    parser.add_argument('--write_video', action='store_true')
    parser.add_argument('--benchmark', action='store_true',
                        help='headless throughput mode (no imshow)')
    parser.add_argument('--max_frames', type=int, default=0)
    parser.add_argument('--host_downscale', type=int, default=1,
                        help='downscale frames on host before upload '
                             '(cuts H2D bytes by factor^2; boxes are '
                             'rescaled to source pixels)')
    parser.add_argument('--int8', action='store_true',
                        help='serve both stages through the int8 PTQ path, '
                             'calibrated on the first captured frame')
    parser.add_argument('--tta_flip', action='store_true',
                        help='horizontal-flip TTA for the regressor '
                             '(EngineConfig.tta_flip)')
    parser.add_argument('--device', type=str, default=None,
                        help="'cpu' runs the plain versions on the CPU; "
                             'default: the card')
    return parser


def main(argv=None):
    args = _parser().parse_args(argv)
    import cv2 as cv
    if args.cam_id >= 0:
        cap = cv.VideoCapture(args.cam_id)
        cap.set(cv.CAP_PROP_FRAME_WIDTH, args.resolution[0])
        cap.set(cv.CAP_PROP_FRAME_HEIGHT, args.resolution[1])
    else:
        if not args.video:
            raise SystemExit('No video input was given (--video or '
                             '--cam_id)')
        cap = cv.VideoCapture(args.video)
    if not cap.isOpened():
        raise SystemExit('could not open the video input')
    engine = build_engine(args.reg_config, args.det_checkpoint,
                          args.reg_checkpoint, det_conf=args.det_tresh,
                          host_downscale=args.host_downscale,
                          tta_flip=args.tta_flip, device=args.device)
    if args.int8:
        ok, first = cap.read()
        if not ok:
            raise SystemExit('--int8: could not read a calibration frame')
        ds, rs = serve_int8(engine, [cv.resize(first,
                                               tuple(args.resolution))])
        print(f'int8: calibrated {len(ds)}+{len(rs)} convs')
    tracker = IOUTracker(**asdict(IOUTrackerConfig()))
    writer = None
    if args.write_video:
        writer = cv.VideoWriter('output_video_demo.mp4',
                                cv.VideoWriter_fourcc(*'mp4v'), 20,
                                tuple(args.resolution), True)
    stats = {}
    try:
        for _ in run(capture_frames(cap, args.resolution), engine, tracker,
                     draw=True, show=not args.benchmark, writer=writer,
                     max_frames=args.max_frames, stats=stats):
            pass
    finally:
        cap.release()
        if writer is not None:
            writer.release()
        if not args.benchmark:
            cv.destroyAllWindows()
    n, s = stats.get('frames', 0), stats.get('seconds', 0.0)
    print(f'processed {n} frames in {s:.2f}s '
          f'({n / max(s, 1e-9):.1f} fps end-to-end)')


if __name__ == '__main__':
    main()
