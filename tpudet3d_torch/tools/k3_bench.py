"""K3 (SSD decode, per-class top-K, NMS and the merge across classes) on
one NVIDIA GPU, at the serving path's shapes: N=16 images of A=2044
anchors and C=9 classes, K=32, max_det 8.

    python tpudet3d_torch/tools/k3_bench.py [--trees DIR ...] [--out FILE]

Times the kernel back to back at N=16 in the greedy, soft-NMS and box-vote
settings and at N=1, its device time (``torch.profiler``) at N=16 and N=1,
and a split: over a sweep of K and max_det and the three settings, the
device time of each CUDA kernel that one call launches and the gap between
two kernels of a call, and the device time at the large K of
max_detections 128 and 511.  Checks every setting against the plain
version first.  With ``--trees``, each DIR's own ``tpudet3d_torch``, its
kernels built from its own sources, is timed in a process of its own, in
the order given (``--trees parent . . parent`` compares two checkouts in turns);
every process makes the same inputs from the same seeds.  Prints a JSON
line per run with the card's name and power limit and the K3 source's
``ptxas`` report.  Needs CUDA.
"""

import argparse
import json
import os
import sys

import torch

if not __package__:     # run as a script: the package is two levels up
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from tpudet3d_torch.tools.cases import (K3_BASE, K3_SETTINGS,  # noqa: E402
                                        cycle_ms, det_batch)
from tpudet3d_torch.tools.k1_bench import (device_ms, gpu_line,  # noqa: E402
                                           run_trees, use_tree)

N = 16
# the split's sweep at N=16, each on top of K3_BASE
SPLIT = (('K=1 max_det 1', dict(pre_nms_k=1, max_per_img=1)),
         ('K=8', dict(pre_nms_k=8)), ('K=16', dict(pre_nms_k=16)),
         ('K=32', {}), ('K=64', dict(pre_nms_k=64)),
         ('K=128', dict(pre_nms_k=128)),
         ('K=32 max_det 1', dict(max_per_img=1)),
         ('soft', K3_SETTINGS['soft']), ('vote', K3_SETTINGS['vote']))
# the large K of max_detections 128 and 511 at N=16, on top of K3_BASE; a
# tree whose wrapper refuses a K records None for it
LARGE = (('K=512 max_det 128', dict(pre_nms_k=512, max_per_img=128)),
         ('K=512 max_det 128 soft', dict(pre_nms_k=512, max_per_img=128,
                                         **K3_SETTINGS['soft'])),
         ('K=2044 max_det 511', dict(pre_nms_k=2044, max_per_img=511)),
         ('K=2044 max_det 511 vote', dict(pre_nms_k=2044, max_per_img=511,
                                          **K3_SETTINGS['vote'])))


def det_err(out, ref):
    """Largest |kernel - plain| over the rows with score > 0 (padded rows
    carry arbitrary boxes); raises where kept rows or labels differ or a
    score is off by more than 1e-6 or a box by more than 1e-3 px."""
    keep = ref[..., 4] > 0
    if not torch.equal(out[..., 4] > 0, keep) \
            or not torch.equal(out[..., 5][keep], ref[..., 5][keep]):
        raise RuntimeError('K3: kept rows or labels differ')
    e_s = (out[..., 4] - ref[..., 4])[keep].abs().max().item()
    e_b = (out[..., :4] - ref[..., :4])[keep].abs().max().item()
    if not (e_s <= 1e-6 and e_b <= 1e-3):
        raise RuntimeError(f'K3 disagrees: score {e_s}, box {e_b} px')
    return max(e_s, e_b)


def kernel_split(fn, calls=50):
    """Per call of ``fn``: ``{kernel name: device ms}`` and the mean gap in
    ms from the end of one kernel to the start of the next kernel of the
    same call (None when a call launches one kernel)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.time_range.start)
    per_call = len(events) // calls
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) \
            + e.time_range.elapsed_us() / 1e3 / calls
    gaps = [events[i + 1].time_range.start - events[i].time_range.end
            for i in range(len(events) - 1) if i % per_call != per_call - 1]
    return dict(kernels=by_name, launches=len(events) / calls,
                gap_ms=sum(gaps) / len(gaps) / 1e3 if gaps else None)


def k3_times(decode, logits, deltas, anchors):
    """``decode`` (a K3 wrapper) on batch ``logits``/``deltas``: ms back to
    back in each setting, at N=1, and on the device at N=16 and N=1."""
    def call(n, setting='greedy'):
        kw = dict(K3_BASE, **K3_SETTINGS[setting])
        return lambda: decode(logits[:n], deltas[:n], anchors, **kw)
    out = {f'ms_{s}': cycle_ms([call(len(logits), s)], 200)
           for s in K3_SETTINGS}
    out.update(ms_n1=cycle_ms([call(1)], 200),
               device_ms=device_ms(call(len(logits))),
               device_ms_n1=device_ms(call(1)))
    return out


def run_tree(tree):
    """Times the K3 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.detect import (decode_detections,
                                       decode_detections_plain,
                                       generate_anchors)
    from tpudet3d_torch.kernels.build import build
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('decode_nms.cu')), '')
    dev = torch.device('cuda')
    logits, deltas = (torch.from_numpy(x).to(dev) for x in det_batch(N))
    anchors = torch.from_numpy(generate_anchors()).to(dev)
    err = 0.0
    for setting in K3_SETTINGS:
        kw = dict(K3_BASE, **K3_SETTINGS[setting])
        err = max(err, det_err(
            decode_detections(logits, deltas, anchors, **kw),
            decode_detections_plain(logits, deltas, anchors, **kw)))
    split = {name: kernel_split(
        lambda kw=dict(K3_BASE, **kw): decode_detections(
            logits, deltas, anchors, **kw)) for name, kw in SPLIT}
    large = {}
    for name, kw in LARGE:
        kw = dict(K3_BASE, **kw)
        try:
            err = max(err, det_err(
                decode_detections(logits, deltas, anchors, **kw),
                decode_detections_plain(logits, deltas, anchors, **kw)))
        except ValueError:          # a wrapper that refuses this K
            large[name] = None
            continue
        large[name] = device_ms(lambda kw=kw: decode_detections(
            logits, deltas, anchors, **kw), calls=10)
    return dict(tree=tree, gpu=gpu_line(), build_s=build_s,
                max_abs_err=err,
                **k3_times(decode_detections, logits, deltas, anchors),
                split=split, large_device_ms=large, ptxas=ptxas.strip())


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trees', nargs='+', default=None,
                    help='checkouts to time in turns, each in a process of '
                    'its own')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--out', default='')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k3_bench: CUDA is not available', file=sys.stderr)
        return 1
    if args.tree:
        print(json.dumps(run_tree(args.tree)))
        return 0
    runs = run_trees(__file__, args.trees or [os.getcwd()])
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(runs, f, indent=1)
    return 0


if __name__ == '__main__':
    sys.exit(main())
