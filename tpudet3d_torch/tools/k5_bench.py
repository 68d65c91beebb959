"""K5 (exact IoU of oriented 3D boxes) on one NVIDIA GPU: P pairs of
Objectron 9-keypoint boxes, f32 [P,9,3] x 2 -> [P].

    python tpudet3d_torch/tools/k5_bench.py [--trees DIR ...] [--out FILE]

Checks the kernel against its plain version (chip_smoke.py's random pairs
at every P timed, and its exact cases), then times it at P=8 (the most
one example of the evaluation protocol sends) and P=128 (a batch of the
metrics, ``eval/metrics.py``), back to back (CUDA events; the host's
dispatch through ctypes may set it) and on the device
(``torch.profiler``).  In the same process it times the launch floor, the
device time of an add on one float.  With ``--trees``, each DIR's own
``tpudet3d_torch``, its kernels built from its own sources, is timed in a
process of its own, in the order given (``--trees parent . . parent``
compares two checkouts in turns); every process makes the same inputs
from the same seeds.  Prints a JSON line per run with the card's name and
power limit and the K5 source's ``ptxas`` report.  ``--unchecked`` times
trees whose K5 is not meant to be right and only records their error.
Needs CUDA.
"""

import os
import sys

import torch

if not __package__:     # run as a script: the package is two levels up
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from chip_smoke import k5_exact_cases, k5_fuzz_pairs  # noqa: E402
from tpudet3d_torch.tools.k1_bench import (bench_main,  # noqa: E402
                                           cycle_ms, device_ms, gpu_line,
                                           launch_floor_ms, use_tree)

PAIRS = (8, 128)


def run_tree(tree, checked=True):
    """Times the K5 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.kernels.build import build
    from tpudet3d_torch.ops.box3d import (iou_oriented_boxes,
                                          iou_oriented_boxes_plain)
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('box3d_iou.cu')), '')
    dev = torch.device('cuda')
    inputs = {p: tuple(torch.from_numpy(x).to(dev)
                       for x in k5_fuzz_pairs(p, p)) for p in PAIRS}
    err = 0.0
    for a, b in inputs.values():
        err = max(err, (iou_oriented_boxes(a, b)
                        - iou_oriented_boxes_plain(a, b)).abs().max().item())
    for _, x, y, want in k5_exact_cases():
        got = iou_oriented_boxes(
            torch.tensor(x, dtype=torch.float32, device=dev),
            torch.tensor(y, dtype=torch.float32, device=dev))
        err = max(err, abs(float(got) - want))
    if checked and not err <= 1e-5:
        raise RuntimeError(f'k5_bench: K5 of {tree} disagrees: {err}')
    times = {}
    for p, (a, b) in inputs.items():
        def call(a=a, b=b):
            return iou_oriented_boxes(a, b)
        times[p] = dict(ms=cycle_ms([call], 300),
                        device_ms=device_ms(call, 200))
    return dict(tree=tree, gpu=gpu_line(), build_s=build_s,
                max_abs_err=err, floor_ms=launch_floor_ms(dev),
                pairs=times, ptxas=ptxas.strip())


def main():
    return bench_main(__file__, __doc__, run_tree)


if __name__ == '__main__':
    sys.exit(main())
