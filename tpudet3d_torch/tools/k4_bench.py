"""K4 (the regressor-head epilogue) on one NVIDIA GPU: pre-activations
[B',9,18] f32 and bf16 logits [B',9] of B crops (B' = 2B with TTA) to the
packed rows [B,26] or the next pass's boxes [B,4].

    python tpudet3d_torch/tools/k4_bench.py [--trees DIR ...] [--out FILE]

Checks the kernel against its plain version (on chip_smoke.py's inputs,
with and without NaNs and ties in the logits), then times it at B=128
(a serving pass: 16 frames × 8 crops) and B=8, in pack and refine mode,
with TTA off and on: back to back (CUDA events; the host's dispatch
through ctypes may set it) and on the device (``torch.profiler``).  In the
same process it times the launch floor, the device time of an add on one
float.  With ``--trees``, each DIR's own ``tpudet3d_torch``, its kernels
built from its own sources, is timed in a process of its own, in the order
given (``--trees parent . . parent`` compares two checkouts in turns);
every process makes the same inputs from the same seeds.  Prints a JSON
line per run with the card's name and power limit and the K4 source's
``ptxas`` report.  ``--unchecked`` times trees whose K4 is not meant to be
right and only records their error.  Needs CUDA.
"""

import os
import sys

import torch

if not __package__:     # run as a script: the package is two levels up
    sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__)))))
from chip_smoke import K4_REFINE, k4_error, k4_inputs  # noqa: E402
from tpudet3d_torch.tools.k1_bench import (bench_main,  # noqa: E402
                                           cycle_ms, device_ms, gpu_line,
                                           launch_floor_ms, use_tree)

# (B, mode, TTA); the first is the serving path's last pass
CASES = tuple((b, mode, tta) for b in (128, 8) for mode in ('pack', 'refine')
              for tta in (False, True))


def case_args(b, mode, tta, dev, nan_ties=False, seed=5):
    """The arguments of one K4 call: ``(pre, logits, boxes), kwargs``."""
    pre, logits, boxes, dets = (torch.from_numpy(a).to(dev) for a in
                                k4_inputs(b, tta, seed, nan_ties))
    kw = dict(tta_w=224 if tta else 0)
    kw.update(dict(refine=K4_REFINE) if mode == 'refine'
              else dict(dets=dets, det_conf=0.5))
    return (pre, logits.bfloat16(), boxes), kw


def run_tree(tree, checked=True):
    """Times the K4 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.infer.epilogue import (head_epilogue,
                                               head_epilogue_plain)
    from tpudet3d_torch.kernels.build import build
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('head_epilogue.cu')), '')
    dev = torch.device('cuda')
    err, cases = 0.0, {}
    for b, mode, tta in CASES:
        name = f'b{b}_{mode}' + ('_tta' if tta else '')
        for nan_ties in (False, True):
            args, kw = case_args(b, mode, tta, dev, nan_ties)
            e, ok = k4_error(head_epilogue(*args, **kw),
                             head_epilogue_plain(*args, **kw),
                             mode == 'refine')
            if checked and not ok:
                raise RuntimeError(f'k4_bench: K4 of {tree} disagrees on '
                                   f'{name} (NaN/ties {nan_ties}): {e}')
            err = max(err, e)
        args, kw = case_args(b, mode, tta, dev)

        def call(args=args, kw=kw):
            return head_epilogue(*args, **kw)
        cases[name] = dict(ms=cycle_ms([call], 300),
                           device_ms=device_ms(call, 200))
    return dict(tree=tree, gpu=gpu_line(), build_s=build_s,
                max_abs_err=err, floor_ms=launch_floor_ms(dev),
                cases=cases, ptxas=ptxas.strip())


def main():
    return bench_main(__file__, __doc__, run_tree)


if __name__ == '__main__':
    sys.exit(main())
