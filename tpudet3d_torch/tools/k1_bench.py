"""K1 (the antialiased preprocess resize) on one NVIDIA GPU, at batch 16 of
720p → 300² bf16 with the channel reversal and the 1/255 scale.

    python tpudet3d_torch/tools/k1_bench.py [--trees DIR ...] [--out FILE]

Times the kernel warm (back-to-back launches on one 44 MB batch, which the
50 MB L2 partly holds), cold (launches cycling over 3 batches, 133 MB, so
that each finds its input evicted) and at N=1, and checks it against its
plain version.  With ``--trees``, each DIR's own ``tpudet3d_torch``, its
kernels built from its own sources, is timed in a process of its own, in
the order given (``--trees parent . . parent`` compares two checkouts in
turns); every process makes the same inputs from the same seeds.  Prints a
JSON line per run with the card's name and power limit and the resize
source's ``ptxas`` report.  Needs CUDA.
"""

import argparse
import json
import os
import shutil
import subprocess
import sys

import torch

FRAME = (720, 1280, 3)
OUT_HW = (300, 300)


def cycle_ms(fns, iters):
    """Mean device time per call over ``iters`` calls that cycle through
    ``fns`` (CUDA events, after one warm-up call of each)."""
    for fn in fns:
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(iters):
        fns[i % len(fns)]()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, calls=50):
    """Device time per call of the kernels that ``fn`` launches, summed
    from ``torch.profiler`` (None if it records no device activity).  A
    kernel shorter than its host dispatch shows its own time here."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    return (sum(e.time_range.elapsed_us() for e in events) / 1e3 / calls
            if events else None)


def launch_floor_ms(dev, calls=200):
    """Device time of the smallest PyTorch kernel, an add on one float, by
    :func:`device_ms`: what a launch costs on the device before any work
    (None if the profiler records no device activity)."""
    one = torch.zeros(1, device=dev)
    return device_ms(lambda: one.add_(1.0), calls)


def k1_times(resize, batches):
    """``resize`` (a K1 wrapper) on ``batches`` of uint8 frames, whose total
    exceeds the L2: warm ms on the first, cold ms cycling over all, warm
    ms at N=1 (back to back, so the host's dispatch may set it) and the
    N=1 kernel's own device time."""
    def call(f):
        return lambda: resize(f, OUT_HW, True, 1 / 255.0, torch.bfloat16)
    return dict(ms=cycle_ms([call(batches[0])], 50),
                ms_cold=cycle_ms([call(b) for b in batches], 60),
                ms_n1=cycle_ms([call(batches[0][:1])], 200),
                device_ms_n1=device_ms(call(batches[0][:1])))


def library_times(batches):
    """``F.interpolate(antialias=True)`` on float32 NCHW copies of
    ``batches``, warm and cycling, as for :func:`k1_times`."""
    import torch.nn.functional as F
    xs = [b.permute(0, 3, 1, 2).float().contiguous() for b in batches]

    def call(x):
        return lambda: F.interpolate(x, size=OUT_HW, mode='bilinear',
                                     antialias=True, align_corners=False)
    return dict(library_ms=cycle_ms([call(xs[0])], 20),
                library_ms_cold=cycle_ms([call(x) for x in xs], 30))


def gpu_line():
    res = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return res.stdout.strip().splitlines()[0]


def use_tree(tree):
    """Makes ``import tpudet3d_torch`` find ``tree``'s package, and drops
    the modules of the package already imported (this tool's own)."""
    sys.path.insert(0, os.path.abspath(tree))
    for name in [m for m in sys.modules if m.startswith('tpudet3d_torch')]:
        del sys.modules[name]


def run_tree(tree):
    """Times the K1 of the ``tpudet3d_torch`` found in ``tree``."""
    use_tree(tree)
    from tpudet3d_torch.kernels.build import build
    from tpudet3d_torch.ops import resize_bilinear, resize_bilinear_plain
    _, build_s, log = build()
    ptxas = next((part for part in log.split('== ')
                  if part.startswith('resize.cu')), '')
    dev = torch.device('cuda')
    gen = torch.Generator(device=dev).manual_seed(0)
    batches = [torch.randint(0, 256, (16, *FRAME), dtype=torch.uint8,
                             device=dev, generator=gen) for _ in range(3)]
    err = (resize_bilinear(batches[0], OUT_HW, True, 1 / 255.0,
                           torch.bfloat16).float()
           - resize_bilinear_plain(batches[0], OUT_HW, True, 1 / 255.0)
           ).abs().max().item()
    if not err <= 2 ** -8:
        raise RuntimeError(f'k1_bench: K1 of {tree} disagrees: {err}')
    return dict(tree=tree, gpu=gpu_line(), build_s=build_s,
                max_abs_err=err, **k1_times(resize_bilinear, batches),
                ptxas=ptxas.strip())


def run_trees(script, trees, timeout=600, extra=()):
    """Runs ``script --tree DIR`` (then ``extra``) for each of ``trees`` in
    a process of its own, in the order given, and returns the JSON object
    that each prints last (printing each, its ``ptxas`` report left out,
    as it comes)."""
    runs = []
    for tree in trees:
        res = subprocess.run([sys.executable, os.path.abspath(script),
                              '--tree', tree, *extra], capture_output=True,
                             text=True, timeout=timeout)
        if res.returncode:
            print(res.stdout + res.stderr, file=sys.stderr)
            raise RuntimeError(f'{os.path.basename(script)} failed on {tree}')
        runs.append(json.loads(res.stdout.strip().splitlines()[-1]))
        print(json.dumps({k: v for k, v in runs[-1].items()
                          if k != 'ptxas'}), flush=True)
    for tree, ptxas in {r['tree']: r['ptxas'] for r in runs}.items():
        print(f'{tree} ptxas:\n{ptxas}')
    return runs


def write_copies(tree, dest, csrc, texts):
    """For each ``name: text`` of ``texts``, writes a copy of ``tree``'s
    ``tpudet3d_torch`` (its built kernels left out) to ``dest``/name whose
    ``kernels/csrc/`` file ``csrc`` holds ``text``; returns the copies'
    directories, which ``--trees`` can time."""
    base = os.path.join(tree, 'tpudet3d_torch')
    out = []
    for name, text in texts.items():
        d = os.path.join(dest, name)
        shutil.rmtree(d, ignore_errors=True)
        shutil.copytree(base, os.path.join(d, 'tpudet3d_torch'),
                        ignore=shutil.ignore_patterns('_build', '__pycache__'))
        with open(os.path.join(d, 'tpudet3d_torch/kernels/csrc', csrc),
                  'w') as f:
            f.write(text)
        out.append(d)
    return out


def bench_main(script, doc, run_tree, phase_copies=None):
    """The command line of an A/B tool ``script`` (described by ``doc``)
    whose ``run_tree(tree, checked)`` times one checkout's kernel:
    ``--trees`` (in turns, each in a process of its own), ``--out``,
    ``--unchecked`` and, with ``phase_copies(tree, dest)``,
    ``--phase-copies DEST``.  Returns the exit code."""
    ap = argparse.ArgumentParser(description=doc.split('\n')[0])
    ap.add_argument('--trees', nargs='+', default=None,
                    help='checkouts to time in turns, each in a process of '
                    'its own')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--unchecked', action='store_true',
                    help='do not require the kernel to match its plain '
                    'version')
    ap.add_argument('--out', default='')
    if phase_copies:
        ap.add_argument('--phase-copies', default='', metavar='DEST',
                        help='write copies of the kernel that return after '
                        'a phase to DEST and exit')
    args = ap.parse_args()
    if phase_copies and args.phase_copies:
        print('\n'.join(phase_copies((args.trees or [os.getcwd()])[0],
                                      args.phase_copies)))
        return 0
    name = os.path.basename(script)[:-3]
    if not torch.cuda.is_available():
        print(f'{name}: CUDA is not available', file=sys.stderr)
        return 1
    if args.tree:
        print(json.dumps(run_tree(args.tree, not args.unchecked)))
        return 0
    runs = run_trees(script, args.trees or [os.getcwd()],
                     extra=['--unchecked'] if args.unchecked else [])
    if args.out:
        with open(args.out, 'w') as f:
            json.dump(runs, f, indent=1)
    return 0


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--trees', nargs='+', default=None,
                    help='checkouts to time in turns, each in a process of '
                    'its own')
    ap.add_argument('--tree', default=None, help=argparse.SUPPRESS)
    ap.add_argument('--out', default='')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print('k1_bench: CUDA is not available', file=sys.stderr)
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
