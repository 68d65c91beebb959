"""Run one cell of the benchmark of ``tpudet3d_torch`` once, on the cards of
this machine, and print its result as the last line of standard output.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> \\
        --trace <0|1>

Everything is found by name from ``BENCHMARK.json`` at the root of the
checkout: the cell's configuration file (``configs``' ``file``), its
traffic mix (``perfbench/traffic/<traffic>.json``, whose ``kind`` names
the module that runs it, ``perfbench/harness/<kind>.py``) and, with
``--trace 1``, its per-layer metrics (``perfbench/metrics/<name>.py``).
``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
per-layer ones with the device's busy time and the traced window.

``--control fp8`` puts the float32 reference, every conv's, dense
layer's and matmul's operands rounded to float8, in the program's place:
the control, whose runs must come out not correct.  The benchmark's own
runs do not use it.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
TRACE_CALLS = 5        # calls or steps under the profiler in a traced run


def load_cell(name, root=ROOT):
    """``(bench, cell, config, traffic)`` of workload ``name``."""
    with open(root / 'BENCHMARK.json') as f:
        bench = json.load(f)
    cells = {w['name']: w for w in bench['workloads']}
    if name not in cells:
        raise SystemExit(f'unknown workload {name!r}; BENCHMARK.json has '
                         f'{sorted(cells)}')
    cell = cells[name]
    entry = {c['name']: c for c in bench['configs']}[cell['config']]
    with open(root / entry['file']) as f:
        config = json.load(f)
    with open(root / HERE.name / 'traffic' / f'{cell["traffic"]}.json') as f:
        traffic = json.load(f)
    return bench, cell, config, traffic


def driver(kind):
    """``run(ctx)`` of traffic kind ``kind``: ``perfbench/harness/<kind>.py``,
    found by name, so that a new kind is a new file."""
    if importlib.util.find_spec(f'harness.{kind}') is None:
        raise SystemExit(f'traffic kind {kind!r} has no driver '
                         f'{HERE.name}/harness/{kind}.py')
    fn = getattr(importlib.import_module(f'harness.{kind}'), 'run', None)
    if not callable(fn):
        raise SystemExit(f'{HERE.name}/harness/{kind}.py defines no run')
    return fn


def limits_of(config, traffic):
    """The limits of this traffic's kind in the configuration file."""
    return config['limits'][traffic['kind']]


def verdict(numbers, limits):
    """``(correct, checks)``: every limited number within its limit."""
    checks = {k: {'value': numbers[k], 'limit': v}
              for k, v in limits.items()}
    ok = all(numbers[k] <= v for k, v in limits.items())
    return ok, checks


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    ap.add_argument('--control', choices=('fp8',), default=None)
    args = ap.parse_args(argv)

    sys.path.insert(0, str(HERE))
    sys.path.insert(1, str(ROOT))
    bench, cell, config, traffic = load_cell(args.workload)

    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell['chips']:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f'perfbench: {cell["name"]} needs {cell["chips"]} CUDA '
              f'device(s); this machine has {have}', file=sys.stderr)
        return 2
    return run_cell(bench, cell, config, traffic, args.seed, args.seconds,
                    args.trace, args.control, 'cuda')


def run_cell(bench, cell, config, traffic, seed, seconds, trace, control,
             device):
    """Drive one run of ``cell`` on ``device`` and print its result; the
    exit code.  The tests call it on the CPU at small sizes."""
    import torch
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from harness import common
    run_kind = driver(traffic['kind'])
    ctx = SimpleNamespace(seed=seed, seconds=seconds, trace=bool(trace),
                          control=control, cfg=config, traffic=traffic,
                          device=device, t0=T0, trace_calls=TRACE_CALLS)
    out = run_kind(ctx)
    return report(bench, cell, out, limits_of(config, traffic), trace,
                  common, device)


def report(bench, cell, out, limits, trace, common, device):
    """Print the result of a run; the exit code."""
    import torch
    bad = common.forbidden_modules()
    if bad:
        print(f'perfbench: loaded {bad}: the port must run without JAX',
              file=sys.stderr)
        return 3
    correct, checks = verdict(out['numbers'], limits)
    metrics = {}
    if trace:
        metrics = common.per_layer(bench, cell, out['trace'])
    else:
        units = {m['name']: m['unit'] for m in bench['end_to_end']}
        for name, value in out['e2e'].items():
            metrics[name] = {'value': float(value), 'unit': units[name]}
    on_card = torch.device(device).type == 'cuda'
    device = {'platform': 'gpu' if on_card else 'cpu',
              'kind': torch.cuda.get_device_name(0) if on_card else 'cpu',
              'count': cell['chips'],
              'memory_peak_bytes': out['memory_peak_bytes']}
    result = {'correct': bool(correct), 'attempted': out['attempted'],
              'failed': 0 if correct else out['attempted'],
              'metrics': metrics, 'device': device}
    if trace:
        device['busy_s'] = out['trace']['busy_s']
        device['window_s'] = out['trace']['window_s']
        result['breakdown'] = out['trace']['breakdown']
    print(f'card: {common.card_line()}; window: {out["window"]}; numbers: '
          f'{json.dumps(out["numbers"])}', file=sys.stderr)
    common.emit(result, checks)
    return 0


if __name__ == '__main__':
    sys.exit(main())
