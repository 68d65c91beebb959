"""Data-parallel training traffic: the port's regressor train step as
``train.py`` drives it, over a process group of ``ranks`` processes, one a
card, each stepping its own ``batch`` rows of every global batch of
``ranks × batch`` rows.

The traffic file gives ``ranks``, ``batch`` (a rank's rows), ``size``,
``pool`` (global batches), ``calibration_images`` and each process's host
``threads``; the configuration file what it gives ``train.py``.

Each rank is a process spawned by ``torch.multiprocessing`` that joins the
group through the port's ``parallel/sharding.py``
``maybe_init_distributed``, as the CLIs do: NCCL on the cards (gloo on
the CPU), at an address on a port found free by binding port 0.  Under
the group the port's step computes what one process would over the
global batch: ``_SyncBatchNorm``'s statistics, the gradients averaged in
one flat all-reduce, the augmentations and the dropout mask drawn for the
global batch, of which each rank keeps the rows ``rank::ranks``.  So rank
``r`` is dealt the rows ``r::ranks`` of each seeded global batch.

Set-up on every rank, as ``train.py``'s: the global pool, of which the
rank keeps its rows; the weights, drawn and calibrated as for one card
and broadcast from rank 0; the train state and its first three steps.
In the window every rank steps back to back until some rank's clock has
passed ``--seconds``: the ranks vote after each step over a gloo group on
the host, so that no rank waits on its card for it, and read the vote one
step later, so that no host waits for the others' within a step.  With
``--trace 1`` every rank runs the traced steps; rank 0's trace (kind
``train``, its operations over a rank's rows) is the one the readers
get, with the device's busy time averaged over the ranks.

``correct``: the reference follows the first three steps over the global
rows in float32 on rank 0's card, and rank 0's state is judged by
``train.py``'s numbers.  Beside them ``rank_param_gap``: the largest
difference of a parameter, an EMA value or a running statistic between
two ranks after those steps, 0 when the ranks hold one state.
"""

import socket
import time
from types import SimpleNamespace

import torch
import torch.distributed as dist

from . import inputs, train
from .common import cuda, forbidden_modules, split as _split

# a test's planted fault: a module-level function ``plant(rank, ranks)``
# that each rank calls before it builds its state; None in the
# benchmark's runs
PLANT = None
DEADLINE_S = 1200       # past the window: a rank still running has hung


def free_port():
    """A TCP port on the loopback that nothing listens on now."""
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def run(ctx):
    """One run of a data-parallel training cell: the ranks' processes,
    started and waited for; rank 0's result, with the peak of the fullest
    card."""
    ranks = ctx.traffic['ranks']
    mp = torch.multiprocessing.get_context('spawn')
    queue = mp.SimpleQueue()
    args = dict(vars(ctx), port=free_port(), ranks=ranks)
    procs = torch.multiprocessing.start_processes(
        _rank_main, args=(args, PLANT, queue), nprocs=ranks, join=False,
        start_method='spawn')
    got, deadline = {}, time.perf_counter() + ctx.seconds + DEADLINE_S
    try:
        while not procs.join(timeout=0.5):        # raises if a rank failed
            _drain(queue, got)
            if time.perf_counter() > deadline:
                raise RuntimeError(f'ranks still running after '
                                   f'{DEADLINE_S} s past the window')
        _drain(queue, got)
    finally:
        for p in procs.processes:
            if p.is_alive():
                p.terminate()
            p.join()
    if sorted(got) != list(range(ranks)):
        raise RuntimeError(f'results of ranks {sorted(got)} of {ranks}')
    bad = sorted({m for r in got.values() for m in r['forbidden']})
    if bad:
        raise SystemExit(f'perfbench: a rank loaded {bad}: the port must '
                         f'run without JAX')
    out = got[0]['result']
    out['memory_peak_bytes'] = max(r['peak'] for r in got.values())
    if out['trace'] is not None:
        out['trace']['busy_s'] = sum(r['busy_s'] for r in got.values()) \
            / ranks
    return out


def _drain(queue, got):
    while not queue.empty():
        rank, payload = queue.get()
        got[rank] = payload


def _rank_main(rank, args, plant, queue):
    """One rank: joins the group, runs, and puts ``(rank, payload)`` on
    ``queue``."""
    began = time.perf_counter()
    ctx = SimpleNamespace(**args)
    torch.set_num_threads(ctx.traffic['threads'])
    from tpudet3d_torch.parallel import sharding
    on_card = torch.device(ctx.device).type == 'cuda'
    group = {'data_parallel': dict(
        use_parallel=True, coordinator_address=f'127.0.0.1:{ctx.port}',
        num_processes=ctx.ranks, process_id=rank)}
    dev = sharding.maybe_init_distributed(
        group, f'cuda:{rank}' if on_card else 'cpu')
    try:
        marks = [('start', began), ('group', time.perf_counter())]
        payload = _rank_run(ctx, rank, dev, plant, marks)
        payload['forbidden'] = forbidden_modules()
        queue.put((rank, payload))
    finally:
        dist.destroy_process_group()


def _rank_run(ctx, rank, dev, plant, marks):
    cfg, tr, ranks = ctx.cfg, ctx.traffic, ctx.ranks
    size, classes = tr['size'], cfg['regressor']['num_classes']
    rows = ranks * tr['batch']
    glob = inputs.train_pool(ctx.seed, tr['pool'], rows, size, classes, dev)
    pool = [tuple(t[rank::ranks].contiguous() for t in b) for b in glob]
    calib = glob[0][0][:tr['calibration_images']].clone()
    del glob
    marks.append(('inputs', time.perf_counter()))
    ref, init = train.reference_model(cfg, ctx.seed, calib, dev)
    for k, v in init.items():                       # one start on every rank
        t = v.to(dev)
        dist.broadcast(t, 0)
        init[k] = train._host(t)
    marks.append(('weights', time.perf_counter()))
    ref.cpu()
    if rank:
        del ref
    cuda(dev, torch.cuda.empty_cache)
    cuda(dev, torch.cuda.reset_peak_memory_stats, dev)
    if plant is not None:
        plant(rank, ranks)
    state, step = train.build_state(cfg, init, dev)
    gen = torch.Generator(device=dev).manual_seed(
        inputs.stream_seed(ctx.seed, 'augment'))
    beta1 = float(cfg['train']['optim']['betas'][0])
    host_group = dist.new_group(backend='gloo')
    marks.append(('program', time.perf_counter()))
    prog = train.first_steps(step, state, pool, gen, beta1)
    gap = rank_gap(state)
    cuda(dev, torch.cuda.synchronize, dev)
    marks.append(('first steps', time.perf_counter()))
    setup_s = time.perf_counter() - ctx.t0

    steps, asked = train.SETUP_STEPS, None
    start = time.perf_counter()
    while True:
        step(state, *pool[steps % len(pool)], gen)
        steps += 1
        # the ranks' vote after the step before, exchanged while this one
        # was dispatched: every rank stops after the same step
        if asked is not None:
            asked[1].wait()
            if asked[0][0]:
                break
        vote = torch.tensor([float(time.perf_counter() - start
                                   >= ctx.seconds)])
        asked = vote, dist.all_reduce(vote, op=dist.ReduceOp.MAX,
                                      group=host_group, async_op=True)
    cuda(dev, torch.cuda.synchronize, dev)
    window_s = time.perf_counter() - start
    done = steps - train.SETUP_STEPS

    trace = None
    if ctx.trace:
        trace = train.traced(step, state, pool, gen, steps, cfg, tr,
                             window_s, done, ctx.trace_calls, dev)
    peak = cuda(dev, torch.cuda.max_memory_allocated, dev) or 0
    payload = dict(peak=int(peak),
                   busy_s=trace['busy_s'] if trace else None)
    del state, step
    cuda(dev, torch.cuda.empty_cache)
    if rank:
        return payload
    glob = inputs.train_pool(ctx.seed, train.SETUP_STEPS, rows, size,
                             classes, dev)
    numbers = train.judge(ref, init, glob, prog, cfg, ctx.seed, dev,
                          ctx.control)
    numbers['rank_param_gap'] = gap
    payload['result'] = dict(
        e2e={'train_images_per_s': done * rows / window_s,
             'setup_s': setup_s},
        attempted=done * rows, numbers=numbers, trace=trace,
        window=dict(steps=done, window_s=window_s,
                    setup=_split(ctx.t0, marks)))
    return payload


def rank_gap(state):
    """The largest difference of a parameter, an EMA value or a running
    statistic between two ranks (collective: every rank calls it)."""
    leaves = [p.detach() for p in state.model.parameters()]
    leaves += list(state.ema_params.values())
    leaves += [v for k, v in state.model.named_buffers() if 'running' in k]
    flat = torch.cat([t.float().reshape(-1) for t in leaves])
    hi, lo = flat.clone(), flat.clone()
    dist.all_reduce(hi, op=dist.ReduceOp.MAX)
    dist.all_reduce(lo, op=dist.ReduceOp.MIN)
    return float((hi - lo).max())
