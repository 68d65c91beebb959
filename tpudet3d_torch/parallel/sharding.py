"""Data parallelism over a ``torch.distributed`` process group
(counterpart of ``tpudet3d/parallel/sharding.py``).

The JAX package lays one program over a ``Mesh('data')``: the batch is
sharded, the parameters replicated, and GSPMD computes every reduction
over the global batch.  Here each process drives one device and holds the
rows ``rank::world`` of each global batch (the loader's interleaved
slice); what JAX computes globally is reduced explicitly:

* training batch norm normalises with the global batch's statistics
  (``models/layers.py``);
* the gradient is averaged over the processes once per step
  (``all_reduce_mean``), so the optimizer, its state and the EMA stay
  equal on every rank;
* ALWA adds the global mean of the step's losses to its sums
  (``global_mean``);
* per-sample draws (augmentations, dropout) are made for the global batch
  from the shared seeded generator and each rank keeps its own rows
  (``local_rows``).

Every collective is an ``all_reduce`` (a gather is a sum into zeros), the
one collective both ``nccl`` and ``gloo`` carry for tensors on the card.
Without a group, or with a group of one process, every function here is
the identity and the single-device path is unchanged.

``spawn_group`` starts a local group of processes on this host, each
joined through ``maybe_init_distributed``, runs one function in each and
brings every rank's result back: the CPU tests run it with ``gloo`` and
the card smoke (``chip_smoke.py``) with ``gloo`` on one card or ``nccl``
on several.
"""

import os

import numpy as np
import torch
import torch.distributed as dist

__all__ = ['maybe_init_distributed', 'group_line', 'world', 'rank',
           'is_main_process',
           'group_device', 'local_batch', 'local_batch_slice', 'local_rows',
           'all_reduce_sum', 'all_reduce_mean', 'global_mean', 'gather_rows',
           'barrier', 'free_port', 'group_config', 'group_main',
           'spawn_group']

_DEVICE = None      # the device this process's collectives run on


def maybe_init_distributed(cfg=None, device=None, backend=None):
    """Join the process group a run asks for; returns this process's
    device.

    The group's address, size and this process's rank come from
    ``cfg.data_parallel`` (``coordinator_address`` as ``host:port``,
    ``num_processes``, ``process_id``, as the JAX package's multi-host
    hook reads them) or else from torchrun's environment (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR``, ``MASTER_PORT``, ``LOCAL_RANK``).
    ``data_parallel.use_parallel=False`` means no group (one device, as
    JAX's ``devices[:1]``); ``num_devices``, when set, must equal the
    group's size.  With no group asked for, no group is made; an address
    from the config or torchrun makes one, even of one process.

    ``device`` is the card unless ``'cpu'``; a process on the card drives
    ``cuda:{LOCAL_RANK}`` (its rank modulo the visible cards when
    ``LOCAL_RANK`` is unset).  ``backend`` defaults to ``nccl`` on the
    card and ``gloo`` on the CPU; ``gloo`` on the card only when asked
    for, and ``nccl`` on the CPU is refused: nothing switches quietly."""
    global _DEVICE
    from ..core.device import resolve_device
    device = resolve_device(device)
    if dist.is_available() and dist.is_initialized():
        _DEVICE = _process_device(device, dist.get_rank())
        return _DEVICE
    dp = (cfg.get('data_parallel') if cfg is not None else None) or {}
    if dp and not dp.get('use_parallel', True):
        return device
    if dp.get('coordinator_address'):
        address = f"tcp://{dp['coordinator_address']}"
        size, rank_ = int(dp['num_processes']), int(dp['process_id'])
    elif 'WORLD_SIZE' in os.environ and 'RANK' in os.environ:
        address = 'env://'
        size, rank_ = int(os.environ['WORLD_SIZE']), int(os.environ['RANK'])
    else:
        return device
    if dp.get('num_devices') and int(dp['num_devices']) != size:
        raise ValueError(f'data_parallel.num_devices={dp["num_devices"]} but '
                         f'the group has {size} processes')
    if backend is None:
        backend = 'nccl' if device.type == 'cuda' else 'gloo'
    if backend == 'nccl' and device.type != 'cuda':
        raise ValueError('the nccl backend needs the card; pass '
                         'backend="gloo" for a group on the CPU')
    device = _process_device(device, rank_)
    kwargs = {}
    if backend == 'nccl':
        kwargs['device_id'] = device
    dist.init_process_group(backend, init_method=address, world_size=size,
                            rank=rank_, **kwargs)
    _DEVICE = device
    return device


def group_line():
    """``process group: <backend>, world <n>, rank <r>`` under a group, else
    None (the CLIs log it)."""
    if not (dist.is_available() and dist.is_initialized()):
        return None
    return (f'process group: {dist.get_backend()}, world '
            f'{dist.get_world_size()}, rank {dist.get_rank()}')


def _process_device(device, rank_):
    if device.type != 'cuda':
        return device
    if device.index is not None:
        index = device.index
    else:
        index = int(os.environ.get('LOCAL_RANK',
                                   rank_ % torch.cuda.device_count()))
    torch.cuda.set_device(index)
    return torch.device('cuda', index)


def world():
    """The number of processes in the default group (1 without one)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def rank():
    """This process's rank (0 without a group)."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def is_main_process():
    return rank() == 0


def group_device():
    """The device this process's collectives run on."""
    if _DEVICE is not None:
        return _DEVICE
    if world() > 1 and dist.get_backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def local_batch(global_batch_size):
    """This process's share of a global batch size (configs give global
    sizes, as the JAX package's mesh shards them)."""
    w = world()
    if global_batch_size % w:
        raise ValueError(f'batch {global_batch_size} does not split over '
                         f'{w} processes')
    return global_batch_size // w


def local_batch_slice(global_batch_size):
    """The rows of a global batch this process holds: ``rank::world``, the
    loader's interleaved slice (``data/loader.py``), where the JAX
    package's multi-host feeding takes a contiguous block."""
    return slice(rank(), global_batch_size, world())


def local_rows(tree):
    """Each tensor of ``tree`` (nested dicts, lists, tuples) drawn for the
    global batch → this process's rows ``rank::world``."""
    w = world()
    if w == 1:
        return tree
    r = rank()
    if isinstance(tree, torch.Tensor):
        return tree[r::w]
    if isinstance(tree, dict):
        return {k: local_rows(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(local_rows(v) for v in tree)
    return tree


def all_reduce_sum(t):
    """``t`` summed over the processes, in place; returned."""
    if world() > 1:
        dist.all_reduce(t)
    return t


def all_reduce_mean(tensors):
    """Average each tensor of ``tensors`` over the processes in place, in
    one collective over a flat float32 buffer (the gradients of a step)."""
    w = world()
    if w == 1 or not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat)
    flat.div_(w)
    offset = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[offset:offset + n].view_as(t))
        offset += n
    return tensors


def global_mean(*values):
    """0-d tensors → their means over the processes, each carrying its own
    process's gradient (``v + (mean - v).detach()``): a loss computed on
    the global value whose gradient, averaged over the processes by
    ``all_reduce_mean``, is the global one's."""
    w = world()
    if w == 1:
        return values if len(values) > 1 else values[0]
    stacked = torch.stack([v.detach().float() for v in values])
    dist.all_reduce(stacked)
    stacked.div_(w)
    out = tuple(v + (m.to(v.dtype) - v).detach()
                for v, m in zip(values, stacked))
    return out if len(out) > 1 else out[0]


def gather_rows(rows):
    """A host array ``[n_i, ...]`` on each process → the concatenation in
    rank order, on every process (float64 through the group's device)."""
    rows = np.asarray(rows, np.float64)
    w = world()
    if w == 1:
        return rows
    dev = group_device()
    counts = torch.zeros(w, dtype=torch.float64, device=dev)
    counts[rank()] = rows.shape[0]
    dist.all_reduce(counts)
    counts = counts.cpu().numpy().astype(np.int64)
    tail = rows.shape[1:]
    width = int(np.prod(tail, dtype=np.int64))
    buf = torch.zeros((int(counts.sum()), width), dtype=torch.float64,
                      device=dev)
    start = int(counts[:rank()].sum())
    if rows.shape[0]:
        buf[start:start + rows.shape[0]] = torch.from_numpy(
            rows.reshape(rows.shape[0], width)).to(dev)
    dist.all_reduce(buf)
    return buf.cpu().numpy().reshape(-1, *tail)


def barrier():
    if world() > 1:
        if dist.get_backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def free_port():
    """A TCP port on 127.0.0.1 that no socket holds now."""
    import socket
    with socket.socket() as s:
        s.bind(('127.0.0.1', 0))
        return s.getsockname()[1]


def group_config(port, world, rank):
    """The ``data_parallel`` config of rank ``rank`` of a local group of
    ``world`` processes meeting at 127.0.0.1:``port``."""
    from ..core.config import AttrDict
    return AttrDict(data_parallel=dict(
        use_parallel=True, coordinator_address=f'127.0.0.1:{port}',
        num_processes=world, process_id=rank))


def group_main(rank, world, port, device, backend, work, args, out):
    """One process of a local group of ``world``: joins it through
    ``backend`` on ``device`` (``{rank}`` stands for the rank), runs
    ``work(dev, world, rank, *args)`` and saves what it returns to ``out``
    (``{rank}`` likewise)."""
    dev = maybe_init_distributed(group_config(port, world, rank),
                                 device.format(rank=rank), backend=backend)
    try:
        torch.save(work(dev, world, rank, *args), out.format(rank=rank))
    finally:
        dist.destroy_process_group()


def spawn_group(world, backend, device, work, args, tmp, timeout):
    """Each rank's result of ``work`` (a module-level function, see
    :func:`group_main`) in a group of ``world`` spawned processes; fails
    when a process fails or outlives ``timeout`` seconds, and leaves none
    running.  ``device``: ``'cuda:0'`` for gloo on one card (NCCL refuses
    two ranks on one device), ``'cuda:{rank}'`` for nccl, ``'cpu'``.  The
    processes import ``work``'s module afresh."""
    import time
    ctx = torch.multiprocessing.get_context('spawn')
    port = free_port()
    out = os.path.join(str(tmp), f'group_{world}_{{rank}}.pt')
    procs = [ctx.Process(target=group_main,
                         args=(r, world, port, device, backend, work,
                               tuple(args), out))
             for r in range(world)]
    for p in procs:
        p.start()
    deadline = time.time() + timeout
    try:
        for p in procs:
            p.join(max(deadline - time.time(), 1.0))
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(5)
    codes = [p.exitcode for p in procs]
    if codes != [0] * world:
        raise RuntimeError(f'{backend} group of {world}: processes exited '
                           f'{codes}')
    return [torch.load(out.format(rank=r), weights_only=False)
            for r in range(world)]
