"""The process group's device time a training step: the milliseconds of
the traced steps' collective kernels (names holding ``nccl``: the
synchronised batch norms' statistics, the flat gradient all-reduce, the
metrics' all-reduce), waiting for the other ranks included, over the
steps.  None where no collective ran."""


def read(trace):
    if trace['kind'] != 'train':
        return None
    times = [e - s for name, s, e in trace['events']
             if 'nccl' in name.lower()]
    if not times:
        return None
    return sum(times) / 1e3 / trace['units']
