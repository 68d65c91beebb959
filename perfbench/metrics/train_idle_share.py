"""The share of a training step's wall time in which the card runs nothing
of the step's own work: 1 - the device's busy time a traced step (the
union of its events, the collectives' kernels left out: under a process
group they spin while they wait for the other ranks) over the wall time a
step of the untraced window took, in %."""

from harness.common import busy_intervals


def read(trace):
    if trace['kind'] != 'train' or not trace['events']:
        return None
    own = [e for e in trace['events'] if 'nccl' not in e[0].lower()]
    busy = sum(e - s for s, e in busy_intervals(own)) / 1e6
    return 100.0 * (1.0 - busy / trace['units'] / trace['unit_wall_s'])
