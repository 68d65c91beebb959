"""The share of a serving call's wall time in which the card runs nothing:
1 - the device's busy time a traced call (the union of its events) over
the wall time a call of the untraced window took, in %."""

from harness.common import busy_intervals


def read(trace):
    if trace['kind'] != 'serve' or not trace['events']:
        return None
    busy = sum(e - s for s, e in busy_intervals(trace['events'])) / 1e6
    return 100.0 * (1.0 - busy / trace['units'] / trace['unit_wall_s'])
