"""K2 (the regressor's crops) against its bound: the least time for the
bytes K2 needs (the source pixels the traced calls' crop boxes touch read
once, the crops written once) and its operations, summed over the traced
calls, over K2's device time in them, in %."""

KERNEL = 'crop_band_kernel'


def read(trace):
    if trace['kind'] != 'serve':
        return None
    times = [e - s for name, s, e in trace['events'] if KERNEL in name]
    if len(times) != len(trace['k2_bound_s']):
        return None
    return 100.0 * sum(trace['k2_bound_s']) / (sum(times) / 1e6)
