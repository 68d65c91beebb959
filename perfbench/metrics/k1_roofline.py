"""K1 (the detector input's resize) against its bound: the least time the
card could take for the bytes K1 needs (each frame byte read once, the
300² input written once) and its operations, over K1's mean device time
a launch, in %."""

KERNEL = 'resize_tiled_u8_kernel'


def read(trace):
    if trace['kind'] != 'serve':
        return None
    times = [e - s for name, s, e in trace['events'] if KERNEL in name]
    if not times:
        return None
    return 100.0 * trace['k1_bound_s'] / (sum(times) / len(times) / 1e6)
