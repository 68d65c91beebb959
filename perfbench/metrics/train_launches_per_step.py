"""Device operations (kernels, copies, fills) a training step costs, over
the traced steps."""


def read(trace):
    if trace['kind'] != 'train' or not trace['events']:
        return None
    return len(trace['events']) / trace['units']
