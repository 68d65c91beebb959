"""Device operations (kernels, copies, fills) a served frame costs: the
traced calls' device events over their frames.  The host dispatches each
one, so fewer of them is what CUDA graphs and fused layers buy."""


def read(trace):
    if trace['kind'] != 'serve' or not trace['events']:
        return None
    return len(trace['events']) / (trace['units'] * trace['items_per_unit'])
