"""K8 (the Swin regressor's shifted-window attention) against its bound:
the least time for the bytes any implementation moves (each token's q, k
and v read once, its output written once, each block's bias table) and
the products at the bf16 tensor cores' peak, summed over the traced
calls (``trace['bounds']['window_attention']``, from the backbone's
reference file), over K8's device time in them, in %.  None where no
kernel of that name ran or the backbone counts no such bound."""

KERNEL = 'window_attn_kernel'


def read(trace):
    bounds = trace.get('bounds', {}).get('window_attention')
    if trace['kind'] != 'serve' or not bounds:
        return None
    times = [e - s for name, s, e in trace['events'] if KERNEL in name]
    if not times:
        return None
    return 100.0 * sum(bounds) / (sum(times) / 1e6)
