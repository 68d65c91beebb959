"""The whole serving call's share of the card's bf16 peak: the conv and
matmul operations of one call (the detector over the batch, the regressor
over its crops), counted on the float32 reference at the cell's shapes,
times the calls of the untraced window over its wall time, in %."""

from harness.yardstick import PEAK_BF16_FLOPS


def read(trace):
    if trace['kind'] != 'serve':
        return None
    return 100.0 * trace['flops_per_unit'] / trace['unit_wall_s'] \
        / PEAK_BF16_FLOPS
