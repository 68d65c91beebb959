"""The whole training step's share of the card's bf16 peak: the conv and
matmul operations of one step's forward and backward (the regressor
over the batch), counted on the float32 reference at the cell's shapes,
times the steps of the untraced window over its wall time, in %."""

from harness.yardstick import PEAK_BF16_FLOPS


def read(trace):
    if trace['kind'] != 'train':
        return None
    return 100.0 * trace['flops_per_unit'] / trace['unit_wall_s'] \
        / PEAK_BF16_FLOPS
