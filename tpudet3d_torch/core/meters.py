"""Running statistics and plain-text tables (copy of
``tpudet3d/core/meters.py``): the training log and the validation table
print character for character as the JAX package's do."""

__all__ = ['AverageMeter', 'TextTable']


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0
        self.avg = 0
        self.sum = 0
        self.count = 0

    def update(self, val, n=1):
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count


class TextTable:
    """Minimal pretty-printed ASCII table (PrettyTable-compatible subset)."""

    def __init__(self, field_names, float_format='.4'):
        self.field_names = list(field_names)
        self.float_format = float_format
        self.rows = []

    def add_row(self, row):
        if len(row) != len(self.field_names):
            raise ValueError(f'a row of {len(row)} cells for '
                             f'{len(self.field_names)} columns')
        self.rows.append(list(row))

    def _fmt(self, v):
        if isinstance(v, float):
            return format(v, f'{self.float_format}f')
        return str(v)

    def __str__(self):
        cells = [self.field_names] + [[self._fmt(v) for v in r]
                                      for r in self.rows]
        widths = [max(len(row[i]) for row in cells)
                  for i in range(len(self.field_names))]
        sep = '+' + '+'.join('-' * (w + 2) for w in widths) + '+'
        lines = [sep]
        for r, row in enumerate(cells):
            lines.append('|' + '|'.join(f' {c:^{w}} '
                                        for c, w in zip(row, widths)) + '|')
            if r == 0:
                lines.append(sep)
        lines.append(sep)
        return '\n'.join(lines)
