"""Running meter (counterpart of svnet_tpu/train/meters.py)."""

from __future__ import annotations


class AverageMeter:
    """Running mean/sum meter: ``accum='mean'`` weights each value by n,
    ``'sum'`` adds values that are already sums over n items."""

    def __init__(self, accum: str = "mean"):
        self.accum = accum
        self.reset()

    def reset(self):
        self.val = self.avg = self.sum = 0.0
        self.count = 0

    def update(self, val: float, n: int = 1):
        if self.accum == "mean":
            self.sum += val * n
            self.val = val
        elif self.accum == "sum":
            self.sum += val
            self.val = val / n
        self.count += n
        self.avg = self.sum / self.count
        self.avg100 = self.avg * 100
        self.val100 = self.val * 100
