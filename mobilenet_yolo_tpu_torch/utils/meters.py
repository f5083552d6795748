"""Running metric meters (reference utils/misc.py:59-75).

A copy of ``mobilenet_yolo_tpu/utils/meters.py``: stdlib and numpy only.
"""

from __future__ import annotations


class AverageMeter:
    """Computes and stores the average and current value."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.avg = 0.0
        self.sum = 0.0
        self.count = 0

    def update(self, val, n: int = 1):
        val = float(val)
        self.val = val
        self.sum += val * n
        self.count += n
        self.avg = self.sum / self.count if self.count else 0.0


class MeterDict:
    """A dict of AverageMeters keyed lazily — convenient for metric pytrees."""

    def __init__(self):
        self.meters: dict[str, AverageMeter] = {}

    def update(self, metrics: dict, n: int = 1):
        for k, v in metrics.items():
            self.meters.setdefault(k, AverageMeter()).update(float(v), n)

    def averages(self) -> dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __getitem__(self, k):
        return self.meters[k]


def get_mean_and_std(images) -> tuple:
    """Per-channel mean/std over a dataset of HWC float images in [0, 1]
    (reference utils/misc.py:get_mean_and_std)."""
    import numpy as np

    total = np.zeros(3, np.float64)
    total_sq = np.zeros(3, np.float64)
    n = 0
    for img in images:
        flat = np.asarray(img, np.float64).reshape(-1, img.shape[-1])
        total += flat.sum(0)
        total_sq += (flat ** 2).sum(0)
        n += flat.shape[0]
    mean = total / n
    std = np.sqrt(total_sq / n - mean ** 2)
    return mean, std
