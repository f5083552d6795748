"""Learning-rate schedule.

Port of ``mobilenet_yolo_tpu/train/schedule.py`` (reference
train.py:164-185,441-450): the rate starts at ``base * 0.5^len(warm_up)``,
doubles at each warm-up epoch and halves at each schedule epoch, both
before that epoch's pass. Plain Python, so it is the JAX function's
arithmetic exactly.
"""

from __future__ import annotations

from typing import Sequence

DEFAULT_SCHEDULE = (100, 170, 240)


def learning_rate_for_epoch(base_lr: float, epoch: int,
                            schedule: Sequence[int] = DEFAULT_SCHEDULE,
                            warm_up: Sequence[int] = ()) -> float:
    lr = base_lr * (0.5 ** len(warm_up))
    for e in warm_up:
        if epoch >= e:
            lr *= 2.0
    for e in schedule:
        if epoch >= e:
            lr *= 0.5
    return lr
