"""Train state: the model, its AdamW optimizer, the EMA copy and bookkeeping.

Port of ``mobilenet_yolo_tpu/train/state.py``. The JAX package carries
params, batch_stats and optax state as one pytree; here the model owns its
parameters and BatchNorm statistics, the optimizer its moments, and the
state holds both by reference, so a train step updates them in place.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
from torch import nn


def make_optimizer(params, learning_rate: float = 7e-4,
                   weight_decay: float = 4e-4) -> torch.optim.AdamW:
    """AdamW of the reference recipe (train.py:134: lr 7e-4, wd 4e-4,
    betas (0.9, 0.999), eps 1e-8), decaying every parameter as optax's
    ``adamw`` does with no mask. optax's update ``-lr * (m_hat /
    (sqrt(v_hat) + eps) + wd * p)`` and torch's decoupled ``p *= 1 - lr*wd``
    followed by the Adam step agree to rounding. The rate is mutable
    through ``param_groups`` (``TrainState.with_lr``)."""
    return torch.optim.AdamW(params, lr=learning_rate, betas=(0.9, 0.999), eps=1e-8,
                             weight_decay=weight_decay)


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    epoch: int = 0
    best_acc: float = 0.0
    val_conf: float = 0.1
    # batches already consumed in the current epoch (0 = epoch boundary)
    batch_idx: int = 0
    # exponential moving average of the parameters by name (None = off);
    # the live BatchNorm statistics pair with it, as in the JAX package
    ema: dict[str, torch.Tensor] | None = None

    def with_lr(self, lr: float) -> "TrainState":
        """Set the learning rate of every parameter group (the counterpart
        of optax's injected hyperparameter); returns ``self``."""
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        return self

    def optimizer_steps(self) -> int:
        """Adam's step count (0 before the first update)."""
        for group in self.optimizer.param_groups:
            for p in group["params"]:
                step = self.optimizer.state.get(p, {}).get("step")
                if step is not None:
                    return int(step)
        return 0


def create_train_state(model: nn.Module, learning_rate: float = 7e-4,
                       weight_decay: float = 4e-4, val_conf: float = 0.1,
                       ema: bool = False) -> TrainState:
    """State for ``model`` as it stands (its device, dtype and weights)."""
    return TrainState(
        model=model,
        optimizer=make_optimizer(model.parameters(), learning_rate, weight_decay),
        val_conf=val_conf,
        ema=({name: p.detach().clone() for name, p in model.named_parameters()}
             if ema else None))
