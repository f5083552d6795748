"""Training: the AdamW state, the learning-rate schedule and the train
steps, plain and device-geometry; the epoch loop (``train.loop``),
checkpoints (``train.checkpoints``) and the HPO seam (``train.hpo``)
(port of ``mobilenet_yolo_tpu/train/``)."""

from mobilenet_yolo_tpu_torch.train.schedule import learning_rate_for_epoch  # noqa: F401
from mobilenet_yolo_tpu_torch.train.state import TrainState, create_train_state, make_optimizer  # noqa: F401
from mobilenet_yolo_tpu_torch.train.step import (  # noqa: F401
    GEOMETRY_BATCH_KEYS,
    make_eval_step,
    make_geometry_train_step,
    make_loss_fn,
    make_train_step,
)
from mobilenet_yolo_tpu_torch.train.synthetic import random_geometry_batch  # noqa: F401
