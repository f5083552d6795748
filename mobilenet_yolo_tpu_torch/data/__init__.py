"""The input pipeline (port of ``mobilenet_yolo_tpu/data/``): record shards,
decode and augmentation, mosaic, the device-geometry planner, ``Loader``,
``WorkerLoader`` and the dataset builder. Host code on numpy and cv2; the
batches it yields are numpy, moved to the card by ``batch_to_device``."""

from mobilenet_yolo_tpu_torch.data.records import RecordReader, RecordWriter  # noqa: F401
from mobilenet_yolo_tpu_torch.data.synthetic import synthetic_batches, synthetic_dataset  # noqa: F401
