"""End-to-end detection: model forward -> decode -> batched NMS.

Port of ``mobilenet_yolo_tpu/eval/detector.py:23-108``
(``make_predict_fn``). PyTorch runs eagerly, so there is no jit: ``predict``
is a plain function under ``torch.inference_mode``. ``val_conf`` is a 0-d
tensor, as the traced scalar is in JAX.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn

from mobilenet_yolo_tpu_torch.ops.anchors import scaled_anchors
from mobilenet_yolo_tpu_torch.ops.decode import decode_predictions, reshape_head
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms
from mobilenet_yolo_tpu_torch.parallel.mesh import all_gather_cat
from mobilenet_yolo_tpu_torch.utils.profiling import span


def _to_device(arr: np.ndarray, device: torch.device) -> torch.Tensor:
    # a pageable non_blocking copy is staged at once and does not wait for
    # the work already queued on the device
    return torch.from_numpy(arr).to(device, non_blocking=True)


def make_predict_fn(model: nn.Module, config: dict, top_k: int = 256,
                    iou_threshold: float = 0.45, normalize: bool = False,
                    dtype: torch.dtype | None = None, mesh=None) -> Callable:
    """Build ``predict(images, val_conf) -> (dets, keep[, seg])``.

    * images: (B, H, W, 3) NHWC batch on the model's device, normalized.
      With ``normalize=True`` it takes raw [0, 255] pixels (uint8 or float)
      and applies the config's mean/std on the device. A contiguous NHWC
      tensor permuted to NCHW is already ``channels_last``, so the model
      runs in that memory format with no copy.
    * val_conf: 0-d tensor, the ``conf > val_conf`` gate.
    * dets: (B, K, 7) ``(x1, y1, x2, y2, conf, cls_score, cls_idx)``
      normalized, float32; keep: (B, K) bool; seg: (B, H/16, W/16,
      seg_classes) sigmoid maps, if the model has a segmentation head.

    ``model`` is put in eval mode and ``channels_last`` memory here.

    ``dtype=torch.bfloat16`` serves in bf16 through ``torch.autocast``: the
    convolutions run in bf16 with the float32 weights cast per call, and
    BatchNorm normalizes its bf16 input with float32 statistics and affine
    parameters. Flax ``dtype=bf16`` (``models/layers.py:75-92``) also keeps
    the params in float32 but runs the BatchNorm arithmetic in bf16. The
    heads are cast to float32 before decode here, where JAX decodes in the
    compute dtype, so bf16 only changes the logits, never the decode or NMS
    arithmetic.

    With ``mesh`` (``detector.py:95-108``) the batch splits along the data
    axis: ``images`` are this rank's rows (``parallel.mesh.global_batch`` of
    a host-complete batch), each rank runs the forward, decode, top-K and
    NMS (and so the NMS kernel, and the fused kernels on a folded model) on
    them, and the outputs are gathered over the data group, so every rank
    returns the whole batch's. Under a model axis above 1 a model split by
    ``parallel.sharding.shard_over_model_axis`` runs its column-parallel
    layers over the model group.

    Each call opens, in turn, ``myt:normalise``, the model's spans,
    ``myt:decode`` (the heads' decode and the seg sigmoid) and
    ``batched_nms``'s ``myt:select`` and ``myt:nms``
    (``utils.profiling.span``: recorded while a profiler records host
    activity).
    """
    yolo_cfg = config["yolo"]
    anchors_px = np.asarray(yolo_cfg["anchors"], np.float32)
    masks = [np.asarray(m) for m in yolo_cfg["mask"]]
    num_anchors = int(yolo_cfg["num_anchors"])
    autocast = dtype is not None and dtype != torch.float32
    if normalize:
        norm_cfg = config.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
        norm_mean = np.asarray(norm_cfg["mean"], np.float32)
        norm_std = np.asarray(norm_cfg["std"], np.float32)
    model.eval()
    model.to(memory_format=torch.channels_last)

    @torch.inference_mode()
    def predict(images: torch.Tensor, val_conf: torch.Tensor):
        h, w = images.shape[1], images.shape[2]
        device = images.device
        anchors_norm = scaled_anchors(anchors_px, w, h)
        if normalize:
            with span("myt:normalise"):
                images = ((images.to(torch.float32) / 255.0 - _to_device(norm_mean, device))
                          / _to_device(norm_std, device))
        with torch.autocast(device.type, dtype=dtype, enabled=autocast):
            outputs = model(images.permute(0, 3, 1, 2))

        with span("myt:decode"):
            flats = []
            for head_key, mask in zip(("out0", "out1"), masks):
                head = outputs[head_key].permute(0, 2, 3, 1).float()
                pred = reshape_head(head, num_anchors)
                flats.append(decode_predictions(pred, _to_device(anchors_norm[mask], device)))
            preds = torch.cat(flats, dim=1)
            seg = (() if "seg" not in outputs
                   else (torch.sigmoid(outputs["seg"].permute(0, 2, 3, 1).float()),))
        dets, keep = batched_nms(preds, val_conf, top_k=top_k,
                                 iou_threshold=iou_threshold)
        out = (dets, keep, *seg)
        if mesh is not None:
            out = tuple(all_gather_cat(t, mesh.data_group) for t in out)
        return out

    return predict
