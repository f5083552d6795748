"""Single-image and directory inference CLI (port of
``mobilenet_yolo_tpu/cli/infer.py``; reference inference.py:13-106):

    python -m mobilenet_yolo_tpu_torch.cli.infer -c <params.npz> -y <data.yaml> -i <img|dir>

Resizes to ``--img-size`` (default 416) and maps pixels to ``x/255 - 0.5``
on the host like the reference demo (inference.py:111-115: it ignores the
config's image size and normalize statistics, so the images do not go
through ``make_predict_fn(normalize=True)``), runs the detect pipeline with
val_conf=0.3 (inference.py:46-47), draws boxes above conf*cls_conf > 0.15
(inference.py:83) and alpha-blends segmentation maps on the G/R channels
(inference.py:100-103). Writes ``<out-dir>/<name>_result.jpg``.

Weights: ``--random-weights`` (seeded ``build_model``), a flat ``.npz``
of the JAX package's variables (``tools_io.save_params_npz``'s format), or
a checkpoint directory of the port's trainer (``train/checkpoints.py``),
whose latest step is served: its averaged weights where the run kept them.
The model runs on ``--device`` (default ``cuda``, which raises without a
card).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch
from torch import nn

from mobilenet_yolo_tpu_torch.config import default_data_yaml, load_config
from mobilenet_yolo_tpu_torch.convert import load_flax_variables
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.tools_io import load_params_npz
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager, served_state_dict
from mobilenet_yolo_tpu_torch.utils.profiling import request_ms

TIMED_CALLS = 16
WARMUP_CALLS = 2


def get_args(argv=None):
    parser = argparse.ArgumentParser(description="YOLO Inference")
    parser.add_argument("-c", "--checkpoint", default="checkpoint", type=str,
                        help=".npz params file, or a checkpoint directory of the "
                             "port's trainer")
    parser.add_argument("-y", "--data_yaml", dest="data_yaml",
                        default=default_data_yaml())
    parser.add_argument("-i", "--input", default="images/000166.jpg",
                        help="an image file, or a DIRECTORY of images "
                             "(batched inference over every jpg/png)")
    parser.add_argument("--batch-size", default=16, type=int,
                        help="batch size for directory input (one batch shape; "
                             "the tail batch is padded)")
    parser.add_argument("--backbone", default="mbv2",
                        choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--img-size", default=416, type=int)
    parser.add_argument("--val-conf", default=0.3, type=float)
    parser.add_argument("--out-dir", default="save")
    parser.add_argument("--random-weights", action="store_true",
                        help="skip checkpoint loading (pipeline demo)")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    return parser.parse_args(argv)


def load_variables(model: nn.Module, checkpoint: str, random_ok: bool = False) -> nn.Module:
    """Load the served weights into ``model`` and return it: the model as
    built with ``random_ok``, else a flat ``.npz`` of the JAX package's
    variables through ``convert.load_flax_variables``, else the latest step
    of a checkpoint directory, its averaged weights where the run kept them
    (the weights it evaluated and chose its best by); ``strict=True``."""
    if random_ok:
        return model
    if checkpoint.endswith(".npz") and os.path.isfile(checkpoint):
        params, batch_stats = load_params_npz(checkpoint)
        return load_flax_variables(model, {"params": params, "batch_stats": batch_stats})
    if os.path.isdir(checkpoint):
        raw = CheckpointManager(checkpoint).restore_latest_raw()
        if raw is not None:
            model.load_state_dict(served_state_dict(raw), strict=True)
            return model
    raise FileNotFoundError(f"no loadable checkpoint at {checkpoint}")


def prep(path: str, size: int):
    """Reference preprocessing (inference.py:111-115): resize to the
    inference size, normalize (0.5,)/(1,). Returns (original RGB image,
    (size, size, 3) float32)."""
    from PIL import Image

    original = Image.open(path).convert("RGB")
    resized = original.resize((size, size), Image.BILINEAR)
    x = (np.asarray(resized, np.float32) / 255.0 - 0.5) / 1.0
    return original, x


def main(args):
    device = tool_device(args.device)
    cfg = load_config(args.data_yaml)
    classes = cfg.data["classes"]["map"]
    model = build_model(cfg.model, args.backbone, device=device,
                        generator=torch.Generator().manual_seed(0))
    model = load_variables(model, args.checkpoint, random_ok=args.random_weights)
    predict = make_predict_fn(model, cfg.model)
    val_conf = torch.tensor(args.val_conf, device=device)

    if os.path.isdir(args.input):
        return _run_directory(args, classes, predict, val_conf, device)

    original, x0 = prep(args.input, args.img_size)
    x = torch.from_numpy(x0[None]).to(device)
    out = predict(x, val_conf)
    per_call = request_ms(lambda: predict(x, val_conf), device=device, iters=TIMED_CALLS,
                          warmup=WARMUP_CALLS)
    print(f"model inference time : {per_call:.2f} ms (mean of {TIMED_CALLS} on "
          f"{device_name(device)}, host clock + synchronize)")

    dets = out[0][0].cpu().numpy()
    keep = out[1][0].cpu().numpy()
    seg_maps = out[2][0].cpu().numpy() if len(out) > 2 else None
    out_path = _draw_and_save(args, classes, original, args.input,
                              dets, keep, seg_maps, verbose=True)
    print(out_path)
    return out_path


def _draw_and_save(args, classes, original, src_path, dets, keep,
                   seg_maps, verbose=False, used: set | None = None):
    from mobilenet_yolo_tpu_torch.utils.visualize import (
        draw_detections, overlay_seg_maps, save_image)

    # draw gate: conf * cls_conf > 0.15 (reference inference.py:83)
    shown = dets[keep & (dets[:, 4] * dets[:, 5] > 0.15)]
    if verbose:
        print(f"{len(shown)} detections drawn")
    annotated = draw_detections(
        np.asarray(original), shown[:, :4],
        labels=shown[:, 6].astype(int), scores=shown[:, 4] * shown[:, 5],
        class_names=classes, normalized=True)
    if seg_maps is not None:
        # G/R channels of RGB (the reference blends BGR channels [1,2])
        annotated = overlay_seg_maps(annotated, seg_maps, channels=(1, 0))

    os.makedirs(args.out_dir, exist_ok=True)
    # splitext keeps dotted stems (img.v2.jpg -> img.v2); a counter
    # suffix disambiguates same-stem inputs (im0.jpg + im0.png) within
    # one directory run instead of silently overwriting
    name = os.path.splitext(os.path.basename(src_path))[0]
    out_path = os.path.join(args.out_dir, f"{name}_result.jpg")
    n = 1
    while used is not None and out_path in used:
        out_path = os.path.join(args.out_dir, f"{name}_result.{n}.jpg")
        n += 1
    if used is not None:
        used.add(out_path)
    save_image(out_path, annotated)
    return out_path


def _run_directory(args, classes, predict, val_conf, device):
    """Batched inference over a directory: one batch shape at
    --batch-size (the tail batch is zero-padded), annotated results
    written per image with the reference's <name>_result.jpg naming."""
    exts = (".jpg", ".jpeg", ".png", ".bmp")
    paths = sorted(
        os.path.join(args.input, f) for f in os.listdir(args.input)
        if f.lower().endswith(exts))
    if not paths:
        raise FileNotFoundError(f"no images under {args.input}")
    bs = max(1, args.batch_size)
    s = args.img_size

    written = []
    used: set = set()
    t_warm = n_warm = 0.0
    t0 = time.perf_counter()
    for start in range(0, len(paths), bs):
        chunk = paths[start:start + bs]
        originals, arrays = zip(*(prep(p, s) for p in chunk))
        batch = np.zeros((bs, s, s, 3), np.float32)
        batch[:len(chunk)] = np.stack(arrays)
        out = predict(torch.from_numpy(batch).to(device), val_conf)
        dets = out[0].cpu().numpy()      # the copy waits for this batch
        keep = out[1].cpu().numpy()
        segs = out[2].cpu().numpy() if len(out) > 2 else None
        for i, (orig, path) in enumerate(zip(originals, chunk)):
            written.append(_draw_and_save(
                args, classes, orig, path, dets[i], keep[i],
                segs[i] if segs is not None else None, used=used))
        if start == 0:
            # the first batch absorbs one-time work (the kernels' load,
            # cuDNN's algorithm search): the warm rate starts after it
            t_warm = time.perf_counter()
            n_warm = len(written)
    dt = time.perf_counter() - t0
    rate = ""
    if len(written) > n_warm:
        warm = (len(written) - n_warm) / (time.perf_counter() - t_warm)
        rate = (f" ({warm:.1f} img/s warm on {device_name(device)}, end-to-end incl. "
                f"decode, drawing and JPEG writes; {dt:.1f}s total)")
    print(f"{len(written)} images -> {args.out_dir}{rate}")
    return written


if __name__ == "__main__":
    main(get_args())
