"""The training split on the card (port of ``tools/bench_train.py``).

Times the component chain fwd (train-mode BatchNorm) -> +loss -> +backward
-> the full step (AdamW included) on the VOC MBv2-YOLO at full width, with
CUDA events, so each stage's delta is attributable; and training MFU from
the FLOPs of the fwd+loss+bwd chain against the card's peak (67 TFLOP/s in
float32 with TF32 off, 989 TFLOP/s dense bf16). ``--remat`` recomputes the
backbone blocks in the backward (``build_model``'s ``remat``); ``--dtype
bf16`` runs the forward under autocast with float32 parameters and loss.

    python -m mobilenet_yolo_tpu_torch.tools.bench_train [--batch-size 128] \\
        [--img-size 352] [--dtype f32|bf16] [--remat] [--iters 24] [--step-only] \\
        [--json] [--device cuda|cpu]

The JAX tool's ``--no-donate`` has no counterpart: a PyTorch step updates
the parameters, statistics and optimizer state in place, so there are no
input buffers to donate or keep.
"""

from __future__ import annotations

import argparse
import json
import math

import torch
from torch.utils.flop_counter import FlopCounterMode, conv_backward_flop

from mobilenet_yolo_tpu_torch.config import VOC_CONFIG
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.train import create_train_state, make_loss_fn, make_train_step
from mobilenet_yolo_tpu_torch.utils.profiling import BF16_FLOPS, F32_FLOPS, device_ms

DTYPES = {"f32": None, "bf16": torch.bfloat16}


def build_component_programs(model: torch.nn.Module, loss_fn, gt, n_gt, dtype=None):
    """The component-chain stages as functions of the images (B, H, W, 3):
    ``fwd`` (the train-mode heads), ``fwd_loss`` (the loss) and ``fwd_bwd``
    (the loss and a checksum of every parameter's gradient).

    The JAX tool returns the checksum so that XLA cannot drop the backward
    as dead code (``tools/bench_train.py:35-59``); PyTorch runs eagerly and
    drops nothing, and the contract stays. ``fwd`` and ``fwd_loss`` run
    without autograd, as their jitted JAX twins keep no residuals; the
    backward stage computes the gradients with ``torch.autograd.grad`` and
    leaves the parameters' ``.grad`` alone.
    """
    autocast = dtype in (torch.bfloat16, torch.float16)
    params = [p for p in model.parameters() if p.requires_grad]

    @torch.no_grad()
    def fwd(images):
        model.train()
        with torch.autocast(images.device.type, dtype=dtype, enabled=autocast):
            return model(images.permute(0, 3, 1, 2))

    @torch.no_grad()
    def fwd_loss(images):
        return loss_fn(images, gt, n_gt)[0]

    def fwd_bwd(images):
        loss = loss_fn(images, gt, n_gt)[0]
        grads = torch.autograd.grad(loss, params)
        return loss.detach(), sum(g.sum() for g in grads)

    return fwd, fwd_loss, fwd_bwd


def _conv_backward_flops(grad_out_shape, x_shape, w_shape, bias, stride, padding, dilation,
                         transposed, output_padding, groups, output_mask, out_shape=None,
                         **kwargs) -> int:
    """A convolution's backward: the forward's FLOPs once for each gradient
    it computes (input, weight). PyTorch's own formula ignores ``groups``
    and counts a depthwise conv's backward about C/2 times over."""
    if transposed:
        return conv_backward_flop(grad_out_shape, x_shape, w_shape, bias, stride, padding,
                                  dilation, transposed, output_padding, groups, output_mask,
                                  out_shape)
    forward = 2 * math.prod(grad_out_shape) * math.prod(w_shape[1:])
    return forward * (int(output_mask[0]) + int(output_mask[1]))


def count_flops(fn, *args) -> float:
    """FLOPs of one call of ``fn(*args)``, by ``torch.utils.flop_counter``.

    It counts the convolutions and matrix products (and their backward)
    only, while the JAX tool's XLA cost analysis counts every op, so the
    two counts, and the MFU from them, differ by the elementwise work.
    """
    counter = FlopCounterMode(display=False, custom_mapping={
        torch.ops.aten.convolution_backward: _conv_backward_flops})
    with counter:
        fn(*args)
    return float(counter.get_total_flops())


def setup(batch_size: int, img_size: int, remat: bool, device, seed: int = 0):
    """The VOC MBv2-YOLO from ``seed`` (channels_last on the card), a batch of
    normal images (B, S, S, 3) and one box per image."""
    config = {**VOC_CONFIG, "remat": remat}
    model = build_model(config, device=device, generator=torch.Generator().manual_seed(seed))
    if device.type == "cuda":
        model = model.to(memory_format=torch.channels_last)
    gen = torch.Generator(device=device).manual_seed(seed)
    images = torch.randn((batch_size, img_size, img_size, 3), generator=gen, device=device)
    gt = torch.zeros((batch_size, 30, 5), device=device)
    gt[:, 0] = torch.tensor([1.0, 0.5, 0.5, 0.4, 0.4], device=device)
    n_gt = torch.ones((batch_size,), dtype=torch.int32, device=device)
    return model, config, images, gt, n_gt


def run(batch_size: int = 128, img_size: int = 352, dtype: str = "f32", remat: bool = False,
        iters: int = 24, step_only: bool = False, device="cuda") -> dict:
    device = tool_device(device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    model, config, images, gt, n_gt = setup(batch_size, img_size, remat, device)
    autocast_dtype = DTYPES[dtype]

    def timed(fn):
        return device_ms(fn, device=device, iters=iters, warmup=3)

    results = {"device": device_name(device)}
    if not step_only:
        loss_fn = make_loss_fn(model, config, dtype=autocast_dtype)
        fwd, fwd_loss, fwd_bwd = build_component_programs(model, loss_fn, gt, n_gt,
                                                          autocast_dtype)
        results["fwd_ms"] = timed(lambda: fwd(images))
        results["fwd_loss_ms"] = timed(lambda: fwd_loss(images))
        results["fwd_loss_bwd_ms"] = timed(lambda: fwd_bwd(images))
        results["bwd_delta_ms"] = results["fwd_loss_bwd_ms"] - results["fwd_loss_ms"]

    state = create_train_state(model)
    step = make_train_step(model, config, dtype=autocast_dtype)
    results["step_ms"] = timed(lambda: step(state, images, gt, n_gt))
    if not step_only:
        results["update_delta_ms"] = results["step_ms"] - results["fwd_loss_bwd_ms"]
    results["img_per_s"] = batch_size * 1e3 / results["step_ms"]

    if not step_only:
        flops = count_flops(fwd_bwd, images)
        results["fwd_loss_gflops"] = count_flops(fwd_loss, images) / 1e9
        results["bwd_chain_gflops"] = flops / 1e9
        if device.type == "cuda":
            peak = BF16_FLOPS if dtype == "bf16" else F32_FLOPS
            results["training_mfu_pct"] = 100.0 * flops / (results["fwd_loss_bwd_ms"] * 1e-3) / peak
    return results


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch-size", type=int, default=128)
    ap.add_argument("--img-size", type=int, default=352)
    ap.add_argument("--dtype", choices=list(DTYPES), default="f32")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--iters", type=int, default=24)
    ap.add_argument("--step-only", action="store_true",
                    help="time only the full train step (skips the component chain and MFU)")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    results = run(args.batch_size, args.img_size, args.dtype, args.remat, args.iters,
                  args.step_only, args.device)
    record = {"label": (f"batch {args.batch_size} {args.img_size}x{args.img_size} {args.dtype}"
                        + (" remat" if args.remat else "")), **results}
    if args.json:
        print(json.dumps(record), flush=True)
    else:
        print(f"== {record.pop('label')} on {record.pop('device')} ==")
        for k, v in record.items():
            print(f"  {k:>20}: {v:9.3f}")
    return record


if __name__ == "__main__":
    main()
