"""The staged stem roofline probe on the card (port of ``tools/probe_stem_pallas.py``).

Each stage of ``kernels/stem_probe.py`` (``csrc/stem_probe.cu``) streams the
bytes of the 3x3/s2 RGB stem, (B, S, S*3) float32 in and (B, S/2, S/2*32)
bf16 out: a only streams them, b adds the stem's stencil access, c computes
the stem itself (conv, bias, ReLU6). Their times at batch 128, 352x352 are
the card's measured ceiling for any stem kernel, beside the bound (bytes
over HBM's rate). First a small-shape check of the kernel against its twin
and, for stage c, against ``F.conv2d`` on the same input (the probe's
oracle, ``probe_stem_pallas.py:148-155``); then, with ``--bench``,
CUDA-event times beside the bound (and their ratio, ``share_of_bound``),
the twin's time and, for stage c, the time of ``F.conv2d`` + bias + clamp
+ cast (``library_ms``, channels_last, TF32 off) and stage c's time over
stage a's on the same input (``vs_stage_a``).

    python -m mobilenet_yolo_tpu_torch.tools.probe_stem_cuda --stage a|b|c \\
        [--size 64] [--batch 8] [--bench] [--iters 20] [--device cuda|cpu]

``--interpret`` has no counterpart: a CUDA kernel has no interpret mode. On
``--device cpu`` the wrapper runs its plain twin, so the CPU run checks the
tool's plumbing and the twin against ``F.conv2d``, not the kernel.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from mobilenet_yolo_tpu_torch.kernels.stem_probe import (COUT, STAGES, probe_work, stem_probe,
                                                        stem_probe_reference)
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.utils.profiling import bound_ms, device_ms

BENCH_BATCH, BENCH_SIZE = 128, 352
# stage c against its twin and against F.conv2d, relative to the largest
# output: both sum 27 float32 products (a few ulp apart) and round to bf16
# once, so a rounding may tip by one bf16 spacing (2^-8 relative at worst)
C_REL_TOL = 2.0 ** -8


def bf16_spacing(t: torch.Tensor) -> float:
    """One bf16 spacing at the largest magnitude of ``t`` (8 bits of mantissa)."""
    top = float(t.float().abs().max())
    return 2.0 ** (np.floor(np.log2(top)) - 7) if top > 0 else 0.0


def tolerance(stage: str, want: torch.Tensor) -> float:
    """The kernel's allowed distance from ``want``. Stages a and b sum
    thousands of floats in another order than the twin and round once to
    bf16, so a rounding may tip by one bf16 spacing, at most that of the
    largest output; stage c within ``C_REL_TOL`` of the largest output."""
    if stage == "c":
        return C_REL_TOL * float(want.float().abs().max())
    return bf16_spacing(want)


def stage_inputs(stage: str, batch: int, size: int, device, seed: int = 0) -> tuple:
    """x (B, S, S*3) normal(0, 1) and, for c, w (9, 3, 32) normal(0, 0.2)
    and bias (32,) normal(0, 0.1), as the JAX probe draws them."""
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.normal(0, 1, (batch, size, size * 3)).astype(np.float32))
    if stage != "c":
        return (x.to(device),)
    w = torch.from_numpy(rng.normal(0, 0.2, (9, 3, COUT)).astype(np.float32))
    b = torch.from_numpy(rng.normal(0, 0.1, (COUT,)).astype(np.float32))
    return x.to(device), w.to(device), b.to(device)


def conv_stem(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Stage c through ``F.conv2d`` (channels_last): the same function in one
    library call plus bias, clamp and cast; (B, S/2, S/2*32) bf16."""
    bsz, s = x.shape[0], x.shape[1]
    img = x.reshape(bsz, s, s, 3).permute(0, 3, 1, 2)          # channels_last NCHW view
    weight = w.reshape(3, 3, 3, COUT).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)
    y = F.conv2d(img, weight, b, stride=2, padding=1).clamp_(0.0, 6.0)
    return y.permute(0, 2, 3, 1).to(torch.bfloat16).reshape(bsz, s // 2, s // 2 * COUT)


def check(stage: str, batch: int, size: int, device) -> dict:
    """The kernel against its twin at one shape (and stage c against
    ``F.conv2d``); raises past the tolerance. Returns the errors."""
    args = stage_inputs(stage, batch, size, device)
    got = stem_probe(*args[:1], stage, *args[1:])
    want = stem_probe_reference(*args[:1], stage, *args[1:])
    if got.shape != (batch, size // 2, size // 2 * COUT) or got.dtype != torch.bfloat16:
        raise RuntimeError(f"stage {stage}: output {tuple(got.shape)} {got.dtype}")
    err = float((got.float() - want.float()).abs().max())
    tol = tolerance(stage, want)
    result = {"stage": stage, "batch": batch, "size": size, "max_abs_err": err, "tol": tol}
    worst = err
    if stage == "c":
        conv = conv_stem(*args)
        result["conv2d_max_abs_err"] = float((got.float() - conv.float()).abs().max())
        worst = max(err, result["conv2d_max_abs_err"])
    if not worst <= tol:
        raise RuntimeError(f"stage {stage} at B={batch}, S={size}: error {worst} > {tol}")
    return result


def bench(stage: str, device, iters: int = 20) -> dict:
    """Kernel, twin and (stage c) library times at batch 128, 352x352,
    beside the bound: ``share_of_bound`` is the bound over the kernel's
    time. Stage c also times stage a on the same input, which streams the
    same bytes: ``vs_stage_a`` is stage c's time over stage a's."""
    batch, size = BENCH_BATCH, BENCH_SIZE
    args = stage_inputs(stage, batch, size, device, seed=1)
    x, extra = args[0], args[1:]
    flops, nbytes = probe_work(stage, batch, size)
    bound, bound_by = bound_ms(flops, nbytes)
    ms = device_ms(lambda: stem_probe(x, stage, *extra), device=device, iters=iters)
    result = {"stage": stage, "batch": batch, "size": size, "ms": ms,
              "plain_ms": device_ms(lambda: stem_probe_reference(x, stage, *extra),
                                    device=device, iters=max(iters // 4, 1)),
              "bound_ms": bound, "bound_by": bound_by, "share_of_bound": bound / ms,
              "library_ms": None, "gflop": flops / 1e9, "mb": nbytes / 1e6}
    if stage == "c":
        result["library_ms"] = device_ms(lambda: conv_stem(*args), device=device, iters=iters)
        result["stage_a_ms"] = device_ms(lambda: stem_probe(x, "a"), device=device, iters=iters)
        result["vs_stage_a"] = ms / result["stage_a_ms"]
    return result


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stage", choices=STAGES, default="a")
    ap.add_argument("--size", type=int, default=64)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--bench", action="store_true",
                    help=f"time at batch {BENCH_BATCH}, {BENCH_SIZE}x{BENCH_SIZE} after the check")
    ap.add_argument("--iters", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = tool_device(args.device)
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    result = {"device": device_name(device), "check": check(args.stage, args.batch, args.size,
                                                             device)}
    if args.bench:
        result["bench"] = bench(args.stage, device, iters=args.iters)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
