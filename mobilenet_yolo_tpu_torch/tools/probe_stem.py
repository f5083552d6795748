"""The stem-conv layout probe on the card (port of ``tools/probe_stem.py``).

Times four cuDNN formulations of the 3x3/s2 RGB stem (32 channels) at batch
128, 352x352, in bf16, on channels_last tensors:

  a) conv 3x3/s2 on (352, 352, 3): the model's stem;
  b) conv 2x2/s1 (pad 1 above and left) on (176, 176, 12): the same math on
     a host-side space-to-depth layout, the weights folded by ``fold_s2d``;
  c) b) after an on-device space-to-depth;
  d) conv 2x2/s1 on a double space-to-depth (88, 88, 48) with a (2, 2, 48,
     128) fold (``fold_s2d4``), then depth-to-space back to (176, 176, 32).

plus each one's largest difference from a), and a), b) and d) again on a
bf16-resident input. Every fold gives a)'s output up to the order of its
sums.

    python -m mobilenet_yolo_tpu_torch.tools.probe_stem [--batch 128] [--size 352] \\
        [--iters 32] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch
import torch.nn.functional as F

from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.utils.profiling import device_ms

COUT = 32


def space_to_depth(x: np.ndarray, block: int) -> np.ndarray:
    """(B, S, S, C) -> (B, S/block, S/block, block*block*C), channel order
    (dy, dx, c)."""
    b, s, _, c = x.shape
    n = s // block
    y = x.reshape(b, n, block, n, block, c).transpose(0, 1, 3, 2, 4, 5)
    return np.ascontiguousarray(y.reshape(b, n, n, block * block * c))


def fold_s2d(k: np.ndarray) -> np.ndarray:
    """(3, 3, 3, C) HWIO -> (2, 2, 12, C) (``probe_stem.py:43-53``): output
    block tap (bi, bj), channel (dy, dx, c) reads the original tap
    (2*bi + dy - 1, 2*bj + dx - 1)."""
    c = k.shape[-1]
    k4 = np.zeros((2, 2, 12, c), np.float32)
    for bi in range(2):
        for bj in range(2):
            for dy in range(2):
                for dx in range(2):
                    ky, kx = 2 * bi + dy - 1, 2 * bj + dx - 1
                    if 0 <= ky < 3 and 0 <= kx < 3:
                        k4[bi, bj, dy * 6 + dx * 3:dy * 6 + dx * 3 + 3] = k[ky, kx]
    return k4


def fold_s2d4(k: np.ndarray) -> np.ndarray:
    """(3, 3, 3, C) -> (2, 2, 48, 4C): output block tap (bi, bj), channel
    (dy, dx, c), output phase (u, v) reads the original tap (4*bi + dy -
    (2*u + 3), 4*bj + dx - (2*v + 3)). The conv pads the cell grid by one
    above and to the left, so tap bi = 0 reads cell i - 1: output pixel
    2*i + u reads input row 4*i + 2*u - 1 + ky, which is row dy of cell
    i - 1 + bi. (The JAX tool's ``probe_stem.py:114-127`` offsets by
    2*u + 1 and misses that pad.)"""
    c = k.shape[-1]
    kq = np.zeros((2, 2, 48, 4 * c), np.float32)
    for u in range(2):
        for v in range(2):
            for bi in range(2):
                for bj in range(2):
                    for dy in range(4):
                        for dx in range(4):
                            ky = 4 * bi + dy - (2 * u + 3)
                            kx = 4 * bj + dx - (2 * v + 3)
                            if 0 <= ky < 3 and 0 <= kx < 3:
                                ci = dy * 12 + dx * 3
                                kq[bi, bj, ci:ci + 3, (u * 2 + v) * c:(u * 2 + v + 1) * c] = \
                                    k[ky, kx]
    return kq


def nchw(x: np.ndarray, device) -> torch.Tensor:
    """NHWC numpy -> the channels_last NCHW tensor over the same layout."""
    return torch.from_numpy(x).to(device).permute(0, 3, 1, 2)


def oihw(k: np.ndarray, device) -> torch.Tensor:
    """HWIO numpy -> OIHW weights in channels_last."""
    return torch.from_numpy(k).to(device).permute(3, 2, 0, 1).contiguous(
        memory_format=torch.channels_last)


def stem_a(x: torch.Tensor, k: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return F.conv2d(x.to(dtype), k.to(dtype), stride=2, padding=1)


def stem_b(xs: torch.Tensor, k4: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return F.conv2d(F.pad(xs.to(dtype), (1, 0, 1, 0)), k4.to(dtype))


def device_s2d(x: torch.Tensor) -> torch.Tensor:
    """(B, 3, S, S) channels_last -> (B, 12, S/2, S/2) channels_last, channel
    order (dy, dx, c)."""
    b, c, s, _ = x.shape
    y = x.permute(0, 2, 3, 1).reshape(b, s // 2, 2, s // 2, 2, c).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, s // 2, s // 2, 4 * c).permute(0, 3, 1, 2)


def stem_c(x: torch.Tensor, k4: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return stem_b(device_s2d(x), k4, dtype)


def stem_d(xq: torch.Tensor, kq: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    b, _, s4, _ = xq.shape
    y = F.conv2d(F.pad(xq.to(dtype), (1, 0, 1, 0)), kq.to(dtype))    # (B, 4C, S/4, S/4)
    y = y.permute(0, 2, 3, 1).reshape(b, s4, s4, 2, 2, COUT).permute(0, 1, 3, 2, 4, 5)
    return y.reshape(b, 2 * s4, 2 * s4, COUT).permute(0, 3, 1, 2)


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=352)
    ap.add_argument("--iters", type=int, default=32)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = tool_device(args.device)

    rng = np.random.default_rng(0)
    b, s = args.batch, args.size
    x = rng.normal(0, 1, (b, s, s, 3)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 3, COUT)).astype(np.float32)
    xd, kd = nchw(x, device), oihw(k, device)
    xsd, k4d = nchw(space_to_depth(x, 2), device), oihw(fold_s2d(k), device)
    xqd, kqd = nchw(space_to_depth(x, 4), device), oihw(fold_s2d4(k), device)

    a = stem_a(xd, kd).float()
    result = {"device": device_name(device), "batch": b, "size": s,
              "a_max_abs": float(a.abs().max()),
              "b_max_abs_diff": float((a - stem_b(xsd, k4d).float()).abs().max()),
              "c_max_abs_diff": float((a - stem_c(xd, k4d).float()).abs().max()),
              "d_max_abs_diff": float((a - stem_d(xqd, kqd).float()).abs().max())}
    print(f"b exact: {result['b_max_abs_diff']}  c exact: {result['c_max_abs_diff']}  "
          f"d exact: {result['d_max_abs_diff']}", flush=True)

    cases = {"a_ms": (stem_a, xd, kd), "b_ms": (stem_b, xsd, k4d), "c_ms": (stem_c, xd, k4d),
             "d_ms": (stem_d, xqd, kqd),
             "a_bf16_input_ms": (stem_a, xd.bfloat16(), kd),
             "b_bf16_input_ms": (stem_b, xsd.bfloat16(), k4d),
             "d_bf16_input_ms": (stem_d, xqd.bfloat16(), kqd)}
    for name, (fn, xin, w) in cases.items():
        result[name] = device_ms(lambda: fn(xin, w), device=device, iters=args.iters)
        print(f"{name:>18}: {result[name]:8.4f} ms", flush=True)
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
