"""The staged stem roofline probe: a CUDA kernel and its plain twin.

``stem_probe`` replaces the Pallas kernel of
``tools/probe_stem_pallas.py:126`` (``main.build``; bodies ``_kernel_a``,
``_kernel_b``, ``_kernel_c``) with the kernel in ``csrc/stem_probe.cu``. It
keeps the probe's public layout: x (B, S, S*3) float32, the NHWC image with
each row's pixels flattened, S even, and out (B, S/2, S/2*32) bf16. The
three stages, with h = S/2:

* ``"a"``: ``out[b, i, :] = rowsum(x[b, i]) + rowsum(x[b, i + h])``: the
  stem's bytes streamed, row i paired with row i + h;
* ``"b"``: ``acc = x[b, 2i] + x[b, 2i+1] + x[b, 2i-1]`` with row S-1 in
  place of row -1 (``pltpu.roll(p1, 1, 0)`` wraps: its row i is p1's row
  i-1, checked against the Pallas body in interpret mode), then
  ``out[b, i, :] = sum over lanes l of acc[l] + acc[l-3] + acc[l+3]``, the
  lanes taken modulo 3S: the stem's stencil access without its arithmetic;
* ``"c"``: ``relu6(conv3x3/s2 (x as NHWC, w) + bias)`` with zero padding 1,
  summed in float32, w (9, 3, 32) taps (ky*3+kx, cin, cout) and bias (32,).

Stages a and b broadcast their value over the output row. Every stage
rounds to bf16 once. ``stem_probe_reference`` is the plain twin (for c, a
rounded float32 product and sum a tap, in (ky, kx, cin) order): the CPU
path, and the oracle the kernel is held against on the card; never a
fallback for a CUDA tensor. The kernel sums in other orders (stage c: three
TF32 passes on the tensor cores, float32-accurate), so the two agree within
``tools/probe_stem_cuda.py:tolerance``, not bit for bit.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.kernels import _build

STAGES = ("a", "b", "c")
COUT = 32          # csrc/stem_probe.cu:kCout
MAX_SIZE = 1024    # csrc/stem_probe.cu: a ring of at least three rows of 3S floats fits


def _broadcast(v: torch.Tensor, h: int) -> torch.Tensor:
    """(B, h) row values -> (B, h, h*32) bf16."""
    return v.to(torch.bfloat16)[..., None].expand(*v.shape, h * COUT).contiguous()


def stem_probe_reference(x: torch.Tensor, stage: str, w: torch.Tensor | None = None,
                         b: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of ``stem_probe``, same contract, float32 sums."""
    _check(x, stage, w, b)
    bsz, s = x.shape[0], x.shape[1]
    h = s // 2
    if stage == "a":
        rowsum = x.sum(2)
        return _broadcast(rowsum[:, :h] + rowsum[:, h:], h)
    xr = x.reshape(bsz, h, 2, 3 * s)
    p0, p1 = xr[:, :, 0], xr[:, :, 1]
    if stage == "b":
        acc = p0 + p1 + torch.roll(p1, 1, dims=1)
        acc = acc + torch.roll(acc, 3, dims=2) + torch.roll(acc, -3, dims=2)
        return _broadcast(acc.sum(2), h)
    # a rounded product and a rounded sum per tap, in the kernel's order
    img = torch.nn.functional.pad(x.reshape(bsz, s, s, 3), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros((bsz, h, h, COUT), dtype=torch.float32, device=x.device)
    for ky in range(3):
        for kx in range(3):
            taps = img[:, ky:ky + 2 * h:2, kx:kx + 2 * h:2]          # (B, h, h, 3)
            for ci in range(3):
                acc = acc + taps[..., ci:ci + 1] * w[ky * 3 + kx, ci]
    out = torch.clamp(acc + b, 0.0, 6.0)
    return out.reshape(bsz, h, h * COUT).to(torch.bfloat16)


def _check(x: torch.Tensor, stage: str, w, b) -> None:
    if stage not in STAGES:
        raise ValueError(f"stage must be one of {STAGES}, got {stage!r}")
    if x.dtype != torch.float32:
        raise TypeError(f"stem_probe takes float32 x, not {x.dtype}")
    if x.dim() != 3 or x.shape[2] != 3 * x.shape[1] or x.shape[1] % 2:
        raise ValueError(f"x must be (B, S, S*3) with S even, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError("x must be contiguous")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"stem_probe runs on CPU or CUDA tensors, not {x.device}")
    if stage != "c":
        return
    for name, t, shape in (("w", w, (9, 3, COUT)), ("b", b, (COUT,))):
        if t is None:
            raise ValueError(f"stage c needs {name} {shape}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be float32 {shape}, got {t.dtype} {tuple(t.shape)}")
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device} but x on {x.device}")


def stem_probe(x: torch.Tensor, stage: str, w: torch.Tensor | None = None,
               b: torch.Tensor | None = None) -> torch.Tensor:
    """One stage of the stem probe: x (B, S, S*3) float32 -> (B, S/2, S/2*32) bf16.

    ``w`` (9, 3, 32) and ``b`` (32,) float32 are stage c's weights and bias.
    A CUDA tensor launches ``csrc/stem_probe.cu`` on the current stream,
    without synchronising, and adds one to ``stem_probe.launches``; a CPU
    tensor runs ``stem_probe_reference``. Any other input raises.
    """
    _check(x, stage, w, b)
    if x.device.type == "cpu":
        return stem_probe_reference(x, stage, w, b)
    bsz, s = x.shape[0], x.shape[1]
    if s > MAX_SIZE:
        raise ValueError(f"stem_probe stages rows of at most S={MAX_SIZE}, got {s}")
    if stage == "c":
        w, b = w.contiguous(), b.contiguous()
    out = torch.empty((bsz, s // 2, s // 2 * COUT), dtype=torch.bfloat16, device=x.device)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.myt_stem_probe(x.data_ptr(), None if w is None else w.data_ptr(),
                                 None if b is None else b.data_ptr(), out.data_ptr(), bsz, s,
                                 STAGES.index(stage), stream)
    if err != 0:
        raise RuntimeError(f"stem_probe kernel launch failed: CUDA error {err}")
    stem_probe.launches += 1
    return out


def probe_work(stage: str, batch: int, size: int) -> tuple[int, int]:
    """(operations, bytes) one call needs: each input read once and the
    output written once; a counts an add per input value, b five per lane of
    each output row, c two per tap and channel of each output pixel."""
    h = size // 2
    nbytes = 4 * batch * size * size * 3 + 2 * batch * h * h * COUT
    if stage == "c":
        return 2 * batch * h * h * 27 * COUT, nbytes + 4 * (27 * COUT + COUT)
    if stage == "b":
        return 5 * batch * h * 3 * size, nbytes
    return batch * size * 3 * size, nbytes


stem_probe.launches = 0
