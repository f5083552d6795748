"""Noise, photometric program and geometric compose: a CUDA kernel and its
plain twin.

``aug_compose`` replaces ``mobilenet_yolo_tpu/kernels/pallas_aug.py:354``
(``fused_aug_compose_kernel``) with the kernels in ``csrc/aug_compose.cu``:
per active tile, the slot kernel's noise and program, then the tile's
fill (constant or source-window mean) and its bilinear paste of the
source rect into the destination rect (flip folded in, edge-clamped), in
tile order, into (B, H, W, 3) bf16 images. The noise is the slot kernel's
counter-based stream with slot index ``b * T + t``, so a full and a split
step on one seed draw the same gaussians.

``aug_compose_reference`` is the plain-torch twin: ``slot_aug_reference``
in f32, the plain planar compose in f32, then one rounding to bf16. It
serves CPU tensors and is the kernel's oracle on the card; never a
fallback for a CUDA tensor.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.kernels import _build
from mobilenet_yolo_tpu_torch.kernels.slot_aug import (_check, plan_args, slot_aug_reference,
                                                       stats_scratch)
from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose


def aug_compose_reference(slots, seed, noise_gate, noise_scale, noise_per_channel, op_ids,
                          factors, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean,
                          flip, active, out_hw, debug_bits=None) -> torch.Tensor:
    """Plain twin of the kernel, same arguments and result."""
    b, t, s = slots.shape[0], slots.shape[1], slots.shape[2]
    n = b * t
    planar = slot_aug_reference(slots.reshape(n, s, s, 3), seed, noise_gate.reshape(n),
                                noise_scale.reshape(n), noise_per_channel.reshape(n),
                                op_ids.reshape(n, -1), factors.reshape(n, -1),
                                debug_bits=debug_bits)
    out = geometric_compose(planar.reshape(b, t, 3, s, s), src_rect, dst_rect, fill_rect,
                            fill_color, fill_from_mean.bool(), flip.bool(), active.bool(),
                            out_hw, planar=True)
    return out.to(torch.bfloat16)


def aug_compose(slots: torch.Tensor, seed: int, noise_gate: torch.Tensor,
                noise_scale: torch.Tensor, noise_per_channel: torch.Tensor,
                op_ids: torch.Tensor, factors: torch.Tensor, src_rect: torch.Tensor,
                dst_rect: torch.Tensor, fill_rect: torch.Tensor, fill_color: torch.Tensor,
                fill_from_mean: torch.Tensor, flip: torch.Tensor, active: torch.Tensor,
                out_hw, debug_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Device augmentation of a geometry batch into training images.

    slots (B, T, S, S, 3) uint8, S even; per tile: noise_gate,
    noise_per_channel, fill_from_mean, flip, active (B, T) bool;
    noise_scale (B, T) float; op_ids (B, T, 5) int and factors (B, T, 5)
    float programs; src_rect, dst_rect, fill_rect (B, T, 4) normalized
    [x1, y1, x2, y2]; fill_color (B, T, 3) raw [0, 255]; ``out_hw`` (H, W);
    ``debug_bits`` (2, B*T, 3, S/2, S) uint32 in place of the generator.
    Returns (B, H, W, 3) bf16 in [0, 255].

    A CUDA tensor launches the kernels on the current stream, without
    synchronising, and adds one to ``aug_compose.launches``; a CPU tensor
    runs ``aug_compose_reference``. Any other input raises.
    """
    b, t = slots.shape[0], slots.shape[1]
    _check(slots, seed, noise_gate, noise_scale, noise_per_channel, op_ids, factors,
           debug_bits, n_slots=b * t)
    for name, x, last in (("src_rect", src_rect, 4), ("dst_rect", dst_rect, 4),
                          ("fill_rect", fill_rect, 4), ("fill_color", fill_color, 3),
                          ("fill_from_mean", fill_from_mean, None), ("flip", flip, None),
                          ("active", active, None)):
        want = (b, t) if last is None else (b, t, last)
        if tuple(x.shape) != want:
            raise ValueError(f"{name} must be {want}, got {tuple(x.shape)}")
        if x.device != slots.device:
            raise ValueError(f"{name} on {x.device} but slots on {slots.device}")
    out_h, out_w = int(out_hw[0]), int(out_hw[1])
    if out_h < 1 or out_w < 1:
        raise ValueError(f"out_hw must be positive, got {out_hw}")
    args = (slots, seed, noise_gate, noise_scale, noise_per_channel, op_ids, factors,
            src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip, active,
            (out_h, out_w), debug_bits)
    if slots.device.type == "cpu":
        return aug_compose_reference(*args)
    lib = _build.load()
    s = slots.shape[2]
    slots = slots.contiguous()
    gate, scale, pc, ops, facs, bits = plan_args(noise_gate, noise_scale, noise_per_channel,
                                                 op_ids, factors, debug_bits)
    f32, i32 = torch.float32, torch.int32
    src, dst, fill, color = (x.to(f32).contiguous()
                             for x in (src_rect, dst_rect, fill_rect, fill_color))
    ffm, flp, act = (x.to(i32).contiguous() for x in (fill_from_mean, flip, active))
    stats, partial, work = stats_scratch(b * t, s, slots.device)
    out = torch.empty((b, out_h, out_w, 3), dtype=torch.bfloat16, device=slots.device)
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream(slots.device).cuda_stream
        err = lib.myt_aug_compose(
            slots.data_ptr(), b, t, s, int(seed), gate.data_ptr(), scale.data_ptr(),
            pc.data_ptr(), ops.data_ptr(), facs.data_ptr(),
            None if bits is None else bits.data_ptr(), src.data_ptr(), dst.data_ptr(),
            fill.data_ptr(), color.data_ptr(), ffm.data_ptr(), flp.data_ptr(), act.data_ptr(),
            stats.data_ptr(), partial.data_ptr(), work.data_ptr(), out_h, out_w, out.data_ptr(),
            stream)
    if err != 0:
        raise RuntimeError(f"aug_compose kernel launch failed: CUDA error {err}")
    aug_compose.launches += 1
    return out


aug_compose.launches = 0
