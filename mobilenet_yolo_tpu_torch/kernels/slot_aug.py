"""Per-slot noise and photometric program: a CUDA kernel and its plain twin.

``slot_aug`` replaces ``mobilenet_yolo_tpu/kernels/pallas_aug.py:172``
(``fused_slot_aug``) with the kernel in ``csrc/slot_aug.cu``: gated
additive gaussian noise (Box-Muller, per channel or one shared plane),
then the 5-step host-planned program, for (N, S, S, 3) uint8 slots in the
loader's layout, out channel-planar (N, 3, S, S).

The TPU kernel drew its gaussians from the TPU's own PRNG. Here they come
from a counter-based generator (``csrc/aug_common.cuh``) that
``ops/device_augment.py:noise_bits`` reproduces with torch integer ops, so
the kernel, ``slot_aug_reference`` and the plain ``slot_noise`` draw the
same noise. Either side also takes ``debug_bits`` (2, N, 3, S/2, S)
uint32, the JAX seam (``pallas_aug.py:186-190``), in place of the
generator.

``slot_aug_reference`` is the plain-torch twin: the CPU path, and the
oracle the kernel is held against on the card; never a fallback for a
CUDA tensor.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.kernels import _build
from mobilenet_yolo_tpu_torch.ops.device_augment import noised_planar, planned_color_jitter

STEPS = 5          # program length, csrc/aug_common.cuh:kSteps
STATS = 8          # per-slot scratch floats, csrc/aug_common.cuh:kStats
STATS_PIXELS = 2048  # pixels of a slot one pre-pass item reduces, kStatsPixels


def stats_scratch(n_slots: int, size: int, device) -> tuple[torch.Tensor, ...]:
    """The pre-pass's scratch: (N, STATS) float32 per-slot statistics,
    (N, STEPS + 1, chunks, 4) float64 partial sums of its items, one chunk
    per STATS_PIXELS pixels of a slot (aug_common.cuh:stats_chunks), and
    (STEPS + 1, N + 1) int32 for its plan's work lists."""
    chunks = -(-size * size // STATS_PIXELS)
    return (torch.empty((n_slots, STATS), dtype=torch.float32, device=device),
            torch.empty((n_slots, STEPS + 1, chunks, 4), dtype=torch.float64, device=device),
            torch.empty((STEPS + 1, n_slots + 1), dtype=torch.int32, device=device))


def slot_aug_reference(slots: torch.Tensor, seed: int, noise_gate: torch.Tensor,
                       noise_scale: torch.Tensor, noise_per_channel: torch.Tensor,
                       op_ids: torch.Tensor, factors: torch.Tensor,
                       dtype: torch.dtype = torch.float32,
                       debug_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Plain twin of the kernel: noise, then the program in f32, then one
    rounding to ``dtype``. (N, S, S, 3) uint8 -> (N, 3, S, S)."""
    x = noised_planar(slots, seed, noise_gate.bool(), noise_scale, noise_per_channel.bool(),
                      debug_bits)
    x = planned_color_jitter(x.permute(0, 2, 3, 1), op_ids, factors)
    return x.permute(0, 3, 1, 2).to(dtype).contiguous()


def _check(slots, seed, noise_gate, noise_scale, noise_per_channel, op_ids, factors,
           debug_bits, n_slots: int | None = None) -> None:
    if not -2**31 <= int(seed) < 2**31:
        raise ValueError(f"seed must fit in int32, got {seed}")
    if slots.dtype != torch.uint8:
        raise TypeError(f"slots must be uint8, got {slots.dtype}")
    s_h, s_w, c = slots.shape[-3:]
    if c != 3 or s_h != s_w or s_h % 2:
        raise ValueError(f"slots must be (..., S, S, 3) with S even, got {tuple(slots.shape)}")
    n = n_slots if n_slots is not None else slots.shape[0]
    lead = slots.shape[:-3]
    for name, t, shape in (("noise_gate", noise_gate, lead), ("noise_scale", noise_scale, lead),
                           ("noise_per_channel", noise_per_channel, lead),
                           ("op_ids", op_ids, lead + (STEPS,)),
                           ("factors", factors, lead + (STEPS,))):
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name} must be {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != slots.device:
            raise ValueError(f"{name} on {t.device} but slots on {slots.device}")
    if debug_bits is not None:
        want = (2, n, 3, s_h // 2, s_w)
        if tuple(debug_bits.shape) != want:
            raise ValueError(f"debug_bits must be {want}, got {tuple(debug_bits.shape)}")
        if debug_bits.device != slots.device:
            raise ValueError(f"debug_bits on {debug_bits.device} but slots on {slots.device}")
    if slots.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the aug kernels run on CPU or CUDA tensors, not {slots.device}")


def plan_args(noise_gate, noise_scale, noise_per_channel, op_ids, factors, debug_bits):
    """The per-slot plans as the kernels read them: contiguous int32 and
    f32, and the bits as int32 (the kernel reads them as uint32)."""
    i32, f32 = torch.int32, torch.float32
    return (noise_gate.to(i32).contiguous(), noise_scale.to(f32).contiguous(),
            noise_per_channel.to(i32).contiguous(), op_ids.to(i32).contiguous(),
            factors.to(f32).contiguous(),
            None if debug_bits is None else debug_bits.view(i32).contiguous())


def slot_aug(slots: torch.Tensor, seed: int, noise_gate: torch.Tensor,
             noise_scale: torch.Tensor, noise_per_channel: torch.Tensor,
             op_ids: torch.Tensor, factors: torch.Tensor, dtype: torch.dtype = torch.bfloat16,
             debug_bits: torch.Tensor | None = None) -> torch.Tensor:
    """Noise + photometric program per staged slot.

    slots (N, S, S, 3) uint8, S even; noise_gate / noise_per_channel (N,)
    bool; noise_scale (N,) float in [0, 255] units; op_ids (N, 5) int and
    factors (N, 5) float host-planned programs; seed an int (int32 range).
    Returns (N, 3, S, S) ``dtype`` (bf16 or f32) in [0, 255].

    A CUDA tensor launches the kernel on the current stream, without
    synchronising, and adds one to ``slot_aug.launches``; a CPU tensor runs
    ``slot_aug_reference``. Any other input raises.
    """
    _check(slots, seed, noise_gate, noise_scale, noise_per_channel, op_ids, factors,
           debug_bits)
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"slot_aug emits float32 or bfloat16, not {dtype}")
    if slots.device.type == "cpu":
        return slot_aug_reference(slots, seed, noise_gate, noise_scale, noise_per_channel,
                                  op_ids, factors, dtype, debug_bits)
    lib = _build.load()
    n, s = slots.shape[0], slots.shape[1]
    slots = slots.contiguous()
    gate, scale, pc, ops, facs, bits = plan_args(noise_gate, noise_scale, noise_per_channel,
                                                 op_ids, factors, debug_bits)
    stats, partial, work = stats_scratch(n, s, slots.device)
    out = torch.empty((n, 3, s, s), dtype=dtype, device=slots.device)
    # four columns a thread where each row's pixels start on a 32-bit word
    vec = s % 4 == 0 and slots.data_ptr() % 4 == 0
    with torch.cuda.device(slots.device):
        stream = torch.cuda.current_stream(slots.device).cuda_stream
        err = lib.myt_slot_aug(slots.data_ptr(), n, s, int(seed), gate.data_ptr(),
                               scale.data_ptr(), pc.data_ptr(), ops.data_ptr(), facs.data_ptr(),
                               None if bits is None else bits.data_ptr(), stats.data_ptr(),
                               partial.data_ptr(), work.data_ptr(), out.data_ptr(),
                               int(dtype == torch.bfloat16), int(vec), stream)
    if err != 0:
        raise RuntimeError(f"slot_aug kernel launch failed: CUDA error {err}")
    slot_aug.launches += 1
    return out


slot_aug.launches = 0
