"""Fused MobileNetV2 blocks with BatchNorm folded: CUDA kernels and twins.

Ports of the public functions of ``mobilenet_yolo_tpu/kernels/pallas_fused.py``,
in the JAX package's layout: NHWC activations (a contiguous NHWC tensor is
the port's ``channels_last`` NCHW tensor, so the model needs no copy),
``w1 (Cin, Ch)``, ``wdw (3, 3, Ch)``, ``w2 (Ch, Cout)``, ``k_stem (3, 3,
3, Ch)`` and biases ``(C,)``.

* ``fused_inverted_residual`` replaces ``pallas_fused.py:101`` (stride 1,
  optional residual) and ``fused_inverted_residual_s2`` replaces
  ``pallas_fused.py:193`` (stride 2, H and W even), both with the kernel in
  ``csrc/fused_block.cu``;
* ``fused_stem_block0`` replaces ``pallas_fused.py:355`` (3x3/s2 stem with
  pad 1, then block 0's depthwise and project) with ``csrc/fused_stem.cu``.

``inverted_residual_reference`` and ``stem_block0_reference`` are the plain
twins, counterparts of ``xla_inverted_residual`` (``:243``) and
``xla_stem_block0`` (``:402``) as three ``F.conv2d`` calls in
``channels_last``. They serve CPU tensors and are the kernels' oracle on the
card; never a fallback for a CUDA tensor. In float32 they agree with the
kernels up to summation order. In bf16 they round the hidden tensor and
each conv's output to bf16, as ``xla_inverted_residual`` rounds to
``x.dtype``, while the kernels keep everything in float32 inside and round
the output once.

Biases may be float32 or the activations' type; the kernels read them as
float32.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from mobilenet_yolo_tpu_torch.kernels import _build

CHUNK = 32          # hidden channels per pass, csrc/fused_common.cuh:kChunk
TILE_PIX = 64       # output pixels per thread block, kTilePix
MAX_COUT = 320      # output channels one block holds, kMaxCout
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)


# ------------------------------------------------------------------ twins --

def _dw_project(h: torch.Tensor, wdw, bdw, w2, b2, stride: int) -> torch.Tensor:
    """Depthwise 3x3 (pad 1) + bias, ReLU6, 1x1 project + bias on NCHW ``h``."""
    dt = h.dtype
    d = F.conv2d(h, wdw.to(dt).permute(2, 0, 1)[:, None], bdw.to(dt), stride=stride,
                 padding=1, groups=h.shape[1]).clamp(0.0, 6.0)
    return F.conv2d(d, w2.to(dt).t()[:, :, None, None], b2.to(dt))


def inverted_residual_reference(x: torch.Tensor, w1, b1, wdw, bdw, w2, b2,
                                residual: bool = True, stride: int = 1) -> torch.Tensor:
    """Plain twin: (B, H, W, Cin) -> (B, H/stride, W/stride, Cout)."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, w1.to(x.dtype).t()[:, :, None, None], b1.to(x.dtype)).clamp(0.0, 6.0)
    o = _dw_project(h, wdw, bdw, w2, b2, stride)
    if residual:
        o = o + xc
    return o.permute(0, 2, 3, 1).contiguous()


def stem_block0_reference(x: torch.Tensor, k_stem, b_stem, wdw, bdw, w2, b2) -> torch.Tensor:
    """Plain twin: stem 3x3/s2 (pad 1) + ReLU6, then block 0 (no expand, no
    residual). ``xla_stem_block0`` runs block 0 as an inverted residual with
    an identity expand; on the stem's ReLU6 output that expand and its
    clip change nothing, so it is left out."""
    xc = x.permute(0, 3, 1, 2)
    h = F.conv2d(xc, k_stem.to(x.dtype).permute(3, 2, 0, 1), b_stem.to(x.dtype), stride=2,
                 padding=1).clamp(0.0, 6.0)
    return _dw_project(h, wdw, bdw, w2, b2, 1).permute(0, 2, 3, 1).contiguous()


# ----------------------------------------------------------------- tiling --

def _round4(v: int) -> int:
    return (v + 3) // 4 * 4


def _chunk_floats(wpp: int, cout: int) -> int:
    return CHUNK * (wpp + TILE_PIX + _round4(cout) + 11)


def _block_smem_bytes(stride: int, th: int, tw: int, cin: int, cout: int) -> int:
    """csrc/fused_block.cu:block_smem_floats, in bytes."""
    wpp = _round4((stride * (th - 1) + 3) * (stride * (tw - 1) + 3))
    return 4 * (cin * wpp + cin * CHUNK + _chunk_floats(wpp, cout))


def _stem_smem_bytes(th: int, tw: int, cout: int) -> int:
    """csrc/fused_stem.cu:stem_smem_floats, in bytes."""
    wpp = _round4((th + 2) * (tw + 2))
    return 4 * (_round4(3 * (2 * th + 5) * (2 * tw + 5)) + 27 * CHUNK + _chunk_floats(wpp, cout))


@functools.lru_cache(maxsize=1024)
def pick_tile(kind: str, ho: int, wo: int, cin: int, cout: int) -> tuple[int, int]:
    """The output tile (th, tw), th * tw <= TILE_PIX, for ``kind`` "s1", "s2"
    or "stem", that minimises the modelled work per hidden channel (the
    expand over the window, recomputed on the halo, plus the depthwise and
    project over all TILE_PIX slots) within the shared memory a block has."""
    stride = 2 if kind == "s2" else 1
    depth = 27 if kind == "stem" else cin
    best = None
    for th in range(1, min(ho, TILE_PIX) + 1):
        for tw in range(1, min(wo, TILE_PIX // th) + 1):
            smem = (_stem_smem_bytes(th, tw, cout) if kind == "stem"
                    else _block_smem_bytes(stride, th, tw, cin, cout))
            if smem > SMEM_LIMIT:
                continue
            window = _round4((stride * (th - 1) + 3) * (stride * (tw - 1) + 3))
            tiles = -(-ho // th) * -(-wo // tw)
            key = (tiles * (window * depth + TILE_PIX * (cout + 9)), -th * tw)
            if best is None or key < best[0]:
                best = (key, (th, tw))
    if best is None:
        raise ValueError(f"no {kind} tile of {ho}x{wo}, Cin={cin}, Cout={cout} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return best[1]


# ------------------------------------------------------------------ checks --

def _check(name: str, x: torch.Tensor, weights: dict, biases: dict, even: bool) -> None:
    if x.dtype not in _DTYPES:
        raise TypeError(f"{name} takes float32 or bfloat16 activations, not {x.dtype}")
    if x.dim() != 4:
        raise ValueError(f"{name} takes x (B, H, W, C), got {tuple(x.shape)}")
    for key, t in weights.items():
        if t.dtype != x.dtype:
            raise TypeError(f"{name}: {key} is {t.dtype} but x is {x.dtype}")
    for key, t in biases.items():
        if t.dtype not in (torch.float32, x.dtype):
            raise TypeError(f"{name}: {key} is {t.dtype}; biases are float32 or x's type")
    for key, t in {**weights, **biases}.items():
        if t.device != x.device:
            raise ValueError(f"{name}: {key} on {t.device} but x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
    if not x.is_contiguous():
        raise ValueError(f"{name}: x must be contiguous NHWC")
    if even and (x.shape[1] % 2 or x.shape[2] % 2):
        raise ValueError(f"{name} takes even H and W, got {tuple(x.shape[1:3])}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on CPU or CUDA tensors, not {x.device}")


def _check_block(name, x, w1, b1, wdw, bdw, w2, b2, even: bool) -> None:
    _check(name, x, {"w1": w1, "wdw": wdw, "w2": w2}, {"b1": b1, "bdw": bdw, "b2": b2}, even)
    cin, ch, cout = x.shape[3], w1.shape[1], w2.shape[1]
    shapes = {"w1": (w1, (cin, ch)), "b1": (b1, (ch,)), "wdw": (wdw, (3, 3, ch)),
              "bdw": (bdw, (ch,)), "w2": (w2, (ch, cout)), "b2": (b2, (cout,))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be {want}, got {tuple(t.shape)}")
    if cout > MAX_COUT:
        raise ValueError(f"{name} holds at most {MAX_COUT} output channels, got {cout}")


def _f32(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32).contiguous()


def _launch_block(x, w1, b1, wdw, bdw, w2, b2, residual: bool, stride: int) -> torch.Tensor:
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    ho, wo = h // stride, w // stride
    th, tw = pick_tile(f"s{stride}", ho, wo, cin, cout)
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    b1, bdw, b2 = _f32(b1), _f32(bdw), _f32(b2)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.myt_fused_block(x.data_ptr(), w1.data_ptr(), b1.data_ptr(), wdw.data_ptr(),
                                  bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(), out.data_ptr(),
                                  b, h, w, cin, ch, cout, stride, int(residual), th, tw,
                                  int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_block kernel launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------- wrappers --

def fused_inverted_residual(x: torch.Tensor, w1, b1, wdw, bdw, w2, b2,
                            residual: bool = True) -> torch.Tensor:
    """Stride-1 inverted residual, BN folded: x (B, H, W, Cin) -> (B, H, W, Cout).

    A CUDA tensor launches ``csrc/fused_block.cu`` on the current stream,
    without synchronising, and adds one to ``fused_inverted_residual.launches``;
    a CPU tensor runs ``inverted_residual_reference``. Any other input raises.
    """
    _check_block("fused_inverted_residual", x, w1, b1, wdw, bdw, w2, b2, even=False)
    if residual and w2.shape[1] != x.shape[3]:
        raise ValueError(f"a residual needs Cout == Cin, got {w2.shape[1]} and {x.shape[3]}")
    if x.device.type == "cpu":
        return inverted_residual_reference(x, w1, b1, wdw, bdw, w2, b2, residual, 1)
    out = _launch_block(x, w1, b1, wdw, bdw, w2, b2, residual, 1)
    fused_inverted_residual.launches += 1
    return out


def fused_inverted_residual_s2(x: torch.Tensor, w1, b1, wdw, bdw, w2, b2) -> torch.Tensor:
    """Stride-2 inverted residual, BN folded, no residual: x (B, H, W, Cin),
    H and W even -> (B, H/2, W/2, Cout). Dispatch as
    ``fused_inverted_residual``; counts in ``fused_inverted_residual_s2.launches``."""
    _check_block("fused_inverted_residual_s2", x, w1, b1, wdw, bdw, w2, b2, even=True)
    if x.device.type == "cpu":
        return inverted_residual_reference(x, w1, b1, wdw, bdw, w2, b2, False, 2)
    out = _launch_block(x, w1, b1, wdw, bdw, w2, b2, False, 2)
    fused_inverted_residual_s2.launches += 1
    return out


def fused_stem_block0(x: torch.Tensor, k_stem, b_stem, wdw, bdw, w2, b2) -> torch.Tensor:
    """Stem 3x3/s2 (pad 1) + ReLU6, block 0's depthwise + ReLU6 and project,
    BN folded: x (B, H, W, 3), H and W even -> (B, H/2, W/2, Cout).

    A CUDA tensor launches ``csrc/fused_stem.cu`` and adds one to
    ``fused_stem_block0.launches``; a CPU tensor runs
    ``stem_block0_reference``. Any other input raises.
    """
    name = "fused_stem_block0"
    _check(name, x, {"k_stem": k_stem, "wdw": wdw, "w2": w2},
           {"b_stem": b_stem, "bdw": bdw, "b2": b2}, even=True)
    ch, cout = k_stem.shape[-1], w2.shape[-1]
    shapes = {"x": (x, (*x.shape[:3], 3)), "k_stem": (k_stem, (3, 3, 3, ch)),
              "b_stem": (b_stem, (ch,)), "wdw": (wdw, (3, 3, ch)), "bdw": (bdw, (ch,)),
              "w2": (w2, (ch, cout)), "b2": (b2, (cout,))}
    for key, (t, want) in shapes.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{name}: {key} must be {want}, got {tuple(t.shape)}")
    if cout > MAX_COUT:
        raise ValueError(f"{name} holds at most {MAX_COUT} output channels, got {cout}")
    if x.device.type == "cpu":
        return stem_block0_reference(x, k_stem, b_stem, wdw, bdw, w2, b2)
    b, h, w, _ = x.shape
    th, tw = pick_tile("stem", h // 2, w // 2, 3, cout)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=x.dtype, device=x.device)
    b_stem, bdw, b2 = _f32(b_stem), _f32(bdw), _f32(b2)
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.myt_fused_stem(x.data_ptr(), k_stem.data_ptr(), b_stem.data_ptr(),
                                 wdw.data_ptr(), bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                 out.data_ptr(), b, h, w, ch, cout, th, tw,
                                 int(x.dtype == torch.bfloat16), stream)
    if err != 0:
        raise RuntimeError(f"fused_stem kernel launch failed: CUDA error {err}")
    fused_stem_block0.launches += 1
    return out


fused_inverted_residual.launches = 0
fused_inverted_residual_s2.launches = 0
fused_stem_block0.launches = 0
