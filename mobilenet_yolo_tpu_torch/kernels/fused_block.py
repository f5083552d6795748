"""Fused MobileNetV2 blocks with BatchNorm folded: CUDA kernels and twins.

Ports of the public functions of ``mobilenet_yolo_tpu/kernels/pallas_fused.py``,
in the JAX package's layout: NHWC activations (a contiguous NHWC tensor is
the port's ``channels_last`` NCHW tensor, so the model needs no copy),
``w1 (Cin, Ch)``, ``wdw (3, 3, Ch)``, ``w2 (Ch, Cout)``, ``k_stem (3, 3,
3, Ch)`` and biases ``(C,)``.

* ``fused_inverted_residual`` replaces ``pallas_fused.py:101`` (stride 1,
  optional residual) and ``fused_inverted_residual_s2`` replaces
  ``pallas_fused.py:193`` (stride 2, H and W even): float32 tensors run the
  kernel in ``csrc/fused_block.cu`` (float32 FMAs), bf16 tensors the one in
  ``csrc/fused_block_bf16.cu`` (both 1x1 products on the tensor cores), each
  with its own tile plan (``pick_tile`` kinds "s1"/"s2" and
  "s1_bf16"/"s2_bf16");
* ``fused_stem_block0`` replaces ``pallas_fused.py:355`` (3x3/s2 stem with
  pad 1, then block 0's depthwise and project) with ``csrc/fused_stem.cu``.

``inverted_residual_reference`` and ``stem_block0_reference`` are the plain
twins, counterparts of ``xla_inverted_residual`` (``:243``) and
``xla_stem_block0`` (``:402``) as three ``F.conv2d`` calls in
``channels_last``. They serve CPU tensors and are the kernels' oracle on the
card; never a fallback for a CUDA tensor. In float32 they agree with the
kernels up to summation order. In bf16 they round the hidden tensor and
each conv's output to bf16, as ``xla_inverted_residual`` rounds to
``x.dtype``. The bf16 block kernel rounds where the Pallas kernel does:
float32 hidden tensor and depthwise, the depthwise output rounded to bf16
for the project, one rounding of the output (``BF16_REL_TOL``). The stem
kernel keeps everything in float32 inside and rounds its output once.

Biases may be float32 or the activations' type; the kernels read them as
float32.
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch
import torch.nn.functional as F

from mobilenet_yolo_tpu_torch.kernels import _build

CHUNK = 32          # hidden channels per pass, csrc/fused_common.cuh:kChunk
TILE_PIX = 64       # output pixels per thread block, kTilePix
MAX_COUT = 320      # output channels one block holds, kMaxCout
SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper
_DTYPES = (torch.float32, torch.bfloat16)

# The bf16 block kernel (csrc/fused_block_bf16.cu): hidden channels per
# chunk (kKc; 48 = 3 x 16 divides every MobileNetV2 hidden width), output
# pixels per block at most (kMaxTile), and the project's warp tilings it
# instantiates (launch_config): (m16 tiles, n8 tiles) of float32
# accumulators per warp, and warps per block.
BF16_CHUNK = 48
BF16_MAX_TILE = 256
BF16_CONFIGS = ((1, 3, 8), (2, 3, 8), (1, 4, 8), (2, 4, 8), (4, 3, 8), (3, 5, 8), (3, 5, 16))
BF16_ACC_REGS = 60  # project accumulators per thread at most: 4 * m16 * n8 tiles

# Kernel vs twin in bf16, relative to the largest output. The kernel rounds
# where pallas_fused.py does (float32 hidden and depthwise, the depthwise
# output rounded to bf16, float32 project sums, one output rounding); the
# twin also rounds the hidden tensor, the project's output and the residual
# sum (2^-9 relative each). A hidden value that rounds differently moves a
# depthwise output by up to one bf16 spacing (2^-8 of it), and the project
# sums Ch such moves of random sign, so each source adds about one rounding
# of the output's scale; the two outputs may then sit one bf16 spacing of
# the largest output (2^-7) apart, plus those few roundings. 3e-2 leaves a
# factor of 2-4 over that; the Pallas kernel in bf16 against the twin sits
# at 0.3-0.5% (tests/test_torch_fused.py).
BF16_REL_TOL = 3e-2


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
def pick_tile(kind: str, ho: int, wo: int, cin: int, cout: int, ch: int = 0,
              batch: int = 128) -> tuple[int, int]:
    """The output tile (th, tw) for ``kind`` "s1", "s2" or "stem" (the
    float32 kernels and the stem) or "s1_bf16", "s2_bf16" (the bf16 block
    kernel: ``plan_bf16``'s tile, which also needs ``ch`` and ``batch``).

    For the float32 kinds, th * tw <= TILE_PIX and the tile minimises the
    modelled work per hidden channel (the expand over the window, recomputed
    on the halo, plus the depthwise and project over all TILE_PIX slots)
    within the shared memory a block has."""
    if kind.endswith("_bf16"):
        if ch < 1:
            raise ValueError(f"pick_tile({kind!r}) needs the hidden width ch")
        plan = plan_bf16(int(kind[1]), batch, ho, wo, cin, ch, cout)
        return plan.th, plan.tw
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


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _odd_stride(n: int) -> int:
    """csrc/fused_block_bf16.cu:odd_stride: a bf16 row of an odd number of
    16-byte units holding at least n values."""
    return (_up(n, 8) // 8 | 1) * 8


def _bf16_stage_bytes(cin: int, cout: int) -> int:
    kc = BF16_CHUNK
    return 2 * (_up(cin, 16) * (kc + 8) + kc * _odd_stride(cout) + 9 * kc) + 4 * 2 * kc


def _bf16_smem_bytes(stride: int, th: int, tw: int, cin: int, cout: int) -> int:
    """csrc/fused_block_bf16.cu:bf16_smem_bytes: the bf16 input window, the
    float32 hidden chunk over it, the bf16 depthwise output of the tile and
    two stages of chunk weights."""
    wpp = _up((stride * (th - 1) + 3) * (stride * (tw - 1) + 3), 16)
    return (2 * wpp * _odd_stride(_up(cin, 16)) + 4 * wpp * (BF16_CHUNK + 8)
            + 2 * _up(th * tw, 16) * (BF16_CHUNK + 8) + 2 * _bf16_stage_bytes(cin, cout))


def bf16_config(pixels: int, cout: int) -> tuple[int, int, int] | None:
    """The instantiated (mw, nw, warps) whose project warp grid covers
    ``pixels`` tile pixels (m16 tiles) and ``cout`` channels (n8 tiles) with
    the fewest accumulators per thread, then the fewest warps; None if none
    does. csrc/fused_block_bf16.cu:launch checks the same cover."""
    mt, nt = -(-pixels // 16), -(-cout // 8)
    fits = [(mw * nw, warps, (mw, nw, warps)) for mw, nw, warps in BF16_CONFIGS
            if -(-nt // nw) <= warps and warps // -(-nt // nw) * mw >= mt]
    return min(fits)[2] if fits else None


class Bf16Plan(NamedTuple):
    th: int
    tw: int
    mw: int
    nw: int
    warps: int
    smem: int


# The bf16 kernel's cost model, in SM cycles of an H100, fitted to the
# plan sweep of tools/probe_fused_tiles.py at every served block shape
# (PERF.md, PR 5). A block pays a fixed _BLOCK (window load, output) and,
# per hidden chunk, a fixed _CHUNK (three barriers, the cp.async wait),
# the latency of its slowest warp (expand k-steps, depthwise rounds) and
# the issue cycles of its instructions, phase by phase. Blocks resident on
# one SM run side by side at the same speed (the kernel is bound by
# latency, not by the SM's issue rate: the fit is best so), so a wave is
# the resident blocks of all SMs. Every tile restages all of w1 and w2
# through L2 (the float32 kernel's 4x11 tiles at 11x11 pulled 1.8 MB
# each): that traffic over L2's rate bounds the launch from below.
_BLOCK, _CHUNK = 8609, 6173
_EXPAND_ISSUE, _DW_ISSUE, _PROJECT_ISSUE = 2.548, 4.021, 2.315
_EXPAND_KSTEP, _DW_ROUND = 197, 236
_L2_BYTES_PER_CYCLE = 2800   # ~5.5 TB/s at 1.98 GHz, the whole card
_NUM_SMS = 132
_SM_SMEM = 233472   # shared memory per SM; each block also reserves 1 KB


def _bf16_blocks_per_sm(mw: int, nw: int, warps: int, smem: int) -> int:
    """Blocks resident on one SM: shared memory, and registers as the
    kernel's __launch_bounds__ promise them (kMinBlocks: two for the small
    8-warp tilings, one otherwise)."""
    by_regs = 2 if warps == 8 and mw * nw <= 8 else 1
    return min(_SM_SMEM // (smem + 1024), by_regs)


def _bf16_cost(stride, batch, ho, wo, cin, ch, cout, th, tw, mw, nw, warps, smem) -> float:
    kc, ksteps = BF16_CHUNK, _up(cin, 16) // 16
    per_sm = _bf16_blocks_per_sm(mw, nw, warps, smem)
    if per_sm < 1:
        return float("inf")
    # expand: items of 16 * em rows by 8 * en channels; per k-step the
    # ldmatrix and mma instructions, per item the epilogue's
    em, en = (2, 6 if mw * nw > 8 else 3) if warps == 8 else (1, 3)
    m_tiles = _up((stride * (th - 1) + 3) * (stride * (tw - 1) + 3), 16) // 16
    e_items = -(-m_tiles // em) * (kc // (8 * en))
    expand = e_items * (ksteps * (em + en / 2 + em * en) + 2 * em * (6 * en + 4)) / 4
    # depthwise: items of r output rows x 4 channels, 32 to a warp
    r = 1 if warps > 8 else 4 if stride == 1 and mw * nw <= 6 else 2
    d_items = -(-th // r) * tw * (kc // 4)
    depthwise = -(-d_items // 32) * (((r - 1) * stride + 3) * 3 + 9 + 54 * r) / 4
    # project: each busy warp, per k-step, mw + nw loads and mw * nw mma
    n_tiles, p_tiles = -(-cout // 8), _up(th * tw, 16) // 16
    warps_n = -(-n_tiles // nw)
    warps_m = min(warps // warps_n, -(-p_tiles // mw))
    project = warps_m * warps_n * (kc // 16) * (mw + nw + mw * nw) / 4
    latency = (_EXPAND_KSTEP * -(-e_items // warps) * ksteps
               + _DW_ROUND * -(-d_items // (32 * warps)))
    issue = _EXPAND_ISSUE * expand + _DW_ISSUE * depthwise + _PROJECT_ISSUE * project
    blocks, chunks = batch * -(-ho // th) * -(-wo // tw), -(-ch // kc)
    waves = -(-blocks // (_NUM_SMS * per_sm))
    restaged = blocks * chunks * _bf16_stage_bytes(cin, cout)
    return max(waves * (_BLOCK + chunks * (_CHUNK + latency + issue)),
               restaged / _L2_BYTES_PER_CYCLE)


def bf16_plans(stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
               cout: int) -> list[tuple[float, Bf16Plan]]:
    """Every bf16 launch plan for an output of ho x wo, with its modelled
    cycles (``_bf16_cost``), best first: each tile of at most BF16_MAX_TILE
    pixels whose shared memory fits a block and that an instantiated warp
    tiling covers (so its accumulators fit BF16_ACC_REGS)."""
    plans = []
    for th in range(1, min(ho, BF16_MAX_TILE) + 1):
        for tw in range(1, min(wo, BF16_MAX_TILE // th) + 1):
            cfg = bf16_config(th * tw, cout)
            smem = _bf16_smem_bytes(stride, th, tw, cin, cout)
            if cfg is None or smem > SMEM_LIMIT:
                continue
            cost = _bf16_cost(stride, batch, ho, wo, cin, ch, cout, th, tw, *cfg, smem)
            plans.append(((cost, -th * tw, th), Bf16Plan(th, tw, *cfg, smem)))
    plans.sort()
    return [(key[0], plan) for key, plan in plans]


@functools.lru_cache(maxsize=1024)
def plan_bf16(stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
              cout: int) -> Bf16Plan:
    """The bf16 kernel's launch plan with the least modelled time."""
    plans = bf16_plans(stride, batch, ho, wo, cin, ch, cout)
    if not plans:
        raise ValueError(f"no bf16 s{stride} tile of {ho}x{wo}, Cin={cin}, Cout={cout} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return plans[0][1]


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


def _launch_block(x, w1, b1, wdw, bdw, w2, b2, residual: bool, stride: int,
                  plan: Bf16Plan | None = None) -> torch.Tensor:
    """float32 -> csrc/fused_block.cu, bf16 -> csrc/fused_block_bf16.cu
    (with ``plan``, or ``plan_bf16``'s); neither falls back to the other."""
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    ho, wo = h // stride, w // stride
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    b1, bdw, b2 = _f32(b1), _f32(bdw), _f32(b2)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wdw, bdw, w2, b2, out)]
    dims = [b, h, w, cin, ch, cout, stride, int(residual)]
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        if x.dtype == torch.bfloat16:
            plan = plan or plan_bf16(stride, b, ho, wo, cin, ch, cout)
            # 16-byte copies need rows of whole 16-byte units and aligned bases
            vec = all(v % 8 == 0 for v in (cin, ch, cout)) and all(p % 16 == 0 for p in ptrs)
            name = "fused_block_bf16"
            err = lib.myt_fused_block_bf16(*ptrs, *dims, plan.th, plan.tw, plan.mw, plan.nw,
                                           plan.warps, int(vec), stream)
        else:
            name = "fused_block"
            err = lib.myt_fused_block(*ptrs, *dims, *pick_tile(f"s{stride}", ho, wo, cin, cout),
                                      stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------- wrappers --

def fused_inverted_residual(x: torch.Tensor, w1, b1, wdw, bdw, w2, b2,
                            residual: bool = True) -> torch.Tensor:
    """Stride-1 inverted residual, BN folded: x (B, H, W, Cin) -> (B, H, W, Cout).

    A CUDA tensor launches its dtype's kernel (``csrc/fused_block.cu`` for
    float32, ``csrc/fused_block_bf16.cu`` for bf16) on the current stream,
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
