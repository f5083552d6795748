"""Fused MobileNetV2 blocks with BatchNorm folded: CUDA kernels and twins.

Ports of the public functions of ``mobilenet_yolo_tpu/kernels/pallas_fused.py``,
in the JAX package's layout: NHWC activations (a contiguous NHWC tensor is
the port's ``channels_last`` NCHW tensor, so the model needs no copy),
``w1 (Cin, Ch)``, ``wdw (3, 3, Ch)``, ``w2 (Ch, Cout)``, ``k_stem (3, 3,
3, Ch)`` and biases ``(C,)``.

* ``fused_inverted_residual`` replaces ``pallas_fused.py:101`` (stride 1,
  optional residual) and ``fused_inverted_residual_s2`` replaces
  ``pallas_fused.py:193`` (stride 2, H and W even). Both 1x1 products run
  on the tensor cores: float32 tensors in ``csrc/fused_block.cu`` (TF32
  with the error-compensated three-pass split, float32-accurate), bf16
  tensors in ``csrc/fused_block_bf16.cu``; each with its launch plans
  (``plan_f32``, ``plan_bf16``) from one cost model fitted on the card;
* ``fused_stem_block0`` replaces ``pallas_fused.py:355`` (3x3/s2 stem with
  pad 1, then block 0's depthwise and project) with ``csrc/fused_stem.cu``,
  both products on the tensor cores too (the stem as an implicit GEMM over
  the tile's hidden window, K = 27 taps padded to 32), with its launch plan
  from ``plan_stem``.

``inverted_residual_reference`` and ``stem_block0_reference`` are the plain
twins, counterparts of ``xla_inverted_residual`` (``:243``) and
``xla_stem_block0`` (``:402``) as three ``F.conv2d`` calls in
``channels_last``. They serve CPU tensors and are the kernels' oracle on the
card; never a fallback for a CUDA tensor. In float32 they agree with the
kernels up to summation order (the float32 block kernel's three TF32
passes keep float32's accuracy: ``tf32_round`` and ``matmul_tf32x3`` model
them in plain torch for the tests). In bf16 the twins round the hidden
tensor and each conv's output to bf16, as ``xla_inverted_residual`` rounds
to ``x.dtype``. The bf16 block kernel rounds where the Pallas kernel does:
float32 hidden tensor and depthwise, the depthwise output rounded to bf16
for the project, one rounding of the output (``BF16_REL_TOL``); the stem
kernel rounds at the same points (its stem's products of bf16 operands are
exact, summed in float32).

Biases may be float32 or the activations' type; the kernels read them as
float32.
"""

from __future__ import annotations

import functools
from typing import Callable, NamedTuple

import torch
import torch.nn.functional as F

from mobilenet_yolo_tpu_torch.kernels import _build

SMEM_LIMIT = 232448  # dynamic shared memory one block may use on Hopper
# output channels the fused kernels take: the widest project warp tiling,
# (3, 5) on 8 warps, covers 40 n8 tiles with one warp row of 48 pixels
MAX_COUT = 320
_DTYPES = (torch.float32, torch.bfloat16)

# The stem kernel on the tensor cores (csrc/fused_stem.cu): hidden channels
# per chunk (kKc), output pixels per block at most (kMaxTile), and the
# project's warp tilings it instantiates on 8 warps (launch_config).
STEM_CHUNK = 32
STEM_MAX_TILE = 256
STEM_CONFIGS = ((2, 2, 8), (2, 3, 8), (2, 4, 8), (4, 3, 8), (3, 5, 8))

# The block kernels on the tensor cores (csrc/fused_block_bf16.cu,
# csrc/fused_block.cu): hidden channels per chunk (kKc; 48 = 3 x 16 and
# 24 = 3 x 8 divide every MobileNetV2 hidden width), output pixels per
# block at most (kMaxTile), and the project's warp tilings both instantiate
# (launch_config): (m16 tiles, n8 tiles) of float32 accumulators per warp,
# and warps per block.
BF16_CHUNK = 48
F32_CHUNK = 24
BF16_MAX_TILE = 256
F32_MAX_TILE = 256
BF16_CONFIGS = ((1, 3, 8), (2, 3, 8), (1, 4, 8), (2, 4, 8), (4, 3, 8), (3, 5, 8), (3, 5, 16))
F32_CONFIGS = BF16_CONFIGS
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
# Kernel vs twin in float32, relative to the largest output: both are
# float32-accurate (three TF32 passes reach float32's own error, PERF.md)
# and sum in other orders; the project sums up to 960 terms at 6e-8 each,
# 5.8e-5 at worst.
F32_REL_TOL = 1e-4


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

@functools.lru_cache(maxsize=1024)
def pick_tile(kind: str, ho: int, wo: int, cin: int, cout: int, ch: int = 0,
              batch: int = 128) -> tuple[int, int]:
    """The output tile (th, tw) for ``kind`` "stem" or "stem_bf16" (the stem
    kernel: ``plan_stem``'s tile), "s1" or "s2" (the float32 block kernel:
    ``plan_f32``'s tile) or "s1_bf16", "s2_bf16" (the bf16 block kernel:
    ``plan_bf16``'s tile). Every kind needs the hidden width ``ch``."""
    if ch < 1:
        raise ValueError(f"pick_tile({kind!r}) needs the hidden width ch")
    dtype = "bf16" if kind.endswith("_bf16") else "f32"
    if kind.startswith("stem"):
        plan = plan_stem(dtype, batch, ho, wo, ch, cout)
    else:
        plan = (plan_bf16 if dtype == "bf16" else plan_f32)(int(kind[1]), batch, ho, wo, cin,
                                                            ch, cout)
    return plan.th, plan.tw


def _up(v: int, m: int) -> int:
    return -(-v // m) * m


def _odd_stride(n: int) -> int:
    """csrc/fused_block_bf16.cu:odd_stride (bf16) and csrc/fused_block.cu:
    w2_stride (float32): an odd multiple of 8 values holding at least n."""
    return (_up(n, 8) // 8 | 1) * 8


def _window_rows(stride: int, th: int, tw: int) -> int:
    return _up((stride * (th - 1) + 3) * (stride * (tw - 1) + 3), 16)


def _bf16_stage_bytes(cin: int, cout: int) -> int:
    kc = BF16_CHUNK
    return 2 * (_up(cin, 16) * (kc + 8) + kc * _odd_stride(cout) + 9 * kc) + 4 * 2 * kc


def _bf16_smem_bytes(stride: int, th: int, tw: int, cin: int, cout: int) -> int:
    """csrc/fused_block_bf16.cu:bf16_smem_bytes: the bf16 input window, the
    float32 hidden chunk over it, the bf16 depthwise output of the tile and
    two stages of chunk weights."""
    wpp = _window_rows(stride, th, tw)
    return (2 * wpp * _odd_stride(_up(cin, 16)) + 4 * wpp * (BF16_CHUNK + 8)
            + 2 * _up(th * tw, 16) * (BF16_CHUNK + 8) + 2 * _bf16_stage_bytes(cin, cout))


def _f32_stage_bytes(cin: int, cout: int) -> int:
    """csrc/fused_block.cu:stage_floats, in bytes: w1 [Cin8][24], w2
    [24][odd multiple of 8 >= Cout], the taps and both biases."""
    kc = F32_CHUNK
    return 4 * (_up(cin, 8) * kc + kc * _odd_stride(cout) + 9 * kc + 2 * kc)


def _f32_smem_bytes(stride: int, th: int, tw: int, cin: int, cout: int) -> int:
    """csrc/fused_block.cu:f32_smem_bytes: the float32 input window (rows
    of Cin8 + 4), the hidden chunk over it (rows of 24), the depthwise
    output of the tile (rows of 28) and two stages of chunk weights."""
    wpp = _window_rows(stride, th, tw)
    return (4 * (wpp * (_up(cin, 8) + 4) + wpp * F32_CHUNK + _up(th * tw, 16) * (F32_CHUNK + 4))
            + 2 * _f32_stage_bytes(cin, cout))


def warp_config(pixels: int, cout: int,
                configs: tuple = BF16_CONFIGS) -> tuple[int, int, int] | None:
    """The instantiated (mw, nw, warps) of ``configs`` (the block kernels'
    by default; ``STEM_CONFIGS``) whose project warp grid covers ``pixels``
    tile pixels (m16 tiles) and ``cout`` channels (n8 tiles) with the fewest
    accumulators per thread, then the fewest warps; None if none does. The
    kernels' ``launch`` check the same cover."""
    mt, nt = -(-pixels // 16), -(-cout // 8)
    fits = [(mw * nw, warps, (mw, nw, warps)) for mw, nw, warps in configs
            if -(-nt // nw) <= warps and warps // -(-nt // nw) * mw >= mt]
    return min(fits)[2] if fits else None


class Plan(NamedTuple):
    th: int
    tw: int
    mw: int
    nw: int
    warps: int
    smem: int


class _Route(NamedTuple):
    """What the cost model needs of one tensor-core block kernel."""
    chunk: int                   # hidden channels per chunk
    kstep: int                   # the mma's K: 16 (bf16) or 8 (tf32)
    smem: Callable               # (stride, th, tw, cin, cout) -> bytes
    stage: Callable              # (cin, cout) -> bytes of one weight stage
    expand_item: Callable        # (mw, nw, warps) -> (m16, n8) tiles of an expand item
    expand_ops: Callable         # (em, en) -> instructions per expand k-step of an item
    project_ops: Callable        # (mw, nw) -> instructions per project k-step of a warp
    ksplit: bool                 # two warps share an expand item where warps >= 2 x items
    # cycles: per block, per chunk; issue weights of the expand, depthwise
    # and project instructions; latency of an expand k-step, a depthwise round
    block: float
    per_chunk: float
    expand_issue: float
    dw_issue: float
    project_issue: float
    expand_kstep: float
    dw_round: float


# The cost model, in SM cycles of an H100, fitted per kernel to the plan
# sweep of tools/probe_fused_tiles.py at every served block shape (PERF.md;
# `--fit` refits a route). A block pays a fixed cost (window load, output)
# and, per hidden chunk, a fixed cost (three barriers, the cp.async wait),
# the latency of its slowest warp (expand k-steps, depthwise rounds) and
# the issue cycles of its instructions, phase by phase. Blocks resident on
# one SM run side by side at the same speed (the kernels are bound by
# latency, not by the SM's issue rate: the fit is best so), so a wave is
# the resident blocks of all SMs. Every tile restages all of w1 and w2
# through L2 (1.8 MB a tile at block 16's float32 widths): that traffic
# over L2's rate bounds the launch from below.
_BF16 = _Route(
    chunk=BF16_CHUNK, kstep=16, smem=_bf16_smem_bytes, stage=_bf16_stage_bytes,
    # 8 warps: 32x48 items for the large tilings, else 32x24; 16 warps 16x24
    expand_item=lambda mw, nw, warps: (2, 6 if mw * nw > 8 else 3) if warps == 8 else (1, 3),
    # ldmatrix A per m16, ldmatrix .trans B per two n8, one mma per pair
    expand_ops=lambda em, en: em + en / 2 + em * en,
    project_ops=lambda mw, nw: mw + nw + mw * nw, ksplit=False,
    block=8609, per_chunk=6173, expand_issue=2.548, dw_issue=4.021, project_issue=2.315,
    expand_kstep=197, dw_round=236)
# float32: ldmatrix A per m16, two 32-bit loads of B per n8, the split of
# each fragment register (two integer operations, a subtraction, two
# more), per pair three mma and the four adds of their fresh accumulator
_F32 = _Route(
    chunk=F32_CHUNK, kstep=8, smem=_f32_smem_bytes, stage=_f32_stage_bytes,
    expand_item=lambda mw, nw, warps: (2 if warps == 8 else 1, 3),
    expand_ops=lambda em, en: em + 2 * en + 5 * (4 * em + 2 * en) + 7 * em * en,
    project_ops=lambda mw, nw: mw + 2 * nw + 5 * (4 * mw + 2 * nw) + 7 * mw * nw, ksplit=True,
    block=13576.797, per_chunk=8093.144, expand_issue=0.684, dw_issue=0.245, project_issue=1.541,
    expand_kstep=412.187, dw_round=848.195)
_ROUTES = {"bf16": _BF16, "f32": _F32}
_L2_BYTES_PER_CYCLE = 2800   # ~5.5 TB/s at 1.98 GHz, the whole card
_NUM_SMS = 132
_SM_SMEM = 233472   # shared memory per SM; each block also reserves 1 KB


def blocks_per_sm(mw: int, nw: int, warps: int, smem: int) -> int:
    """Blocks resident on one SM: shared memory, and registers as the
    kernels' __launch_bounds__ promise them (kMinBlocks: two for the small
    8-warp tilings, one otherwise)."""
    by_regs = 2 if warps == 8 and mw * nw <= 8 else 1
    return min(_SM_SMEM // (smem + 1024), by_regs)


# the fitted constants of a route, in the order of _cost_terms' terms
COST_CONSTANTS = ("block", "per_chunk", "expand_kstep", "dw_round", "expand_issue", "dw_issue",
                  "project_issue")


def _cost_terms(route: _Route, stride, batch, ho, wo, cin, ch, cout, th, tw, mw, nw, warps,
                smem) -> tuple[list[float], float] | None:
    """The cost model's terms, one per constant of COST_CONSTANTS (the
    modelled cycles are their dot product with the constants), and the
    L2 floor in cycles; None if the block does not fit an SM."""
    kc, ksteps = route.chunk, _up(cin, route.kstep) // route.kstep
    per_sm = blocks_per_sm(mw, nw, warps, smem)
    if per_sm < 1:
        return None
    # expand: items of 16 * em rows by 8 * en channels; per k-step the
    # loads, splits and mma instructions, per item the epilogue's
    em, en = route.expand_item(mw, nw, warps)
    m_tiles = _window_rows(stride, th, tw) // 16
    e_items = -(-m_tiles // em) * (kc // (8 * en))
    expand = e_items * (ksteps * route.expand_ops(em, en) + 2 * em * (6 * en + 4)) / 4
    # depthwise: items of r output rows x 4 channels, 32 to a warp
    r = 1 if warps > 8 else 4 if stride == 1 and mw * nw <= 6 else 2
    d_items = -(-th // r) * tw * (kc // 4)
    depthwise = -(-d_items // 32) * (((r - 1) * stride + 3) * 3 + 9 + 54 * r) / 4
    # project: each busy warp, per k-step, its loads, splits and mma
    n_tiles, p_tiles = -(-cout // 8), _up(th * tw, 16) // 16
    warps_n = -(-n_tiles // nw)
    warps_m = min(warps // warps_n, -(-p_tiles // mw))
    project = warps_m * warps_n * (kc // route.kstep) * route.project_ops(mw, nw) / 4
    blocks, chunks = batch * -(-ho // th) * -(-wo // tw), -(-ch // kc)
    waves = -(-blocks // (_NUM_SMS * per_sm))
    wc = waves * chunks
    # the expand's chain of k-steps: its items' rounds over the warps, or
    # half the k-steps where two warps share each item
    split = route.ksplit and 2 * e_items <= warps and ksteps > 1
    chain = -(-ksteps // 2) if split else -(-e_items // warps) * ksteps
    terms = [waves, wc, wc * chain, wc * -(-d_items // (32 * warps)),
             wc * expand, wc * depthwise, wc * project]
    return terms, blocks * chunks * route.stage(cin, cout) / _L2_BYTES_PER_CYCLE


def _cost(route: _Route, stride, batch, ho, wo, cin, ch, cout, th, tw, mw, nw, warps,
          smem) -> float:
    found = _cost_terms(route, stride, batch, ho, wo, cin, ch, cout, th, tw, mw, nw, warps, smem)
    if found is None:
        return float("inf")
    terms, l2_floor = found
    return max(sum(getattr(route, c) * t for c, t in zip(COST_CONSTANTS, terms)), l2_floor)


def block_plans(dtype: str, stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
                cout: int) -> list[tuple[float, Plan]]:
    """Every launch plan of the ``dtype`` ("f32" or "bf16") block kernel for
    an output of ho x wo, with its modelled cycles (``_cost``), best first:
    each tile of at most 256 pixels whose shared memory fits a block and
    that an instantiated warp tiling covers (so its accumulators fit
    BF16_ACC_REGS)."""
    route = _ROUTES[dtype]
    plans = []
    for th in range(1, min(ho, BF16_MAX_TILE) + 1):
        for tw in range(1, min(wo, BF16_MAX_TILE // th) + 1):
            cfg = warp_config(th * tw, cout)
            smem = route.smem(stride, th, tw, cin, cout)
            if cfg is None or smem > SMEM_LIMIT:
                continue
            cost = _cost(route, stride, batch, ho, wo, cin, ch, cout, th, tw, *cfg, smem)
            plans.append(((cost, -th * tw, th), Plan(th, tw, *cfg, smem)))
    plans.sort()
    return [(key[0], plan) for key, plan in plans]


def _best_plan(dtype: str, stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
               cout: int) -> Plan:
    plans = block_plans(dtype, stride, batch, ho, wo, cin, ch, cout)
    if not plans:
        raise ValueError(f"no {dtype} s{stride} tile of {ho}x{wo}, Cin={cin}, Cout={cout} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return plans[0][1]


@functools.lru_cache(maxsize=1024)
def plan_bf16(stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
              cout: int) -> Plan:
    """The bf16 kernel's launch plan with the least modelled time."""
    return _best_plan("bf16", stride, batch, ho, wo, cin, ch, cout)


@functools.lru_cache(maxsize=1024)
def plan_f32(stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
             cout: int) -> Plan:
    """The float32 kernel's launch plan with the least modelled time."""
    return _best_plan("f32", stride, batch, ho, wo, cin, ch, cout)


# ---------------------------------------------------------- the stem plan

def _stem_smem_bytes(dtype: str, th: int, tw: int, cout: int) -> int:
    """csrc/fused_stem.cu:stem_smem_bytes: the input window (2 * th + 5 rows
    of the window's 6 * tw + 15 values, from an aligned start up to one
    16-byte unit before them), the float32 hidden chunk over the (th + 2) x
    (tw + 2) hidden window (rows of 36 floats), the tile's depthwise output
    (rows of 36 floats or 40 bf16), the chunk's stem weights (32 rows of 36
    tf32 hi/lo pairs, or of 40 bf16), its project weights and taps in x's
    type and its biases in float32."""
    if dtype == "f32":
        elem, vec, ds, ws = 4, 4, STEM_CHUNK + 4, 8 * (STEM_CHUNK + 4)
    else:
        elem, vec, ds, ws = 2, 8, STEM_CHUNK + 8, 2 * (STEM_CHUNK + 8)
    ld = _up(6 * tw + 14 + vec, vec)
    return (elem * ((2 * th + 5) * ld + _up(th * tw, 16) * ds + STEM_CHUNK * _odd_stride(cout)
                    + 9 * STEM_CHUNK)
            + 32 * ws + 4 * ((th + 2) * (tw + 2) * (STEM_CHUNK + 4) + 2 * STEM_CHUNK))


# The stem's cost model, in SM cycles, unfitted: a block pays a fixed cost
# (the window's load, the output's store) and per hidden chunk the stem over
# its hidden window's m16 tiles (per dtype: three TF32 passes over four k8
# steps, or two k16 steps), the depthwise over its pixels and the project
# over its m16 x n8 tiles. Blocks resident on one SM run side by side (the
# block kernels' fit), so a wave is the resident blocks of all SMs.
_STEM_BLOCK = 6000
_STEM_PER_MTILE = {"f32": 420, "bf16": 70}
_STEM_PER_PIXEL = 12
_STEM_PER_PROJECT_TILE = {"f32": 60, "bf16": 8}


def stem_plans(dtype: str, batch: int, ho: int, wo: int, ch: int,
               cout: int) -> list[tuple[float, Plan]]:
    """Every launch plan of the ``dtype`` ("f32" or "bf16") stem kernel for
    an output of ho x wo, with its modelled cycles, best first: each tile of
    at most STEM_MAX_TILE pixels whose shared memory fits a block and that
    an instantiated warp tiling (``STEM_CONFIGS``) covers."""
    chunks, n8 = -(-ch // STEM_CHUNK), -(-cout // 8)
    plans = []
    for th in range(1, min(ho, STEM_MAX_TILE) + 1):
        for tw in range(1, min(wo, STEM_MAX_TILE // th) + 1):
            cfg = warp_config(th * tw, cout, STEM_CONFIGS)
            smem = _stem_smem_bytes(dtype, th, tw, cout)
            if cfg is None or smem > SMEM_LIMIT:
                continue
            per_sm = blocks_per_sm(*cfg, smem)
            blocks = batch * -(-ho // th) * -(-wo // tw)
            waves = -(-blocks // (_NUM_SMS * per_sm))
            block = _STEM_BLOCK + chunks * (
                _STEM_PER_MTILE[dtype] * _up((th + 2) * (tw + 2), 16) // 16
                + _STEM_PER_PIXEL * th * tw
                + _STEM_PER_PROJECT_TILE[dtype] * _up(th * tw, 16) // 16 * n8)
            plans.append(((waves * block, -th * tw, th), Plan(th, tw, *cfg, smem)))
    plans.sort()
    return [(key[0], plan) for key, plan in plans]


@functools.lru_cache(maxsize=1024)
def plan_stem(dtype: str, batch: int, ho: int, wo: int, ch: int, cout: int) -> Plan:
    """The stem kernel's launch plan with the least modelled time."""
    plans = stem_plans(dtype, batch, ho, wo, ch, cout)
    if not plans:
        raise ValueError(f"no {dtype} stem tile of {ho}x{wo}, Cout={cout} fits "
                         f"{SMEM_LIMIT} bytes of shared memory")
    return plans[0][1]


# -------------------------------------------------- the 3xTF32 split, modelled

def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32`` in plain torch: float32 rounded to 10 mantissa
    bits, to nearest with ties away from zero (adding half a unit of the
    13 dropped bits to the bit pattern rounds the magnitude; the sign bit
    is left alone). Finite inputs only."""
    bits = t.to(torch.float32).contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def matmul_tf32x3(a: torch.Tensor, b: torch.Tensor, passes: int = 3) -> torch.Tensor:
    """``a @ b`` (float32, (M, K) @ (K, N)) as ``csrc/fused_block.cu`` sums
    it on the tensor cores: each operand split into hi = tf32(v) and lo =
    tf32(v - hi); per k-step of 8 the products a_lo b_hi, a_hi b_lo, a_hi
    b_hi summed from zero, then added to the float32 accumulator.
    ``passes=1`` keeps a_hi b_hi alone: one TF32 pass. Tests use it; no
    kernel path does."""
    if passes not in (1, 3):
        raise ValueError(f"passes is 1 or 3, got {passes}")
    a, b = a.to(torch.float32), b.to(torch.float32)
    a_hi, b_hi = tf32_round(a), tf32_round(b)
    a_lo, b_lo = tf32_round(a - a_hi), tf32_round(b - b_hi)
    pairs = ((a_lo, b_hi), (a_hi, b_lo), (a_hi, b_hi))[3 - passes:]
    acc = torch.zeros((a.shape[0], b.shape[1]), dtype=torch.float32)
    for k in range(0, a.shape[1], 8):
        step = torch.zeros_like(acc)
        for x, y in pairs:
            step = step + x[:, k:k + 8] @ y[k:k + 8]
        acc = acc + step
    return acc


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
                  plan: Plan | None = None) -> torch.Tensor:
    """float32 -> csrc/fused_block.cu, bf16 -> csrc/fused_block_bf16.cu,
    each with ``plan`` or its dtype's best plan (``plan_f32``,
    ``plan_bf16``); neither falls back to the other."""
    b, h, w, cin = x.shape
    ch, cout = w1.shape[1], w2.shape[1]
    ho, wo = h // stride, w // stride
    out = torch.empty((b, ho, wo, cout), dtype=x.dtype, device=x.device)
    b1, bdw, b2 = _f32(b1), _f32(bdw), _f32(b2)
    ptrs = [t.data_ptr() for t in (x, w1, b1, wdw, bdw, w2, b2, out)]
    dims = [b, h, w, cin, ch, cout, stride, int(residual)]
    bf16 = x.dtype == torch.bfloat16
    plan = plan or (plan_bf16 if bf16 else plan_f32)(stride, b, ho, wo, cin, ch, cout)
    # 16-byte copies need rows of whole 16-byte units and aligned bases
    per_copy = 8 if bf16 else 4
    vec = all(v % per_copy == 0 for v in (cin, ch, cout)) and all(p % 16 == 0 for p in ptrs)
    name = "myt_fused_block_bf16" if bf16 else "myt_fused_block"
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = getattr(lib, name)(*ptrs, *dims, plan.th, plan.tw, plan.mw, plan.nw, plan.warps,
                                 int(vec), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: CUDA error {err}")
    return out


def _launch_stem(x, k_stem, b_stem, wdw, bdw, w2, b2, plan: Plan | None = None) -> torch.Tensor:
    """csrc/fused_stem.cu in x's type, with ``plan`` or ``plan_stem``'s."""
    b, h, w, _ = x.shape
    ch, cout = k_stem.shape[-1], w2.shape[-1]
    bf16 = x.dtype == torch.bfloat16
    plan = plan or plan_stem("bf16" if bf16 else "f32", b, h // 2, w // 2, ch, cout)
    out = torch.empty((b, h // 2, w // 2, cout), dtype=x.dtype, device=x.device)
    b_stem, bdw, b2 = _f32(b_stem), _f32(bdw), _f32(b2)
    # 16-byte copies: of the input window, its rows (3 * W values) in whole
    # 16-byte units and an aligned base (bit 0); of the weights, Ch and Cout
    # in whole units and every weight aligned (bit 1)
    per_copy = 16 // x.element_size()
    vec = int(3 * w % per_copy == 0 and x.data_ptr() % 16 == 0)
    weights = (k_stem, wdw, w2, b_stem, bdw)
    if ch % per_copy == 0 and cout % per_copy == 0 and all(t.data_ptr() % 16 == 0
                                                           for t in weights):
        vec |= 2
    lib = _build.load()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.myt_fused_stem(x.data_ptr(), k_stem.data_ptr(), b_stem.data_ptr(),
                                 wdw.data_ptr(), bdw.data_ptr(), w2.data_ptr(), b2.data_ptr(),
                                 out.data_ptr(), b, h, w, ch, cout, plan.th, plan.tw, plan.mw,
                                 plan.nw, plan.warps, vec, int(bf16), stream)
    if err != 0:
        raise RuntimeError(f"fused_stem kernel launch failed: CUDA error {err}")
    return out


# ---------------------------------------------------------------- wrappers --

def fused_inverted_residual(x: torch.Tensor, w1, b1, wdw, bdw, w2, b2,
                            residual: bool = True) -> torch.Tensor:
    """Stride-1 inverted residual, BN folded: x (B, H, W, Cin) -> (B, H, W, Cout).

    A CUDA tensor launches its dtype's kernel (``csrc/fused_block.cu`` for
    float32, ``csrc/fused_block_bf16.cu`` for bf16) on the current stream,
    without synchronising, and adds one to ``fused_inverted_residual.launches``;
    a CPU tensor runs ``inverted_residual_reference``. Any other input raises.

    The float32 kernel runs both 1x1 products on the TF32 tensor cores in
    three passes (``matmul_tf32x3``) and is float32-accurate whatever
    ``torch.backends.cuda.matmul.allow_tf32`` says: it never reads the flag.
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

    A CUDA tensor launches ``csrc/fused_stem.cu`` (both products on the
    tensor cores: bf16, or three TF32 passes for float32, float32-accurate
    whatever ``allow_tf32`` says) with ``plan_stem``'s plan and adds one to
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
    out = _launch_stem(x, k_stem, b_stem, wdw, bdw, w2, b2)
    fused_stem_block0.launches += 1
    return out


fused_inverted_residual.launches = 0
fused_inverted_residual_s2.launches = 0
fused_stem_block0.launches = 0
