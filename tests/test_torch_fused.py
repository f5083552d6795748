"""BatchNorm folding and the folded forward of the port against the JAX
package, on the CPU.

* The fused blocks' twins (``kernels/fused_block.py``) against
  ``xla_inverted_residual`` / ``xla_stem_block0`` at the shapes of
  ``tests/test_pallas_fused.py``, at its tolerances (1e-5 for the blocks,
  1e-4 for the stem); that file pins those references to the Pallas
  kernels. The twins are reached through the public wrappers, which run
  them for CPU tensors and count no launch.
* The twins in bf16 against the Pallas kernels run in interpret mode in
  bf16: the tolerance the card holds the bf16 block kernel to
  (``BF16_REL_TOL``) admits the Pallas kernel's rounding points, which the
  card kernel shares. The bf16 kernel's launch plans at every block of the
  served model.
* ``fold_batchnorm`` against JAX's: the folded state dicts are equal up to
  an ulp or two of float32. ``calibrate_bn`` sets each BatchNorm's running
  statistics to its input's batch statistics.
* The folded model's heads against JAX ``model.apply(fold_batchnorm(v))``
  and against the port's unfolded model, and the folded
  ``make_predict_fn`` against JAX's, at 1e-4 / 1e-5 as
  ``test_torch_models.py`` and ``test_torch_predict.py`` state them.

The kernels themselves run only on the card: ``tests/test_torch_cuda.py``.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.eval.detector import make_predict_fn as jax_make_predict_fn
from mobilenet_yolo_tpu.kernels.pallas_fused import (fused_inverted_residual,
                                                     fused_stem_block0 as pallas_stem_block0,
                                                     fused_inverted_residual_s2,
                                                     xla_inverted_residual, xla_stem_block0)
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.models.bn_fold import fold_batchnorm as jax_fold_batchnorm
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn, fold_batchnorm
from mobilenet_yolo_tpu_torch.models.layers import BN_MOMENTUM

from _torch_parity import (SLIM50_CONFIG, VOC_CONFIG, jax_apply, jax_init, load_yaml,
                           nhwc_input, perturb, port_module, to_nchw, to_nhwc)

HEAD_TOL = dict(atol=1e-4, rtol=1e-4)
WRAPPERS = (fb.fused_inverted_residual, fb.fused_inverted_residual_s2, fb.fused_stem_block0)


def _block_args(seed, b, h, w, cin, ch, cout):
    """tests/test_pallas_fused.py:_mk's draws, as numpy arrays."""
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 1, (b, h, w, cin)).astype(np.float32),
            rng.normal(0, 0.2, (cin, ch)).astype(np.float32),
            rng.normal(0, 0.1, (ch,)).astype(np.float32),
            rng.normal(0, 0.2, (3, 3, ch)).astype(np.float32),
            rng.normal(0, 0.1, (ch,)).astype(np.float32),
            rng.normal(0, 0.2, (ch, cout)).astype(np.float32),
            rng.normal(0, 0.1, (cout,)).astype(np.float32))


def _launches():
    return [f.launches for f in WRAPPERS]


@pytest.mark.parametrize("shape,residual,stride", [
    ((2, 16, 24, 24, 96, 24), True, 1),    # test_fused_s1_matches_xla
    ((2, 16, 24, 24, 96, 24), False, 1),
    ((1, 8, 11, 8, 48, 8), True, 1),       # test_fused_s1_unaligned_width
    ((2, 32, 48, 16, 96, 24), False, 2),   # test_fused_s2_matches_xla
    ((1, 44, 44, 8, 48, 16), False, 2),    # test_fused_s2_odd_tiles
])
def test_block_twin_matches_xla(shape, residual, stride):
    args = _block_args(0, *shape)
    want = np.asarray(xla_inverted_residual(*map(jnp.asarray, args), residual=residual,
                                            stride=stride))
    before = _launches()
    targs = [torch.from_numpy(a) for a in args]
    if stride == 1:
        got = fb.fused_inverted_residual(*targs, residual=residual)
    else:
        got = fb.fused_inverted_residual_s2(*targs)
    assert _launches() == before  # a CPU tensor runs the twin and counts nothing
    assert got.shape == want.shape and got.is_contiguous()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_stem_twin_matches_xla():
    """test_fused_stem_block0_matches_xla's draws, 32x40."""
    rng = np.random.default_rng(0)
    b, h, w, ch, cout = 2, 32, 40, 32, 16
    x = (rng.integers(0, 255, (b, h, w, 3)).astype(np.float32) / 255.0 - 0.5)
    args = (rng.normal(0, 0.3, (3, 3, 3, ch)), rng.normal(0, 0.1, (ch,)),
            rng.normal(0, 0.2, (3, 3, ch)), rng.normal(0, 0.1, (ch,)),
            rng.normal(0, 0.2, (ch, cout)), rng.normal(0, 0.1, (cout,)))
    args = [a.astype(np.float32) for a in args]
    want = np.asarray(xla_stem_block0(jnp.asarray(x), *map(jnp.asarray, args)))
    before = _launches()
    got = fb.fused_stem_block0(torch.from_numpy(x), *map(torch.from_numpy, args))
    assert _launches() == before
    assert got.shape == want.shape == (b, h // 2, w // 2, cout)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)


def _small(x_shape=(1, 8, 8, 8), ch=16, cout=8, dtype=torch.float32):
    args = [torch.from_numpy(a).to(dtype) for a in _block_args(1, *x_shape, ch, cout)]
    return args


def _stem_small(h=8, w=8):
    g = torch.Generator().manual_seed(0)
    return [torch.randn(s, generator=g) for s in
            ((1, h, w, 3), (3, 3, 3, 8), (8,), (3, 3, 8), (8,), (8, 4), (4,))]


def _meta(args, i):
    return [a.to("meta") if j == i else a for j, a in enumerate(args)]


@pytest.mark.parametrize("case,error,match", [
    ("s2_odd_h", ValueError, "even H and W"),
    ("stem_odd_w", ValueError, "even H and W"),
    ("float64_x", TypeError, "float32 or bfloat16"),
    ("weight_dtype", TypeError, "w2 is torch.bfloat16"),
    ("mixed_devices", ValueError, "w1 on meta"),
    ("stem_mixed_devices", ValueError, "k_stem on meta"),
    ("not_contiguous", ValueError, "contiguous"),
    ("residual_width", ValueError, "Cout == Cin"),
    ("wide_cout", ValueError, "at most 320"),
])
def test_wrappers_raise(case, error, match):
    calls = {
        "s2_odd_h": lambda: fb.fused_inverted_residual_s2(*_small((1, 7, 8, 8))),
        "stem_odd_w": lambda: fb.fused_stem_block0(*_stem_small(8, 9)),
        "float64_x": lambda: fb.fused_inverted_residual(*_small(dtype=torch.float64)),
        "weight_dtype": lambda: fb.fused_inverted_residual(
            *_small()[:5], _small()[5].bfloat16(), _small()[6]),
        "mixed_devices": lambda: fb.fused_inverted_residual(*_meta(_small(), 1)),
        "stem_mixed_devices": lambda: fb.fused_stem_block0(*_meta(_stem_small(), 1)),
        "not_contiguous": lambda: fb.fused_inverted_residual(
            _small((1, 8, 8, 8))[0].transpose(1, 2), *_small()[1:]),
        "residual_width": lambda: fb.fused_inverted_residual(*_small(cout=12)),
        "wide_cout": lambda: fb.fused_inverted_residual(*_small(cout=328), residual=False),
    }
    with pytest.raises(error, match=match):
        calls[case]()


def test_pick_tile_fits_every_block_of_the_served_model():
    """At 352x352 the stem kernel gets a 16x16 tile in each dtype, whose
    shared memory lets two blocks share an SM (``plan_stem``); the block
    kinds give their kernels' plans' tiles (float32 ``plan_f32``, bf16
    ``plan_bf16``)."""
    for kind, dtype in (("stem", "f32"), ("stem_bf16", "bf16")):
        th, tw = fb.pick_tile(kind, 176, 176, 3, 16, 32, 128)
        plan = fb.plan_stem(dtype, 128, 176, 176, 32, 16)
        assert (th, tw) == (plan.th, plan.tw) == (16, 16)
        assert plan.smem == fb._stem_smem_bytes(dtype, th, tw, 16) <= fb.SMEM_LIMIT
        assert fb.blocks_per_sm(plan.mw, plan.nw, plan.warps, plan.smem) == 2
    for stride, ho, cin, ch, cout in SERVED_BLOCKS:
        for kind, planner in ((f"s{stride}", fb.plan_f32), (f"s{stride}_bf16", fb.plan_bf16)):
            plan = planner(stride, 128, ho, ho, cin, ch, cout)
            assert fb.pick_tile(kind, ho, ho, cin, cout, ch, 128) == (plan.th, plan.tw)
    for kind in ("s1", "stem"):
        with pytest.raises(ValueError, match="needs the hidden width"):
            fb.pick_tile(kind, 11, 11, 160, 320)


# the stem kernel's shapes: every training bucket at batch 32 and the
# served 352 at 128 (Ch 32, Cout 16), and the card tests' (H, W, Ch, Cout)
STEM_SHAPES = ([(32, size, size, 32, 16) for size in (288, 320, 352, 384, 416)]
               + [(128, 352, 352, 32, 16)]
               + [(2, h, w, ch, cout) for h, w in ((30, 22), (32, 40), (64, 64))
                  for ch, cout in ((13, 6), (32, 16), (40, 70))])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("batch,h,w,ch,cout", STEM_SHAPES)
def test_stem_plan_fits_every_shape(batch, h, w, ch, cout, dtype):
    """The stem kernel's plan: a tile of at most 256 pixels within the
    output whose shared memory fits a Hopper block, and a project warp grid
    of ``STEM_CONFIGS`` that covers the tile's m16 rows and Cout's n8
    columns within the accumulator budget; at the served width (Ch 32, Cout
    16) and every bucket 288-416, a tile of at least 192 pixels (the stem
    recomputed on its halo at most 1.33x) with two blocks on an SM."""
    ho, wo = h // 2, w // 2
    plan = fb.plan_stem(dtype, batch, ho, wo, ch, cout)
    assert 1 <= plan.th * plan.tw <= fb.STEM_MAX_TILE and plan.th <= ho and plan.tw <= wo
    assert plan.smem == fb._stem_smem_bytes(dtype, plan.th, plan.tw, cout) <= fb.SMEM_LIMIT
    assert (plan.mw, plan.nw, plan.warps) in fb.STEM_CONFIGS
    assert 4 * plan.mw * plan.nw <= fb.BF16_ACC_REGS
    m_tiles, n_tiles = -(-plan.th * plan.tw // 16), -(-cout // 8)
    warps_n = -(-n_tiles // plan.nw)
    assert warps_n <= plan.warps and plan.warps // warps_n * plan.mw >= m_tiles
    if (ch, cout) == (32, 16) and h >= 288:
        assert plan.th * plan.tw >= 192
        assert (plan.th + 2) * (plan.tw + 2) <= 1.33 * plan.th * plan.tw
        assert fb.blocks_per_sm(plan.mw, plan.nw, plan.warps, plan.smem) == 2


# the stride-1 and stride-2 blocks of the VOC backbone at 352x352, batch
# 128: (stride, output H = W, Cin, hidden, Cout)
SERVED_BLOCKS = [(2, 88, 16, 96, 24), (1, 88, 24, 144, 24), (2, 44, 24, 144, 32),
                 (1, 44, 32, 192, 32), (2, 22, 32, 192, 64), (1, 22, 64, 384, 64),
                 (1, 22, 64, 384, 96), (1, 22, 96, 576, 96), (2, 11, 96, 576, 160),
                 (1, 11, 160, 960, 160), (1, 11, 160, 960, 320)]


@pytest.mark.parametrize("stride,ho,cin,ch,cout", SERVED_BLOCKS)
def test_f32_plan_fits_every_block_of_the_served_model(stride, ho, cin, ch, cout):
    """The float32 kernel's plan: a tile of at most 256 pixels whose shared
    memory fits a Hopper block, a project warp grid that covers the tile's
    m16 rows and Cout's n8 columns within the accumulator budget, K in
    whole k8 steps and the hidden width in whole 24-channel chunks; an
    11x11 output (blocks 13-16) in one or two tiles."""
    plan = fb.plan_f32(stride, 128, ho, ho, cin, ch, cout)
    assert (plan.th, plan.tw) == fb.pick_tile(f"s{stride}", ho, ho, cin, cout, ch, 128)
    assert 1 <= plan.th * plan.tw <= fb.F32_MAX_TILE and plan.th <= ho and plan.tw <= ho
    assert plan.smem == fb._f32_smem_bytes(stride, plan.th, plan.tw, cin, cout) <= fb.SMEM_LIMIT
    assert (plan.mw, plan.nw, plan.warps) in fb.F32_CONFIGS
    assert 4 * plan.mw * plan.nw <= fb.BF16_ACC_REGS
    m_tiles, n_tiles = -(-plan.th * plan.tw // 16), -(-cout // 8)
    warps_n = -(-n_tiles // plan.nw)
    assert warps_n <= plan.warps and plan.warps // warps_n * plan.mw >= m_tiles
    assert fb.F32_CHUNK % 8 == 0 and ch % fb.F32_CHUNK == 0
    tiles = -(-ho // plan.th) * -(-ho // plan.tw)
    if ho == 11:
        assert tiles <= 2


@pytest.mark.parametrize("stride,ho,cin,ch,cout", SERVED_BLOCKS)
def test_bf16_plan_fits_every_block_of_the_served_model(stride, ho, cin, ch, cout):
    """The bf16 kernel's plan: a tile of at most 256 pixels whose shared
    memory fits a Hopper block, a project warp grid that covers the tile's
    m16 rows and Cout's n8 columns within the accumulator budget, K and the
    hidden chunk in whole k16 steps; an 11x11 output (blocks 13-16, the
    widest weights, restaged whole by every tile) in one or two tiles."""
    plan = fb.plan_bf16(stride, 128, ho, ho, cin, ch, cout)
    assert (plan.th, plan.tw) == fb.pick_tile(f"s{stride}_bf16", ho, ho, cin, cout, ch, 128)
    assert 1 <= plan.th * plan.tw <= fb.BF16_MAX_TILE and plan.th <= ho and plan.tw <= ho
    assert plan.smem == fb._bf16_smem_bytes(stride, plan.th, plan.tw, cin, cout) <= fb.SMEM_LIMIT
    assert (plan.mw, plan.nw, plan.warps) in fb.BF16_CONFIGS
    assert 4 * plan.mw * plan.nw <= fb.BF16_ACC_REGS
    m_tiles, n_tiles = -(-plan.th * plan.tw // 16), -(-cout // 8)
    warps_n = -(-n_tiles // plan.nw)
    assert warps_n <= plan.warps and plan.warps // warps_n * plan.mw >= m_tiles
    assert fb.BF16_CHUNK % 16 == 0 and ch % fb.BF16_CHUNK == 0
    tiles = -(-ho // plan.th) * -(-ho // plan.tw)
    if ho == 11:
        assert tiles <= 2


def test_tf32_round_is_cvt_rna():
    """Round to nearest at tf32's 10 mantissa bits with ties away from zero
    (1 + 2^-11 goes up, where ties-to-even would keep 1), carries into the
    exponent, keeps the sign, leaves the 13 low bits zero; the split hi + lo
    is within 2^-21 of v."""
    u = 2.0 ** -10
    v = torch.tensor([1.0, 1.0 + u / 2, -(1.0 + u / 2), 1.0 + u / 2 - 2.0 ** -23, 2.0 - u / 4,
                      1.5 * u, 0.0, -3.0], dtype=torch.float32)
    want = torch.tensor([1.0, 1.0 + u, -(1.0 + u), 1.0, 2.0, 1.5 * u, 0.0, -3.0])
    assert torch.equal(fb.tf32_round(v), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(0, 10, 4096).astype(np.float32))
    hi = fb.tf32_round(r)
    assert not (hi.view(torch.int32) & 0x1FFF).any()
    assert float(((hi - r).abs() / r.abs()).max()) <= 2.0 ** -11
    lo = fb.tf32_round(r - hi)
    assert float(((hi.double() + lo.double() - r.double()).abs() / r.abs().double()).max()) <= 2.0 ** -21


def _block_tf32(args, residual, stride, passes):
    """The float32 block kernel's arithmetic in plain torch: both 1x1
    products by ``matmul_tf32x3`` (bias after the sum), the depthwise in
    float32."""
    x, w1, b1, wdw, bdw, w2, b2 = args
    b, h, w, cin = x.shape
    ch = w1.shape[1]
    hid = (fb.matmul_tf32x3(x.reshape(-1, cin), w1, passes) + b1).clamp(0.0, 6.0)
    d = torch.nn.functional.conv2d(hid.reshape(b, h, w, ch).permute(0, 3, 1, 2),
                                   wdw.permute(2, 0, 1)[:, None], bdw, stride=stride, padding=1,
                                   groups=ch).clamp(0.0, 6.0)
    o = fb.matmul_tf32x3(d.permute(0, 2, 3, 1).reshape(-1, ch), w2, passes) + b2
    o = o.reshape(b, h // stride, w // stride, -1)
    return o + x if residual else o


def _stem_tf32(args, passes):
    """The float32 stem kernel's arithmetic in plain torch: the stem as the
    kernel's implicit GEMM (the 27 taps of each hidden pixel in (ky, kx, c)
    order, zero-padded to K = 32, against k_stem as (27, Ch)) and the
    project, both by ``matmul_tf32x3`` (bias after the sum), the depthwise
    in float32."""
    x, k_stem, b_stem, wdw, bdw, w2, b2 = args
    b, h, w, _ = x.shape
    ch, ho, wo = k_stem.shape[-1], h // 2, w // 2
    cols = torch.nn.functional.unfold(x.permute(0, 3, 1, 2), 3, padding=1, stride=2)
    cols = cols.reshape(b, 3, 9, ho * wo).permute(0, 3, 2, 1).reshape(-1, 27)  # (ky, kx), c
    cols = torch.nn.functional.pad(cols, (0, 5))
    kmat = torch.nn.functional.pad(k_stem.reshape(27, ch), (0, 0, 0, 5))
    hid = (fb.matmul_tf32x3(cols, kmat, passes) + b_stem).clamp(0.0, 6.0)
    d = torch.nn.functional.conv2d(hid.reshape(b, ho, wo, ch).permute(0, 3, 1, 2),
                                   wdw.permute(2, 0, 1)[:, None], bdw, padding=1,
                                   groups=ch).clamp(0.0, 6.0)
    o = fb.matmul_tf32x3(d.permute(0, 2, 3, 1).reshape(-1, ch), w2, passes) + b2
    return o.reshape(b, ho, wo, -1)


@pytest.mark.parametrize("name,stride,h,cin,ch,cout,residual", [
    ("block16", 1, 11, 160, 960, 320, False),
    ("block13", 2, 22, 96, 576, 160, False),
    ("block2", 1, 11, 24, 144, 24, True),
    ("stem", None, 32, 3, 32, 16, False),
])
def test_three_tf32_passes_keep_float32_accuracy(name, stride, h, cin, ch, cout, residual):
    """At 121 output pixels and a served block's widths, the kernel's
    3xTF32 arithmetic sits within 5e-6 of the largest output from the
    float64 twin (float32's own rounding), while one TF32 pass misses the
    tolerance the card holds the kernel to against its twin
    (``F32_REL_TOL``): the reason for three passes. The stem case (``stride``
    None: the 27 -> 32 im2col stem product and the 32 -> 16 project at the
    served widths, 256 output pixels, ``_stem_tf32``) is held the same way
    (seen: 2.1e-7 with three passes, 4.7e-4 with one)."""
    rng = np.random.default_rng(cin + ch)
    if stride is None:
        draws = [((1, h, h, 3), 1.0), ((3, 3, 3, ch), 27 ** -0.5), ((ch,), 0.1),
                 ((3, 3, ch), 1 / 3), ((ch,), 0.1), ((ch, cout), ch ** -0.5), ((cout,), 0.1)]
        args = [torch.from_numpy(rng.normal(0, sc, shape).astype(np.float32))
                for shape, sc in draws]
        want = fb.stem_block0_reference(*[a.double() for a in args])
        scale = float(want.abs().max())
        errs = {passes: float((_stem_tf32(args, passes).double() - want).abs().max()) / scale
                for passes in (1, 3)}
        assert errs[3] <= 5e-6, errs
        assert errs[1] > fb.F32_REL_TOL, errs
        return
    draws = [((1, h, h, cin), 1.0), ((cin, ch), cin ** -0.5), ((ch,), 0.1), ((3, 3, ch), 1 / 3),
             ((ch,), 0.1), ((ch, cout), ch ** -0.5), ((cout,), 0.1)]
    args = [torch.from_numpy(rng.normal(0, sc, shape).astype(np.float32)) for shape, sc in draws]
    want = fb.inverted_residual_reference(*[a.double() for a in args], residual=residual,
                                          stride=stride)
    scale = float(want.abs().max())
    errs = {passes: float((_block_tf32(args, residual, stride, passes).double() - want).abs().max())
            / scale for passes in (1, 3)}
    assert errs[3] <= 5e-6, errs
    assert errs[1] > fb.F32_REL_TOL, errs


def test_bf16_config_covers_every_tile_up_to_96_pixels():
    """Any Cout up to MAX_COUT has a warp tiling for tiles of up to 6 m16
    tiles, so every shape the wrappers accept has a plan."""
    for cout in range(1, fb.MAX_COUT + 1):
        for pixels in (1, 16, 50, 96):
            mw, nw, warps = fb.warp_config(pixels, cout)
            assert 4 * mw * nw <= fb.BF16_ACC_REGS
    plan = fb.plan_bf16(2, 1, 5, 3, 20, 70, 30)  # ragged everything, a 5x3 output
    assert plan.th <= 5 and plan.tw <= 3


def _stem_args():
    """test_fused_stem_block0_matches_xla's draws (tests/test_pallas_fused.py:64):
    B, H, W, Ch, Cout = 2, 32, 40, 32, 16."""
    rng = np.random.default_rng(0)
    x = (rng.integers(0, 255, (2, 32, 40, 3)).astype(np.float32) / 255.0 - 0.5)
    args = (rng.normal(0, 0.3, (3, 3, 3, 32)), rng.normal(0, 0.1, (32,)),
            rng.normal(0, 0.2, (3, 3, 32)), rng.normal(0, 0.1, (32,)),
            rng.normal(0, 0.2, (32, 16)), rng.normal(0, 0.1, (16,)))
    return [x] + [a.astype(np.float32) for a in args]


@pytest.mark.parametrize("shape,residual,stride", [
    ((2, 16, 24, 24, 96, 24), True, 1),    # test_fused_s1_matches_xla
    ((2, 16, 24, 24, 96, 24), False, 1),
    ((1, 8, 11, 8, 48, 8), True, 1),       # test_fused_s1_unaligned_width
    ((2, 32, 48, 16, 96, 24), False, 2),   # test_fused_s2_matches_xla
    ((1, 44, 44, 8, 48, 16), False, 2),    # test_fused_s2_odd_tiles
    (None, False, None),                   # test_fused_stem_block0_matches_xla
])
def test_bf16_tolerance_admits_the_pallas_rounding_points(shape, residual, stride):
    """The Pallas kernels in bf16 (interpret mode): float32 hidden tensor and
    depthwise, the depthwise output rounded to bf16, one output rounding,
    the points the card's bf16 kernels round at (the stem's products of
    bf16 operands summed in float32). Against the bf16 twin they stay
    within BF16_REL_TOL of the largest output (seen: 0.3-0.5%), and both
    sit within it of the float32 twin."""
    if stride is None:
        args = _stem_args()
        jargs = [jnp.asarray(a, jnp.bfloat16) if a.ndim > 1 else jnp.asarray(a) for a in args]
        pallas = pallas_stem_block0(*jargs, interpret=True)
        assert pallas.dtype == jnp.bfloat16
        pallas = np.asarray(pallas.astype(jnp.float32))
        targs = [torch.from_numpy(a).to(torch.bfloat16) if a.ndim > 1 else torch.from_numpy(a)
                 for a in args]
        twin = fb.stem_block0_reference(*targs)
        assert twin.dtype == torch.bfloat16
        twin = twin.float().numpy()
        f32 = fb.stem_block0_reference(*map(torch.from_numpy, args)).numpy()
        scale = np.abs(twin).max()
        assert np.abs(pallas - twin).max() <= fb.BF16_REL_TOL * scale
        assert np.abs(pallas - f32).max() <= fb.BF16_REL_TOL * scale
        assert np.abs(twin - f32).max() <= fb.BF16_REL_TOL * scale
        return
    args = _block_args(0, *shape)
    jargs = [jnp.asarray(a, jnp.bfloat16) if a.ndim > 1 else jnp.asarray(a) for a in args]
    if stride == 1:
        pallas = fused_inverted_residual(*jargs, residual=residual, interpret=True)
    else:
        pallas = fused_inverted_residual_s2(*jargs, interpret=True)
    assert pallas.dtype == jnp.bfloat16
    pallas = np.asarray(pallas.astype(jnp.float32))
    targs = [torch.from_numpy(a).to(torch.bfloat16) if a.ndim > 1 else torch.from_numpy(a)
             for a in args]
    twin = fb.inverted_residual_reference(*targs, residual=residual, stride=stride)
    assert twin.dtype == torch.bfloat16
    twin = twin.float().numpy()
    f32 = fb.inverted_residual_reference(*map(torch.from_numpy, args), residual=residual,
                                         stride=stride).numpy()
    scale = np.abs(twin).max()
    assert np.abs(pallas - twin).max() <= fb.BF16_REL_TOL * scale
    assert np.abs(pallas - f32).max() <= fb.BF16_REL_TOL * scale
    assert np.abs(twin - f32).max() <= fb.BF16_REL_TOL * scale


# ------------------------------------------------------ the folded model --

@functools.cache
def _variables(variant: str):
    """(config, perturbed JAX variables) of the VOC, VOC + seg or slim50
    model at 64x64; the plain model is the seg init without its seg_*
    subtrees (flax seeds each leaf from its path)."""
    x = nhwc_input(11, (1, 64, 64, 3))
    if variant == "slim50":
        cfg = load_yaml(SLIM50_CONFIG)
        return cfg, perturb(jax_init(jax_build_model(cfg), x), seed=12, out_std=0.5)
    cfg = dict(load_yaml(VOC_CONFIG), seg={"num_classes": 4})
    variables = perturb(jax_init(jax_build_model(cfg), x), seed=12, out_std=0.5)
    if variant == "seg":
        return cfg, variables
    cfg = {k: v for k, v in cfg.items() if k != "seg"}
    return cfg, {col: {k: v for k, v in tree.items() if not k.startswith("seg_")}
                 for col, tree in variables.items()}


def _port(cfg, variables):
    return port_module(build_model(cfg, device="cpu"), variables)


@pytest.mark.parametrize("variant", ["voc", "slim50"])
def test_fold_batchnorm_matches_jax(variant):
    cfg, variables = _variables(variant)
    folded_jax = jax.tree_util.tree_map(np.asarray, jax_fold_batchnorm(variables))
    want = flax_to_state_dict(folded_jax)
    model = _port(cfg, variables)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = fold_batchnorm(model).state_dict()
    got = {k: v for k, v in got.items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    # the same float32 arithmetic, but XLA's CPU kernels may take 1/sqrt as
    # one reciprocal square root and contract ``beta - mean * factor`` into
    # one FMA: a value moves by an ulp or two (seen: 2.6e-7 relative on
    # weights, 7.5e-9 absolute on biases of ~0.05 where the subtraction
    # cancels)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)
    # the folded tree loads strict, and the model folded from is untouched
    port_module(build_model(cfg, device="cpu"), folded_jax)
    for key, value in model.state_dict().items():
        assert torch.equal(value, before[key]), key


@pytest.mark.parametrize("variant", ["voc", "seg", "slim50"])
def test_folded_heads_match_jax(variant):
    cfg, variables = _variables(variant)
    x = nhwc_input(13, (2, 64, 64, 3))
    jax_model = jax_build_model(cfg)
    want = jax_apply(jax_model, jax_fold_batchnorm(variables), x)
    model = _port(cfg, variables)
    folded = fold_batchnorm(model).eval()
    before = _launches()
    with torch.no_grad():
        got = folded(to_nchw(x))
        unfolded = model(to_nchw(x))
    assert _launches() == before
    assert set(got) == set(want) == set(unfolded)
    for key in want:
        np.testing.assert_allclose(to_nhwc(got[key]), want[key], **HEAD_TOL, err_msg=key)
        np.testing.assert_allclose(to_nhwc(got[key]), to_nhwc(unfolded[key]), **HEAD_TOL,
                                   err_msg=key)


def test_folded_predict_matches_jax():
    """The folded serving slice (``bench.py --fold-bn``'s path) against
    JAX's: keep exactly, the kept detections within 1e-5."""
    cfg, variables = _variables("voc")
    images, val_conf = nhwc_input(14, (2, 64, 64, 3)), 0.3
    want = jax_make_predict_fn(jax_build_model(cfg), cfg)(
        jax_fold_batchnorm(variables), jnp.asarray(images), jnp.float32(val_conf))
    want = [np.asarray(w) for w in want]
    predict = make_predict_fn(fold_batchnorm(_port(cfg, variables)), cfg)
    dets, keep = (t.numpy() for t in predict(torch.from_numpy(images), torch.tensor(val_conf)))
    np.testing.assert_array_equal(keep, want[1])
    assert 0 < keep.sum() < (dets[..., 4] > val_conf).sum()
    np.testing.assert_allclose(dets[keep], want[0][keep], atol=1e-5, rtol=1e-5)


def test_folded_model_raises_in_train_mode():
    cfg, variables = _variables("voc")
    folded = fold_batchnorm(_port(cfg, variables)).train()
    x = to_nchw(nhwc_input(15, (1, 64, 64, 3)))
    with pytest.raises(RuntimeError, match="eval mode only"):
        folded(x)
    with pytest.raises(RuntimeError, match="eval mode only"):  # a folded neck conv alone too
        folded.conv_for_S32(torch.zeros(1, folded.backbone.c5_features, 2, 2))


def test_build_model_places_on_the_card_by_default():
    cfg = load_yaml(VOC_CONFIG)
    if torch.cuda.is_available():
        assert next(build_model(cfg).parameters()).is_cuda
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(cfg)
    gen = torch.Generator().manual_seed(3)
    model = build_model(cfg, device="cpu", generator=gen)
    assert next(model.parameters()).device.type == "cpu"


def test_calibrate_bn_sets_the_batch_statistics():
    """From the seeded init every eval-mode score ties at 0.25; after
    calibration on one batch the scores spread, and every BatchNorm's
    running statistics are the mean and biased variance of its input in
    that batch (within 1e-5 of the input's scale: float32 sums against
    float64 ones)."""
    cfg = load_yaml(VOC_CONFIG)
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(0))
    images = torch.from_numpy(nhwc_input(31, (2, 64, 64, 3)))

    def scores():
        dets, _ = make_predict_fn(model, cfg)(images, torch.tensor(0.0))
        return dets[..., 4] * dets[..., 5]

    assert float((scores() - 0.25).abs().max()) < 1e-6
    bns = {name: m for name, m in model.named_modules() if isinstance(m, torch.nn.BatchNorm2d)}
    inputs = {}
    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: inputs.__setitem__(name, args[0].double()))
        for name, m in bns.items()]
    calibrate_bn(model, images)
    for hook in hooks:
        hook.remove()
    assert not model.training and len(inputs) == len(bns) == 66
    for name, bn in bns.items():
        x = inputs[name]
        mean, var = x.mean(dim=(0, 2, 3)), x.var(dim=(0, 2, 3), unbiased=False)
        assert float((bn.running_mean.double() - mean).abs().max()) <= 1e-5 * float(x.abs().max())
        assert float((bn.running_var.double() - var).abs().max()) <= 1e-5 * float(var.max())
        assert bn.momentum == BN_MOMENTUM and int(bn.num_batches_tracked) == 1
    assert float(scores().std()) > 1e-2
