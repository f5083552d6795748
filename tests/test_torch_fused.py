"""BatchNorm folding and the folded forward of the port against the JAX
package, on the CPU.

* The fused blocks' twins (``kernels/fused_block.py``) against
  ``xla_inverted_residual`` / ``xla_stem_block0`` at the shapes of
  ``tests/test_pallas_fused.py``, at its tolerances (1e-5 for the blocks,
  1e-4 for the stem); that file pins those references to the Pallas
  kernels. The twins are reached through the public wrappers, which run
  them for CPU tensors and count no launch.
* ``fold_batchnorm`` against JAX's: the folded state dicts are equal up to
  an ulp or two of float32.
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
from mobilenet_yolo_tpu.kernels.pallas_fused import xla_inverted_residual, xla_stem_block0
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.models.bn_fold import fold_batchnorm as jax_fold_batchnorm
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm

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
    """At 352x352 every block of the VOC backbone gets a tile of at most 64
    pixels whose shared memory fits a Hopper block; the stride-1 and
    stride-2 8x8 tiles of the wide maps, 4x11 at the 11x11 ones."""
    shapes = [("stem", 176, 176, 3, 16), ("s2", 88, 88, 16, 24), ("s1", 88, 88, 24, 24),
              ("s2", 44, 44, 24, 32), ("s1", 44, 44, 32, 32), ("s2", 22, 22, 32, 64),
              ("s1", 22, 22, 64, 64), ("s1", 22, 22, 64, 96), ("s1", 22, 22, 96, 96),
              ("s2", 11, 11, 96, 160), ("s1", 11, 11, 160, 160), ("s1", 11, 11, 160, 320)]
    for kind, ho, wo, cin, cout in shapes:
        th, tw = fb.pick_tile(kind, ho, wo, cin, cout)
        assert 1 <= th * tw <= fb.TILE_PIX and th <= ho and tw <= wo
        smem = (fb._stem_smem_bytes(th, tw, cout) if kind == "stem"
                else fb._block_smem_bytes(int(kind[1]), th, tw, cin, cout))
        assert smem <= fb.SMEM_LIMIT
    assert fb.pick_tile("s1", 88, 88, 24, 24) == (8, 8)
    assert fb.pick_tile("s2", 88, 88, 16, 24) == (8, 8)
    assert fb.pick_tile("s1", 11, 11, 160, 320) == (4, 11)


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
