"""The port's MBv2-YOLO modules against the JAX package's, on the CPU.

Same numpy inputs, weights from the JAX init through ``convert.py``, both
in eval mode and float32. Tolerance ``atol = rtol = 1e-4`` on activations
and head logits: the two frameworks sum the convolutions in different
orders, and over the ~60 layers of the full graph that moves float32
results by about 1e-6 of their size (measured 3e-7 absolute on logits of
magnitude 0.4); 1e-4 leaves room and still catches any mapping fault.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mobilenet_yolo_tpu.models.layers as jl
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.models.mobilenetv2 import MobileNetV2 as JaxMobileNetV2
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict, load_flax_variables
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models import layers as tl
from mobilenet_yolo_tpu_torch.models.mobilenetv2 import MobileNetV2

from _torch_parity import (SLIM50_CONFIG, VOC_CONFIG, jax_apply, jax_init,
                           load_yaml, nhwc_input, perturb, port_module,
                           to_nchw, to_nhwc)

TOL = dict(atol=1e-4, rtol=1e-4)


def _block_parity(jax_module, torch_module, x):
    variables = perturb(jax_init(jax_module, x), seed=1)
    want = jax_apply(jax_module, variables, x)
    port = port_module(torch_module, variables)
    with torch.no_grad():
        got = port(to_nchw(x))
    return want, got


@pytest.mark.parametrize("kernel,stride,depthwise,act", [
    (3, 2, False, "relu6"),   # the stem
    (3, 1, True, "leaky"),    # Connect / head dw
    (3, 2, True, "relu6"),    # stride-2 depthwise
    (1, 1, False, "none"),    # project
])
def test_conv_bn_act(kernel, stride, depthwise, act):
    x = nhwc_input(0, (2, 9, 10, 8))
    features = 8 if depthwise else 12
    want, got = _block_parity(
        jl.ConvBNAct(features, kernel, stride, depthwise, act),
        tl.ConvBNAct(8, features, kernel, stride, depthwise, act), x)
    assert want.shape == (2, -(-9 // stride), -(-10 // stride), features)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


@pytest.mark.parametrize("stride,in_ch,out_ch,expand,hidden", [
    (1, 16, 16, 6, None),   # identity residual
    (2, 16, 24, 6, None),   # stride 2, no residual
    (1, 16, 16, 1, None),   # no expand conv (block0)
    (1, 16, 16, 6, 40),     # pruned hidden width
])
def test_inverted_residual(stride, in_ch, out_ch, expand, hidden):
    x = nhwc_input(0, (2, 8, 8, in_ch))
    want, got = _block_parity(
        jl.InvertedResidual(out_ch, stride, expand, hidden_features=hidden),
        tl.InvertedResidual(in_ch, out_ch, stride, expand, hidden_features=hidden), x)
    np.testing.assert_allclose(to_nhwc(got), want, **TOL)


def test_mobilenetv2_taps():
    x = nhwc_input(0, (2, 64, 64, 3))
    want, got = _block_parity(JaxMobileNetV2(width_mult=0.5),
                              MobileNetV2(width_mult=0.5), x)
    for w, g, stride in zip(want, got, (16, 32)):
        assert w.shape[1:3] == (64 // stride, 64 // stride)
        np.testing.assert_allclose(to_nhwc(g), w, **TOL)


def test_upsample_and_part_add_match_jax():
    rng = np.random.default_rng(0)
    x = rng.normal(size=(2, 3, 4, 5)).astype(np.float32)
    y = rng.normal(size=(2, 3, 4, 7)).astype(np.float32)
    np.testing.assert_array_equal(
        to_nhwc(tl.upsample_nearest2x(to_nchw(x))),
        np.asarray(jl.upsample_nearest2x(jnp.asarray(x))))
    for a, b in ((x, y), (y, x), (x, x)):
        np.testing.assert_array_equal(
            to_nhwc(tl.part_add(to_nchw(a), to_nchw(b))),
            np.asarray(jl.part_add(jnp.asarray(a), jnp.asarray(b))))
    for v in (32 * 0.35, 1280 * 1.4, 8, 3):
        assert tl.make_divisible(v, 8) == jl.make_divisible(v, 8)


@pytest.fixture(scope="module")
def seg_variables():
    """One JAX init of the seg model; flax seeds each leaf from its path, so
    dropping the ``seg_*`` subtrees gives the plain model's own init."""
    cfg = dict(load_yaml(VOC_CONFIG), seg={"num_classes": 4})
    x = nhwc_input(1)
    return perturb(jax_init(jax_build_model(cfg), x), seed=2, out_std=0.5)


def _without_seg(variables):
    return {col: {k: v for k, v in tree.items() if not k.startswith("seg_")}
            for col, tree in variables.items()}


@pytest.mark.parametrize("variant", ["plain", "seg", "slim50"])
def test_mbv2_yolo_heads(variant, seg_variables):
    x = nhwc_input(1)
    if variant == "slim50":
        cfg = load_yaml(SLIM50_CONFIG)
        variables = perturb(jax_init(jax_build_model(cfg), x), seed=2, out_std=0.5)
    elif variant == "seg":
        cfg = dict(load_yaml(VOC_CONFIG), seg={"num_classes": 4})
        variables = seg_variables
    else:
        cfg = load_yaml(VOC_CONFIG)
        variables = _without_seg(seg_variables)
    want = jax_apply(jax_build_model(cfg), variables, x)
    port = port_module(build_model(cfg, device="cpu"), variables)
    assert sum(p.numel() for p in port.parameters()) == sum(
        v.size for v in jax.tree_util.tree_leaves(variables["params"]))
    with torch.no_grad():
        got = port(to_nchw(x))
    assert set(got) == set(want) == ({"out0", "out1", "seg"} if variant == "seg"
                                     else {"out0", "out1"})
    for key in want:
        np.testing.assert_allclose(to_nhwc(got[key]), want[key], **TOL)


def test_full_voc_model_size():
    """4.97 M values in 334 flax leaves (params plus BN statistics) at the
    VOC contract, each leaf one torch state_dict entry."""
    state = build_model(load_yaml(VOC_CONFIG), device="cpu").state_dict()
    leaves = [v for k, v in state.items() if not k.endswith("num_batches_tracked")]
    assert len(leaves) == 334
    assert round(sum(v.numel() for v in leaves) / 1e6, 2) == 4.97


def test_converter_maps_layout_and_loads_strict():
    kernel = np.arange(54, dtype=np.float32).reshape(3, 3, 1, 6)  # depthwise HWIO
    state = flax_to_state_dict({"params": {"blk": {"conv": {"kernel": kernel}}}})
    assert state["blk.conv.weight"].shape == (6, 1, 3, 3)
    np.testing.assert_array_equal(state["blk.conv.weight"][2, 0].numpy(), kernel[:, :, 0, 2])

    x = nhwc_input(0, (1, 6, 6, 4))
    module = jl.ConvBNAct(5, 3)
    variables = perturb(jax_init(module, x), seed=3)
    port = load_flax_variables(tl.ConvBNAct(4, 5, 3), variables)
    assert int(port.bn.num_batches_tracked) == 0
    np.testing.assert_array_equal(port.bn.running_var.numpy(),
                                  variables["batch_stats"]["bn"]["var"])

    missing = {"params": variables["params"]}
    with pytest.raises(RuntimeError, match="running_mean"):
        load_flax_variables(tl.ConvBNAct(4, 5, 3), missing)
    extra = {"params": dict(variables["params"], stray={"kernel": np.zeros((1, 1, 1, 1))}),
             "batch_stats": variables["batch_stats"]}
    with pytest.raises(RuntimeError, match="stray"):
        load_flax_variables(tl.ConvBNAct(4, 5, 3), extra)
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax_variables(tl.ConvBNAct(4, 6, 3), variables)
    with pytest.raises(KeyError, match="no torch counterpart"):
        flax_to_state_dict({"params": {"blk": {"embedding": np.zeros(3)}}})


@pytest.mark.parametrize("backbone", ["mbv3", "mbv3_macc"])
def test_full_voc_mbv3_model_sizes(backbone):
    """The full-width VOC MBv3 graphs have the JAX package's parameter
    counts (flax trees from ``jax.eval_shape`` of the init: no compile)."""
    import jax
    from mobilenet_yolo_tpu.models import build_model as jax_build_model

    cfg = load_yaml(VOC_CONFIG)
    jm = jax_build_model(cfg, backbone)
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            np.zeros((1, 64, 64, 3), np.float32), train=False))
    want = sum(int(np.prod(a.shape)) for a in jax.tree_util.tree_leaves(shapes["params"]))
    model = build_model(cfg, backbone=backbone, device="cpu")
    assert sum(p.numel() for p in model.parameters()) == want


# ---------------------------------------------------------------- remat

REMAT_CFG = {"yolo": {"num_classes": 3, "num_anchors": 3}}


def test_remat_state_dict_and_forward_identical():
    """The port of ``tests/test_remat.py:44``: ``config["remat"]`` keeps the
    plain model's state-dict keys and values (one seed) and its forward, in
    eval mode and in train mode with autograd recording (the remat path)."""
    x = torch.from_numpy(nhwc_input(0, (2, 64, 64, 3))).permute(0, 3, 1, 2)
    plain = build_model(REMAT_CFG, device="cpu", generator=torch.Generator().manual_seed(0))
    remat = build_model({**REMAT_CFG, "remat": True}, device="cpu",
                        generator=torch.Generator().manual_seed(0))
    assert remat.backbone.remat and not plain.backbone.remat
    want, got = plain.state_dict(), remat.state_dict()
    assert list(want) == list(got)
    for key in want:
        assert torch.equal(want[key], got[key]), key
    with torch.no_grad():
        out_p, out_r = plain.eval()(x), remat.eval()(x)
    for key in out_p:
        assert torch.equal(out_p[key], out_r[key]), key
    out_p, out_r = plain.train()(x), remat.train()(x)
    for key in out_p:
        assert torch.equal(out_p[key], out_r[key]), key


def _remat_pair(dtype=torch.float64):
    plain = MobileNetV2(width_mult=0.35, dtype=dtype, generator=torch.Generator().manual_seed(0))
    remat = MobileNetV2(width_mult=0.35, remat=True, dtype=dtype)
    remat.load_state_dict(plain.state_dict())
    return plain.train(), remat.train()


def test_remat_gradients_match_in_float64():
    """The port of ``tests/test_remat.py:58``: gradients of the train-mode
    taps, float64, within 1e-7 of each leaf's largest."""
    x = torch.from_numpy(nhwc_input(1, (2, 64, 64, 3))).permute(0, 3, 1, 2).double()
    grads = []
    for model in _remat_pair():
        c4, c5 = model(x)
        loss = c4.square().sum() + c5.square().sum()
        grads.append(dict(zip([n for n, _ in model.named_parameters()],
                              torch.autograd.grad(loss, list(model.parameters())))))
    assert list(grads[0]) == list(grads[1])
    for name, gp in grads[0].items():
        err = float((gp - grads[1][name]).abs().max() / (gp.abs().max() + 1e-12))
        assert err < 1e-7, (name, err)


def test_remat_backward_leaves_batchnorm_buffers_as_the_plain_model():
    """The recompute in the backward must not move a running statistic or
    count a batch again (flax's ``nn.remat`` does neither): after one
    forward and backward the BN buffers equal the plain model's exactly
    and every ``num_batches_tracked`` is 1. A plain ``checkpoint`` fails
    here (two updates, two counts)."""
    x = torch.from_numpy(nhwc_input(2, (2, 64, 64, 3))).permute(0, 3, 1, 2).double()
    states = []
    for model in _remat_pair():
        c4, c5 = model(x)
        (c4.sum() + c5.square().sum()).backward()
        states.append(model.state_dict())
    for key, want in states[0].items():
        assert torch.equal(states[1][key], want), key
        if key.endswith("num_batches_tracked"):
            assert int(want) == 1, key
