"""The port's MobileNetV3 family against the JAX package's, on the CPU.

64x64 input, batch 2, 4 classes. The weights are the port's seeded init
written as a flax tree (``convert.state_dict_to_flax``), held equal in
structure and shape to JAX's own init (``jax.eval_shape``, no compile) and
perturbed as ``_torch_parity.perturb`` does; both sides then run them. Each
JAX detector graph is compiled once per module and mode (eval with the
backbone's taps captured, train with the ``batch_stats`` update): the tests
take their parts.

Tolerances, stated where they are used: float32 forwards agree to float32
rounding summed in other orders (``F32``); train-mode BatchNorm over few
values (the SE module's pooled (B, C, 1, 1) tensor: B = 2 values a channel)
amplifies that rounding, so train-mode outputs are held relative to the
largest output; the whole step runs in float64 on both sides.
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobilenet_yolo_tpu.eval.detector import make_predict_fn as jax_make_predict_fn
from mobilenet_yolo_tpu.models import MobileNetV3Small as JaxMobileNetV3Small
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.models import layers as jl
from mobilenet_yolo_tpu.models.bn_fold import fold_batchnorm as jax_fold_batchnorm
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu_torch.convert import (flax_to_state_dict, load_flax_variables,
                                              state_dict_to_flax)
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.models import (MBv3YOLO, MBv3YOLOMacc, MobileNetV3Large,
                                             MobileNetV3Small, build_model)
from mobilenet_yolo_tpu_torch.models import layers as tl
from mobilenet_yolo_tpu_torch.models import mobilenetv2
from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm
from mobilenet_yolo_tpu_torch.train import create_train_state, make_train_step

from _torch_parity import (SMALL_YOLO_CONFIG, jax_train_state, nhwc_input, padded_gt, perturb,
                           state_dict_of, to_nchw, to_nhwc)

CFG = dict(SMALL_YOLO_CONFIG, yolo=dict(SMALL_YOLO_CONFIG["yolo"], num_classes=4))
# float32 forwards, eval mode: the same products summed in other orders
F32 = dict(rtol=1e-5, atol=1e-5)
# train-mode outputs relative to the largest: BatchNorm over 2-8 values a
# channel (the SE module's, and the 2x2 S32 maps at batch 2) divides by a
# batch standard deviation that float32 rounding moves
TRAIN_REL = 1e-4


def _flax_tree_of(port: torch.nn.Module, seed: int, out_std: float = 0.05) -> dict:
    """The port's weights as a perturbed flax tree, loaded back into the port."""
    variables = perturb(state_dict_to_flax(port.state_dict()), seed=seed, out_std=out_std)
    load_flax_variables(port, variables)
    return variables


def _shapes(tree) -> dict:
    return jax.tree_util.tree_map(lambda a: tuple(a.shape), tree)


def _assert_same_tree(jax_module, x, variables: dict) -> None:
    """The flax tree from the port has JAX's own init's keys and shapes."""
    want = jax.eval_shape(lambda: jax_module.init(jax.random.PRNGKey(0), x, train=False))
    assert _shapes(dict(want)) == _shapes(variables)


def _rel(got, want) -> float:
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------- activations


def test_hswish_and_hsigmoid_match_jax():
    """Equal bit for bit on a grid through the kinks at -3 and 3: the same
    float32 operations in the same order (not ``F.hardswish``)."""
    x = np.concatenate([np.linspace(-5, 5, 2001, dtype=np.float32),
                        np.float32([-3.0, 3.0, np.nextafter(-3, 0), np.nextafter(3, 0),
                                    np.nextafter(-3, -4), np.nextafter(3, 4), 0.0, -0.0])])
    for jf, tf in ((jl.hswish, tl.hswish), (jl.hsigmoid, tl.hsigmoid)):
        want = np.asarray(jax.jit(jf)(x))
        np.testing.assert_array_equal(tf(torch.from_numpy(x)).numpy(), want)
    assert tl.ACTIVATIONS["hswish"] is tl.hswish


# ------------------------------------------------------------------ blocks

# (Cin, kernel, expand, Cout, act, SE, stride, hidden override)
BLOCKS = {
    "k3_s1_identity_relu": (16, 3, 48, 16, "relu", False, 1, None),
    "k5_s2_se_hswish": (16, 5, 64, 24, "hswish", True, 2, None),
    "k3_s1_shortcut_se_hswish": (16, 3, 72, 24, "hswish", True, 1, None),
    "k5_s1_hidden_override": (24, 5, 96, 24, "relu", True, 1, 37),
}


def _block_pair(name: str, seed: int):
    cin, k, e, c, act, se, s, hidden = BLOCKS[name]
    port = tl.MBv3Block(cin, k, e, c, act, se, s, hidden,
                        generator=torch.Generator().manual_seed(seed))
    jm = jl.MBv3Block(k, e, c, act, se, s, hidden_features=hidden)
    return port, jm, cin


def _run_pair(port, jm, variables, x, train: bool):
    """Both sides on ``x``: outputs, and in train mode the port's state dict
    and JAX's new batch statistics."""
    if train:
        want, new = jax.jit(lambda v, x: jm.apply(v, x, train=True, mutable=["batch_stats"]))(
            variables, x)
        got = port.train()(to_nchw(x))
        return to_nhwc(got), np.asarray(want), port.state_dict(), new["batch_stats"]
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port.eval()(to_nchw(x))
    return to_nhwc(got), np.asarray(want), None, None


def _assert_stats64(state: dict, new_stats) -> None:
    """Running statistics after a float64 train-mode pass, each within 1e-9
    of its vector's largest value."""
    for key, want in state_dict_of("batch_stats", new_stats).items():
        np.testing.assert_allclose(state[key].numpy(), want, rtol=1e-9,
                                   atol=1e-9 * np.abs(want).max(), err_msg=key)


def _assert_stats(state: dict, new_stats, tol: float = 1e-6) -> None:
    """Running statistics after one train-mode forward: float32 batch moments
    in other orders, within ``tol`` of each statistic's scale."""
    for key, want in state_dict_of("batch_stats", new_stats).items():
        got = state[key].numpy()
        np.testing.assert_allclose(got, want, atol=tol * max(1.0, np.abs(want).max()),
                                   rtol=1e-5, err_msg=key)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
@pytest.mark.parametrize("name", list(BLOCKS))
def test_mbv3_block_matches_jax(name, train):
    """Each bneck form (k3/k5, stride 1/2, SE on/off, the 1x1 conv-BN
    shortcut, relu/hswish, a hidden override), eval and train mode; in
    train mode the running statistics too (the SE BNs see 2 values a
    channel, the n/(n-1) rescale at its largest)."""
    port, jm, cin = _block_pair(name, seed=1)
    x = nhwc_input(2, (2, 16, 16, cin))
    variables = _flax_tree_of(port, seed=3)
    _assert_same_tree(jm, x, variables)
    assert (port.shortcut is not None) == (name == "k3_s1_shortcut_se_hswish")
    got, want, state, new_stats = _run_pair(port, jm, variables, x, train)
    assert got.shape == want.shape
    if train:
        assert _rel(got, want) < TRAIN_REL
        _assert_stats(state, new_stats)
    else:
        np.testing.assert_allclose(got, want, **F32)


@pytest.mark.parametrize("train", [False, True], ids=["eval", "train"])
def test_se_module_matches_jax(train):
    port = tl.SEModule(32, generator=torch.Generator().manual_seed(4))
    jm = jl.SEModule()
    x = nhwc_input(5, (2, 8, 8, 32))
    variables = _flax_tree_of(port, seed=6)
    _assert_same_tree(jm, x, variables)
    got, want, state, new_stats = _run_pair(port, jm, variables, x, train)
    if train:
        assert _rel(got, want) < TRAIN_REL
        _assert_stats(state, new_stats)
    else:
        np.testing.assert_allclose(got, want, **F32)


def test_batch_of_one_in_train_mode_matches_flax():
    """B = 1 in train mode: the SE BNs see one value a channel. Flax
    normalises with variance 0 (the output is the BN bias) and moves the
    running variance toward 0, where torch's own BatchNorm raises. The
    port matches flax: outputs, running statistics, one counted batch, and
    a gradient that flows (to the BN bias, not through the zero-variance
    normalisation)."""
    port, jm, cin = _block_pair("k5_s2_se_hswish", seed=7)
    x = nhwc_input(8, (1, 16, 16, cin))
    variables = _flax_tree_of(port, seed=9)
    got, want, state, new_stats = _run_pair(port, jm, variables, x, train=True)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    _assert_stats(state, new_stats)
    assert int(state["se.fc1.bn.num_batches_tracked"]) == 1
    old_var = variables["batch_stats"]["se"]["fc1"]["bn"]["var"]
    np.testing.assert_allclose(state["se.fc1.bn.running_var"].numpy(), 0.9 * old_var, rtol=1e-6)
    out = port.train()(to_nchw(x))
    out.sum().backward()
    assert port.se.fc2.bn.bias.grad.abs().sum() > 0
    assert float(port.se.fc2.bn.weight.grad.abs().max()) == 0.0


# ---------------------------------------------------------------- backbones


def test_mobilenetv3_small_taps_match_jax():
    port = MobileNetV3Small(generator=torch.Generator().manual_seed(10))
    jm = JaxMobileNetV3Small()
    x = nhwc_input(11)
    variables = _flax_tree_of(port, seed=12)
    _assert_same_tree(jm, x, variables)
    want = jax.jit(lambda v, x: jm.apply(v, x, train=False))(variables, x)
    with torch.no_grad():
        got = port.eval()(to_nchw(x))
    assert (port.c4_features, port.c5_features) == (48, 576)
    for g, w in zip(got, want):
        assert g.shape[1] == w.shape[-1]
        np.testing.assert_allclose(to_nhwc(g), np.asarray(w), **F32)


# ---------------------------------------------------------------- detectors


@pytest.fixture(scope="module", params=["mbv3", "mbv3_macc"])
def detector(request):
    """One compile per mode of each JAX detector at 64x64, batch 2: eval in
    float32 (the heads, with the backbone's taps captured) and train in
    float64 (the heads and the new ``batch_stats``: float64, so that the
    BatchNorms over 2-8 values a channel compare to 1e-9 and not to their
    amplified float32 rounding)."""
    backbone = request.param
    jm = jax_build_model(CFG, backbone)
    port = build_model(CFG, backbone, device="cpu", generator=torch.Generator().manual_seed(20))
    x = nhwc_input(21)
    variables = _flax_tree_of(port, seed=22)

    def taps(module, method):
        return module.name == "backbone" and method == "__call__"

    heads, inter = jax.jit(lambda v, x: jm.apply(v, x, train=False, capture_intermediates=taps,
                                                 mutable=["intermediates"]))(variables, x)
    with jax.enable_x64(True):
        jm64 = jax_build_model(CFG, backbone, dtype=jnp.float64)
        train_heads, new = jax.jit(lambda v, x: jm64.apply(v, x, train=True,
                                                           mutable=["batch_stats"]))(
            _float64(variables), x.astype(np.float64))
        train_heads, new = _float64(train_heads), _float64(new)
    np_tree = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return {"backbone": backbone, "jm": jm, "port": port, "x": x, "variables": variables,
            "heads": np_tree(heads), "taps": np_tree(inter["intermediates"]["backbone"]
                                                     ["__call__"][0]),
            "train_heads": train_heads, "batch_stats": new["batch_stats"]}


def _float64(tree):
    return jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64), tree)


def test_detector_loads_jax_tree_strict(detector):
    """The JAX init's tree loads ``strict=True`` with equal parameter counts,
    and the port's state dict written back is that tree."""
    jm, x, variables = detector["jm"], detector["x"], detector["variables"]
    _assert_same_tree(jm, x, variables)
    port = build_model(CFG, detector["backbone"], device="cpu")
    load_flax_variables(port, variables)
    n_jax = sum(a.size for a in jax.tree_util.tree_leaves(variables["params"]))
    assert sum(p.numel() for p in port.parameters()) == n_jax
    back = state_dict_to_flax(port.state_dict())
    assert jax.tree_util.tree_all(jax.tree_util.tree_map(np.array_equal, back, variables))


def test_detector_heads_and_taps_match_jax(detector):
    port, x = detector["port"], detector["x"]
    with torch.no_grad():
        got = port.eval()(to_nchw(x))
        taps = port.backbone(to_nchw(x))
    assert set(got) == set(detector["heads"]) == {"out0", "out1"}
    for key, want in detector["heads"].items():
        assert got[key].shape[1] == 3 * (5 + 4)
        np.testing.assert_allclose(to_nhwc(got[key]), want, **F32)
    want_c4, want_c5 = detector["taps"]
    assert want_c4.shape == (2, 4, 4, 160) and want_c5.shape[1:3] == (2, 2)
    np.testing.assert_allclose(to_nhwc(taps[0]), want_c4, **F32)
    np.testing.assert_allclose(to_nhwc(taps[1]), want_c5, **F32)


def test_detector_train_mode_batch_stats_match_jax(detector):
    """One train-mode forward in float64: heads within 1e-9 of the largest,
    and every running statistic within 1e-9 of its vector's largest (the SE
    BNs normalise 2 values a channel, the S32 BNs 8, so float64 rounding is
    amplified too). ``connect_for_S16`` of ``MBv3YOLO`` runs twice, so its
    BatchNorm statistics move twice, one update after the other, and count
    two batches."""
    port = copy.deepcopy(detector["port"]).double().train()
    got = port(to_nchw(detector["x"]).double())
    for key, want in detector["train_heads"].items():
        assert _rel(to_nhwc(got[key]), want) < 1e-9, key
    state = port.state_dict()
    _assert_stats64(state, detector["batch_stats"])
    twice = 2 if detector["backbone"] == "mbv3" else 1
    assert int(state["connect_for_S16.dw.bn.num_batches_tracked"]) == twice
    assert int(state["backbone.stem.bn.num_batches_tracked"]) == 1


def test_fold_batchnorm_matches_jax(detector):
    """``fold_batchnorm`` covers the SE convs and the shortcut: the folded
    state dict is JAX's folded tree (an ulp or two of XLA's rsqrt and FMA,
    as ``tests/test_torch_fused.py`` states), the folded heads match the
    unfolded ones, and the folded MobileNetV3 runs as biased convs: it never
    reaches the MobileNetV2 fused kernels."""
    variables, port, x = detector["variables"], detector["port"], detector["x"]
    want = flax_to_state_dict(jax.tree_util.tree_map(np.asarray,
                                                     jax.jit(jax_fold_batchnorm)(variables)))
    folded = fold_batchnorm(port).eval()
    got = {k: v for k, v in folded.state_dict().items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    assert any(".se.fc1." in k for k in got) and any(".shortcut." in k for k in got)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-6, atol=1e-7,
                                   err_msg=key)

    def refuse(*args, **kwargs):
        raise AssertionError("a folded MobileNetV3 reached a MobileNetV2 fused kernel")

    with pytest.MonkeyPatch.context() as mp:
        for name in ("fused_inverted_residual", "fused_inverted_residual_s2",
                     "fused_stem_block0"):
            mp.setattr(mobilenetv2, name, refuse)
        with torch.no_grad():
            got_heads = folded(to_nchw(x))
    for key, want_heads in detector["heads"].items():
        np.testing.assert_allclose(to_nhwc(got_heads[key]), want_heads, rtol=1e-4,
                                   atol=1e-4 * np.abs(want_heads).max())


def test_predict_matches_jax(detector):
    """``make_predict_fn`` on MBv3 against JAX's: ``keep`` equal, kept
    detections within 1e-5 (exp and sigmoid differ in the last bits between
    XLA and torch). The ``out`` convs are redrawn at std 1 so the scores
    spread and boxes overlap: NMS cuts some of the candidates above the
    gate in both graphs."""
    jm = detector["jm"]
    port = build_model(CFG, detector["backbone"], device="cpu")
    variables = perturb(detector["variables"], seed=26, out_std=1.0)
    load_flax_variables(port, variables)
    images, val_conf = nhwc_input(24), 0.3
    want = [np.asarray(w) for w in jax_make_predict_fn(jm, CFG)(
        variables, jnp.asarray(images), jnp.float32(val_conf))]
    dets, keep = (t.numpy() for t in make_predict_fn(port.eval(), CFG)(
        torch.from_numpy(images), torch.tensor(val_conf)))
    np.testing.assert_array_equal(keep, want[1])
    assert 0 < keep.sum() < (dets[..., 4] > val_conf).sum()
    np.testing.assert_allclose(dets[keep], want[0][keep], atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------- build_model


def test_build_model_contract(monkeypatch):
    """Both MBv3 graphs build on the CPU when asked, the card by default
    (raising without one), draw the init on the generator's device, take the
    ``prune:`` block (a hidden override, and a head width on MACC-lite
    only) and ``remat``; ``backbone_head`` on ``mbv3`` raises JAX's error."""
    pruned = dict(CFG, prune={"backbone_hidden": [None, 24, 40] + [None] * 11 + [200],
                              "backbone_head": 640})
    with pytest.raises(ValueError, match="backbone_head is not prunable for mbv3") as port_err:
        build_model(pruned, "mbv3", device="cpu")
    with pytest.raises(ValueError) as jax_err:
        jax_build_model(pruned, "mbv3")
    assert str(port_err.value) == str(jax_err.value)
    macc = build_model(pruned, "mbv3_macc", device="cpu")
    assert isinstance(macc, MBv3YOLOMacc) and isinstance(macc.backbone, MobileNetV3Large)
    assert macc.backbone.bneck1.expand.conv.out_channels == 24
    assert macc.backbone.bneck2_1.expand.conv.out_channels == 200
    assert macc.backbone.head_conv.conv.out_channels == 640
    assert macc.conv_for_S32.conv.in_channels == 640
    plain = build_model(CFG, "mbv3", device="cpu", generator=torch.Generator().manual_seed(0))
    again = build_model(CFG, "mbv3", device="cpu", generator=torch.Generator().manual_seed(0))
    assert isinstance(plain, MBv3YOLO) and not plain.backbone.remat
    assert all(torch.equal(a, b) for a, b in zip(plain.state_dict().values(),
                                                 again.state_dict().values()))
    assert build_model(dict(CFG, remat=True), "mbv3", device="cpu").backbone.remat
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for backbone in ("mbv3", "mbv3_macc"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            build_model(CFG, backbone)
    with pytest.raises(ValueError, match="unknown backbone"):
        build_model(CFG, "mbv4", device="cpu")


# ---------------------------------------------------------------- remat


def _remat_models(dtype=torch.float64):
    plain = build_model(CFG, "mbv3", device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(30))
    remat = build_model(dict(CFG, remat=True), "mbv3", device="cpu", dtype=dtype,
                        generator=torch.Generator().manual_seed(30))
    return plain.train(), remat.train()


def test_remat_forward_state_dict_and_gradients_identical():
    """``remat`` keeps the plain model's state-dict keys and values (one
    seed) and its train-mode forward exactly; the gradients agree within
    1e-7 of each leaf's largest in float64 (only the backward's schedule
    differs), and the recompute moves no BatchNorm buffer: after the
    backward the buffers equal the plain model's, each batch counted once."""
    x = to_nchw(nhwc_input(31)).double()
    plain, remat = _remat_models()
    assert list(plain.state_dict()) == list(remat.state_dict())
    assert all(torch.equal(a, b) for a, b in zip(plain.state_dict().values(),
                                                 remat.state_dict().values()))
    grads, states, outs = [], [], []
    for model in (plain, remat):
        out = model(x)
        outs.append(out)
        loss = sum(v.square().sum() for v in out.values())
        grads.append(torch.autograd.grad(loss, list(model.parameters())))
        states.append(model.state_dict())
    for key in outs[0]:
        assert torch.equal(outs[0][key], outs[1][key]), key
    for name, gp, gr in zip([n for n, _ in plain.named_parameters()], *grads):
        assert float((gp - gr).abs().max() / (gp.abs().max() + 1e-12)) < 1e-7, name
    for key, want in states[0].items():
        assert torch.equal(states[1][key], want), key


# ---------------------------------------------------------------- the step


def test_train_step_matches_jax_in_float64():
    """One ``make_train_step`` step of MBv3-YOLO at 32x32, batch 2, float64
    on both sides. The JAX step runs with ``optax.sgd(1.0)``, so its
    parameter change is minus the gradient: the loss (float32 in both
    packages, rtol 1e-6), every gradient (atol 1e-5 of the leaf's largest
    plus 1e-12, or 1e-13 of the network's largest where that is larger: the
    leaves whose gradient is zero in exact arithmetic, as
    ``tests/test_torch_train.py`` explains) and the BatchNorm statistics
    (within 1e-9 of each vector's largest: at 32x32 the S32 BNs normalise
    2 values a channel) come from one compile."""
    port = build_model(CFG, "mbv3", device="cpu", generator=torch.Generator().manual_seed(40))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       _flax_tree_of(port, seed=41))
    rng = np.random.default_rng(42)
    x = rng.normal(0, 1, (2, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [3, 1], 5, num_classes=4)
    with jax.enable_x64(True):
        jm = jax_build_model(CFG, "mbv3", dtype=jnp.float64)
        sgd = optax.sgd(1.0)
        step = j_step.make_train_step(jm, CFG, sgd, donate=False)
        stepped, want_metrics = step(jax_train_state(variables, sgd), x, gt, n_gt)
        grads = jax.tree_util.tree_map(lambda p, q: np.asarray(p) - np.asarray(q),
                                       variables["params"], stepped.params)
    model = build_model(CFG, "mbv3", device="cpu", dtype=torch.float64)
    load_flax_variables(model, variables)
    state = create_train_state(model)
    _, metrics = make_train_step(model, CFG)(state, torch.from_numpy(x), torch.from_numpy(gt),
                                             torch.from_numpy(n_gt))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_metrics["loss"]), rtol=1e-6)
    want_grads = state_dict_of("params", grads)
    scale = max(float(np.abs(g).max()) for g in want_grads.values())
    params = dict(model.named_parameters())
    for key, want in want_grads.items():
        atol = max(1e-5 * np.abs(want).max() + 1e-12, 1e-13 * scale)
        np.testing.assert_allclose(params[key].grad.numpy(), want, atol=atol, err_msg=key)
    _assert_stats64(model.state_dict(), stepped.batch_stats)
