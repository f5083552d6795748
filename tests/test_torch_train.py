"""The port's training slice against the JAX package's, on the CPU.

Op-level checks run in float32: BatchNorm's running statistics, the
straight-through sigmoid, CIoU/GIoU, target assignment, the losses, AdamW
and the schedule, each with its tolerance stated where it is used.

The two whole-step checks (``make_train_step``, and
``make_geometry_train_step`` with the plain augmentation) run in float64
on both sides (``jax.enable_x64`` and a float64 port model). At this test
size (width 0.35, 32x32, batch 4, so the deepest layers see 1x1 maps)
train-mode BatchNorm over 4 values amplifies float32 rounding ~1e3-fold in
the backward: two correct float32 implementations disagree by 10-30% on
stem gradients, while in float64 every gradient of size agrees to ~1e-9.
The YOLO loss itself stays float32 in both packages (``step.py:145-146``),
so the loss agrees to float32 rounding.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.ops import assign as j_assign
from mobilenet_yolo_tpu.ops import boxes as j_boxes
from mobilenet_yolo_tpu.ops import losses as j_losses
from mobilenet_yolo_tpu.ops.sigmoid_st import sigmoid_st as j_sigmoid_st
from mobilenet_yolo_tpu.train import schedule as j_schedule
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu_torch.convert import load_flax_variables
from mobilenet_yolo_tpu_torch.models import layers as tl
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.ops import assign, boxes, losses
from mobilenet_yolo_tpu_torch.ops.sigmoid_st import sigmoid_st
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            learning_rate_for_epoch, make_eval_step,
                                            make_geometry_train_step, make_train_step)
from mobilenet_yolo_tpu_torch.train.state import make_optimizer

from _torch_parity import (SMALL_YOLO_CONFIG, geometry_batch, padded_gt, state_dict_of,
                           width035_variables64)
from _torch_parity import assert_bn_stats_match as _assert_bn_stats_match
from _torch_parity import float64_pair as _pair
from _torch_parity import jax_train_state as _jax_state


def _t(x, requires_grad=False):
    return torch.tensor(np.asarray(x), requires_grad=requires_grad)


# ---------------------------------------------------------------- BatchNorm


def _bn_case(seed=0):
    rng = np.random.default_rng(seed)
    # N*H*W = 2*2*2 = 8 values per channel: n/(n-1) = 8/7 is far above
    # float32 rounding. Mean away from 0, running stats away from (0, 1).
    x = rng.normal(0.7, 1.5, (2, 2, 2, 5)).astype(np.float32)
    stats = {"mean": rng.normal(0, 0.3, 5).astype(np.float32),
             "var": rng.uniform(0.5, 2.0, 5).astype(np.float32)}
    params = {"scale": rng.uniform(0.8, 1.2, 5).astype(np.float32),
              "bias": rng.normal(0, 0.1, 5).astype(np.float32)}
    bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    y, mutated = bn.apply({"params": params, "batch_stats": stats}, x,
                          mutable=["batch_stats"])
    return x, stats, params, np.asarray(y), jax.tree_util.tree_map(np.asarray,
                                                                   mutated["batch_stats"])


def _torch_bn(cls, stats, params):
    bn = cls(5, eps=tl.BN_EPS, momentum=tl.BN_MOMENTUM)
    with torch.no_grad():
        bn.weight.copy_(_t(params["scale"]))
        bn.bias.copy_(_t(params["bias"]))
        bn.running_mean.copy_(_t(stats["mean"]))
        bn.running_var.copy_(_t(stats["var"]))
    return bn.train()


def test_batchnorm_running_var_matches_flax():
    """Train-mode output and both running statistics equal flax's mutated
    ``batch_stats`` (rtol 1e-5: the batch variance is summed in another
    order, and flax takes E[x^2] - E[x]^2)."""
    x, stats, params, want_y, want = _bn_case()
    bn = _torch_bn(tl.BatchNorm2d, stats, params)
    y = bn(_t(x).permute(0, 3, 1, 2)).detach().permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(y, want_y, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), want["mean"], rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), want["var"], rtol=1e-5)


def test_plain_batchnorm_stores_the_unbiased_variance():
    """The fault the subclass repairs: ``nn.BatchNorm2d`` moves
    ``running_var`` toward n/(n-1) times flax's value, far outside the
    tolerance above."""
    x, stats, params, _, want = _bn_case()
    bn = _torch_bn(torch.nn.BatchNorm2d, stats, params)
    bn(_t(x).permute(0, 3, 1, 2))
    unbiased = (want["var"] - 0.9 * stats["var"]) / 0.1 * 8 / 7
    np.testing.assert_allclose(bn.running_var.numpy(), 0.9 * stats["var"] + 0.1 * unbiased,
                               rtol=1e-5)
    assert not np.allclose(bn.running_var.numpy(), want["var"], rtol=1e-3)


def test_batchnorm_cumulative_average_keeps_the_biased_variance():
    """``momentum=None`` (cumulative average, used to calibrate statistics)
    stores the biased batch variance after one batch."""
    x, stats, params, _, _ = _bn_case()
    bn = _torch_bn(tl.BatchNorm2d, stats, params)
    bn.momentum = None
    bn.reset_running_stats()
    bn(_t(x).permute(0, 3, 1, 2))
    np.testing.assert_allclose(bn.running_var.numpy(), x.reshape(-1, 5).var(0), rtol=1e-5)


# ------------------------------------------------ sigmoid_st, boxes, assign


def test_sigmoid_st_values_and_identity_gradient():
    """Forward equals JAX's to 1e-6; the backward passes the upstream
    gradient through unchanged, exactly."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 3, (4, 7)).astype(np.float32)
    w = rng.normal(0, 1, (4, 7)).astype(np.float32)
    want = np.asarray(j_sigmoid_st(jnp.asarray(x)))
    want_grad = np.asarray(jax.grad(lambda v: jnp.sum(j_sigmoid_st(v) * w))(jnp.asarray(x)))
    xt = _t(x, requires_grad=True)
    y = sigmoid_st(xt)
    (y * _t(w)).sum().backward()
    np.testing.assert_allclose(y.detach().numpy(), want, atol=1e-6)
    np.testing.assert_array_equal(xt.grad.numpy(), want_grad)
    np.testing.assert_array_equal(xt.grad.numpy(), w)


def _box_pairs(rng, n):
    c1 = rng.uniform(0.2, 0.8, (n, 2))
    c2 = c1 + rng.normal(0, 0.1, (n, 2))
    wh1, wh2 = rng.uniform(0.05, 0.5, (n, 2)), rng.uniform(0.05, 0.5, (n, 2))
    b1 = np.concatenate([c1 - wh1 / 2, c1 + wh1 / 2], -1)
    b2 = np.concatenate([c2 - wh2 / 2, c2 + wh2 / 2], -1)
    # a disjoint pair and a pair whose enclosing box has zero area
    b2[0] = b1[0] + 0.6
    b1[1] = b2[1] = [0.3, 0.3, 0.3, 0.3]
    return b1.astype(np.float32), b2.astype(np.float32)


@pytest.mark.parametrize("name", ["box_ciou", "box_giou"])
def test_box_iou_losses_values_and_gradients(name):
    """Values and the gradients of a weighted sum, w.r.t. both boxes,
    against JAX (atol 1e-5 on values in [-2, 1], rtol 1e-4 on gradients:
    elementwise float32 with atan / division in another order). The
    degenerate pair has NaN gradients on both sides (0/0 aspect ratio)."""
    b1, b2 = _box_pairs(np.random.default_rng(1), 16)
    w = np.random.default_rng(2).normal(0, 1, 16).astype(np.float32)
    jfn, tfn = getattr(j_boxes, name), getattr(boxes, name)
    want, want_iou = (np.asarray(v) for v in jfn(jnp.asarray(b1), jnp.asarray(b2)))
    g1, g2 = jax.grad(lambda a, b: jnp.sum(jfn(a, b)[0] * w), argnums=(0, 1))(
        jnp.asarray(b1), jnp.asarray(b2))
    t1, t2 = _t(b1, True), _t(b2, True)
    got, got_iou = tfn(t1, t2)
    (got * _t(w)).sum().backward()
    np.testing.assert_allclose(got.detach().numpy(), want, atol=1e-5)
    np.testing.assert_allclose(got_iou.detach().numpy(), want_iou, atol=1e-6)
    for mine, theirs in ((t1.grad, g1), (t2.grad, g2)):
        np.testing.assert_allclose(mine.numpy(), np.asarray(theirs), rtol=1e-4, atol=1e-5)


def test_box_helpers_match_jax():
    b1, b2 = _box_pairs(np.random.default_rng(3), 8)
    wh = np.abs(b1[:, 2:] - b1[:, :2]) + 0.01
    for got, want in (
            (boxes.corners_to_cxcywh(_t(b1)), j_boxes.corners_to_cxcywh(b1)),
            (boxes.elementwise_iou(_t(b1), _t(b2)), j_boxes.elementwise_iou(b1, b2)),
            (boxes.shape_iou(_t(wh), _t(wh[:5])), j_boxes.shape_iou(wh, wh[:5])),
            (boxes.enclosing_box(_t(b1), _t(b2)), j_boxes.enclosing_box(b1, b2))):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6, equal_nan=True)


def _assign_case(seed=0):
    """Two images on a 4x4 grid with 3 anchors; anchors 0 and 3 are
    identical, so the argmax over all anchors ties and must take head 0's;
    image 1 has one real GT row of 5, the rest is non-zero padding."""
    rng = np.random.default_rng(seed)
    b, h, w, a = 2, 4, 4, 3
    centers = rng.uniform(0.1, 0.9, (b, h, w, a, 2))
    sizes = rng.uniform(0.05, 0.5, (b, h, w, a, 2))
    pred = np.concatenate([centers - sizes / 2, centers + sizes / 2], -1).astype(np.float32)
    output = rng.uniform(0.01, 0.99, (b, h, w, a, 4)).astype(np.float32)
    gt, n_gt = padded_gt(rng, [3, 1], 5)
    anchors = np.asarray([[0.2, 0.3], [0.4, 0.4], [0.6, 0.5],
                          [0.2, 0.3], [0.1, 0.1], [0.05, 0.1]], np.float32)
    gt[0, 0, 3:5] = anchors[0]            # exact tie between anchors 0 and 3
    return pred, output, gt, n_gt, anchors


@pytest.mark.parametrize("mask", [[0, 1, 2], [3, 4, 5]])
def test_build_targets_matches_jax(mask):
    """Every field of the assignment equals JAX's: targets, weights, the
    assignment and counts exactly; CIoU to 1e-5 where assigned (the
    padded rows hold the sanitized dummy box on both sides); metrics to
    1e-5; and the CIoU gradient w.r.t. the decoded boxes, finite, to 1e-4."""
    pred, output, gt, n_gt, anchors = _assign_case()
    kw = dict(ignore_thresh=0.6, iou_thresh=0.55)

    def targets(p):
        return j_assign.build_targets(p, output, gt, n_gt, anchors, mask, **kw)

    output, gt, n_gt, anchors = (jnp.asarray(v) for v in (output, gt, n_gt, anchors))
    want, want_grad = jax.jit(lambda p: (targets(p), jax.grad(
        lambda q: jnp.sum(targets(q).ciou))(p)))(jnp.asarray(pred))
    pt = _t(pred, True)
    got = assign.build_targets(pt, _t(output), _t(gt), _t(n_gt), _t(anchors), mask, **kw)
    got.ciou.sum().backward()

    for field in ("targets", "weights", "assign", "area_weight", "count"):
        np.testing.assert_array_equal(getattr(got, field).numpy(),
                                      np.asarray(getattr(want, field)), err_msg=field)
    np.testing.assert_allclose(got.ciou.detach().numpy(), np.asarray(want.ciou), atol=1e-5)
    for k, v in want.metrics.items():
        np.testing.assert_allclose(float(got.metrics[k]), float(v), atol=1e-5, err_msg=k)
    assert torch.isfinite(pt.grad).all()
    np.testing.assert_allclose(pt.grad.numpy(), np.asarray(want_grad), rtol=1e-4, atol=1e-5)
    if mask[0] == 0:
        assert got.assign[0, 0].tolist() == [True, False, False]   # the tie went to anchor 0


def test_yolo_head_loss_value_and_gradient():
    """Head loss (including the weight-cancelling CIoU term) and its
    gradient w.r.t. the raw head: loss rtol 1e-5, gradient atol 1e-6 on
    entries of ~1e-3 (float32 sums in another order)."""
    rng = np.random.default_rng(4)
    head = rng.normal(0, 1, (2, 4, 4, 3 * 8)).astype(np.float32)
    gt, n_gt = padded_gt(rng, [3, 1], 5)
    anchors = rng.uniform(0.05, 0.6, (6, 2)).astype(np.float32)
    kw = dict(num_classes=3, ignore_thresh=0.6, iou_thresh=0.55, iou_weighting=0.02)
    mask = [3, 4, 5]
    jgt, jn_gt, janchors = jnp.asarray(gt), jnp.asarray(n_gt), jnp.asarray(anchors)

    def jloss(hd):
        out = j_losses.yolo_head_loss(hd, jgt, jn_gt, janchors, mask, **kw)
        return out.loss, out.metrics
    (want, want_metrics), want_grad = jax.jit(jax.value_and_grad(jloss, has_aux=True))(
        jnp.asarray(head))
    ht = _t(head, True)
    got = losses.yolo_head_loss(ht, _t(gt), _t(n_gt), _t(anchors), mask, **kw)
    got.loss.backward()
    np.testing.assert_allclose(got.loss.item(), float(want), rtol=1e-5)
    np.testing.assert_allclose(ht.grad.numpy(), np.asarray(want_grad), atol=1e-6, rtol=1e-4)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(got.metrics[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)


def test_seg_loss_value_and_gradient():
    """seg_loss's three outputs (rtol 1e-6) and the identity-backward
    gradient of the loss (atol 1e-9 on entries of ~1e-4)."""
    rng = np.random.default_rng(5)
    logits = rng.normal(0, 2, (2, 4, 4, 3)).astype(np.float32)
    truth = (rng.random((2, 4, 4, 3)) < 0.3).astype(np.float32)
    want = j_losses.seg_loss(jnp.asarray(logits), jnp.asarray(truth))
    want_grad = jax.grad(lambda v: j_losses.seg_loss(v, jnp.asarray(truth))[0])(
        jnp.asarray(logits))
    lt = _t(logits, True)
    got = losses.seg_loss(lt, _t(truth))
    got[0].backward()
    for g, w in zip(got, want):
        np.testing.assert_allclose(float(g), float(w), rtol=1e-6)
    np.testing.assert_allclose(lt.grad.numpy(), np.asarray(want_grad), atol=1e-9)


# ------------------------------------------------------ optimizer, schedule


def test_adamw_matches_optax_with_an_lr_change():
    """Three AdamW steps with the rate changed before the third:
    ``make_optimizer`` + ``with_lr`` against optax's ``inject_hyperparams``
    AdamW (rtol 1e-5, atol 1e-8: the two forms of the decoupled update
    round differently)."""
    rng = np.random.default_rng(6)
    params = {"a": rng.normal(0, 1, (3, 4)).astype(np.float32),
              "b": rng.normal(0, 1, (5,)).astype(np.float32)}
    grads = [{k: rng.normal(0, 1, v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = j_state.make_optimizer(7e-4, 4e-4)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)

    tp = {k: torch.nn.Parameter(_t(v)) for k, v in params.items()}
    model = torch.nn.Module()
    for k, v in tp.items():
        model.register_parameter(k, v)
    port = create_train_state(model)
    for i, g in enumerate(grads):
        if i == 2:
            opt_state.hyperparams["learning_rate"] = jnp.asarray(2e-3, jnp.float32)
            port.with_lr(2e-3)
        updates, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()},
                                       opt_state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, v in g.items():
            tp[k].grad = _t(v)
        port.optimizer.step()
        for k in params:
            np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                       rtol=1e-5, atol=1e-8)
    assert port.optimizer_steps() == 3


@pytest.mark.parametrize("epoch,warm_up", [(0, ()), (99, ()), (100, ()), (170, ()), (300, ()),
                                           (0, (1, 2)), (1, (1, 2)), (2, (1, 2)),
                                           (150, (1, 2))])
def test_learning_rate_for_epoch_matches_jax(epoch, warm_up):
    assert learning_rate_for_epoch(7e-4, epoch, warm_up=warm_up) == \
        j_schedule.learning_rate_for_epoch(7e-4, epoch, warm_up=warm_up)


def test_optimizer_decays_every_parameter():
    model = torch.nn.Linear(3, 2)
    opt = make_optimizer(model.parameters())
    assert [g["weight_decay"] for g in opt.param_groups] == [4e-4]
    assert opt.param_groups[0]["betas"] == (0.9, 0.999) and opt.param_groups[0]["eps"] == 1e-8


def test_slim_mode_must_be_prox_or_loss():
    """``slim_mode`` other than prox or loss raises JAX's ``ValueError``;
    prox is the default, and ``slim_l1`` 0 turns slimming off."""
    model = MBv2YOLO(num_classes=3, width_mult=0.35)
    cfg = dict(SMALL_YOLO_CONFIG, slim_l1=1e-4, slim_mode="l2")
    with pytest.raises(ValueError, match="slim_mode must be 'prox' or 'loss'") as port_err:
        make_train_step(model, cfg)
    with pytest.raises(ValueError) as jax_err:
        j_step._slim_cfg(cfg)
    assert str(port_err.value) == str(jax_err.value)
    assert j_step._slim_cfg(dict(SMALL_YOLO_CONFIG, slim_l1=1e-4)) == (1e-4, "prox")
    make_train_step(model, dict(SMALL_YOLO_CONFIG, slim_l1=1e-4))


# ---------------------------------------------------------- whole steps


@pytest.fixture(scope="module")
def variables64():
    return width035_variables64()


def _assert_grads_match(port_params, want_grads):
    """Every leaf's gradient to atol 1e-5 * max|g| of the leaf + 1e-12, or,
    where that is smaller, 1e-13 * the largest gradient of the network.

    The second floor is for a leaf whose gradient is zero in exact
    arithmetic. Block 0's project BN bias is one: block 0 has no residual,
    so the constant it adds goes through block 1's 1x1 expand, and block
    1's expand BN, normalising with the batch statistics in training mode,
    subtracts it again. Both packages then return float64 roundoff of the
    whole network's gradients, 1e-13 to 7e-13 here, with unrelated signs,
    and the leaf's own maximum is that roundoff: a floor scaled by it
    depends on the machine's summation order. Such leaves (every project
    BN bias of the backbone here) sit at 1e-19 to 3e-16 of the largest
    gradient, the others at 1e-6 and above. 1e-13 of the largest gradient
    is ~450 float64 epsilons of the network's gradient scale; it lies below
    the first term of every leaf whose largest gradient is above 1e-8 of
    the network's, and those keep the first term exactly."""
    scale = max(float(np.abs(want).max()) for want in want_grads.values())
    for key, want in want_grads.items():
        atol = max(1e-5 * np.abs(want).max() + 1e-12, 1e-13 * scale)
        np.testing.assert_allclose(port_params[key].grad.numpy(), want, atol=atol, err_msg=key)


def test_train_step_matches_jax(variables64):
    """One ``make_train_step`` step, float64 on both sides.

    The JAX step runs once, with ``optax.sgd(1.0)``, so its parameter
    change is minus the gradient: one compile gives the loss, every leaf's
    gradient and the BN statistics. The port's step (AdamW, EMA decay 0.9
    over a 2-step ramp) is then held to optax's AdamW and the JAX
    ``_ema_update`` applied to those gradients. Tolerances: loss rtol
    1e-6 (float32 loss on both sides); gradients atol 1e-5 * max|g| of
    the leaf (the float32 loss seeds them), with a floor for the leaves
    whose gradient is zero (``_assert_grads_match``); params and EMA atol 1e-5
    (Adam's first step is about -lr * sign(g), so only gradients near
    eps = 1e-8 can move a parameter differently); BN statistics 1e-9.
    """
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (4, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [2, 0, 3, 6], 6)
    with jax.enable_x64(True):
        jm, model = _pair(variables64)
        sgd = optax.sgd(1.0)
        step = j_step.make_train_step(jm, SMALL_YOLO_CONFIG, sgd, donate=False)
        stepped, want_metrics = step(_jax_state(variables64, sgd), x, gt, n_gt)
        params = jax.tree_util.tree_map(jnp.asarray, variables64["params"])
        grads = jax.tree_util.tree_map(lambda p, q: p - q, params, stepped.params)
        tx = j_state.make_optimizer(7e-4, 4e-4)

        @jax.jit  # one compile instead of ~25 s of eager dispatch over the leaves
        def adamw_and_ema(params, grads):
            updates, opt_state = tx.update(grads, tx.init(params), params)
            new_params = optax.apply_updates(params, updates)
            ema_state = _jax_state(variables64, tx).replace(ema_params=params)
            return new_params, j_step._ema_update(ema_state, new_params, opt_state, 0.9, 2.0)

        new_params, new_ema = adamw_and_ema(params, grads)

    state = create_train_state(model, ema=True)
    port_step = make_train_step(model, SMALL_YOLO_CONFIG, ema_decay=0.9, ema_ramp=2.0)
    state, metrics = port_step(state, _t(x), _t(gt), _t(n_gt))

    np.testing.assert_allclose(float(metrics["loss"]), float(want_metrics["loss"]), rtol=1e-6)
    for k, v in want_metrics.items():
        np.testing.assert_allclose(float(metrics[k]), float(v), rtol=1e-5, atol=1e-6,
                                   err_msg=k)
    port_params = dict(model.named_parameters())
    _assert_grads_match(port_params, state_dict_of("params", grads))
    for key, want in state_dict_of("params", new_params).items():
        np.testing.assert_allclose(port_params[key].detach().numpy(), want, atol=1e-5,
                                   err_msg=key)
    for key, want in state_dict_of("params", new_ema).items():
        np.testing.assert_allclose(state.ema[key].numpy(), want, atol=1e-5, err_msg=key)
    _assert_bn_stats_match(model, stepped.batch_stats)
    assert state.optimizer_steps() == 1


def test_geometry_step_matches_jax(variables64):
    """One ``make_geometry_train_step(fused_aug=False)`` step on a planner
    batch (1-tile and 4-tile images, programs on, noise off), float64 end
    to end, AdamW on both sides: the loss agrees to float32 rounding (rtol
    1e-6), the params after the step to atol 1e-5 and the BN statistics to
    1e-9.

    Three float32 stages that both packages keep in float32 whatever the
    compose dtype are taken out of the batch: the contrast mean and the
    mean fill (contrast steps become identity, fills constant), whose
    summation order differs between the packages, and the hue round trip,
    which XLA fuses differently under ``jit`` than eagerly (the jitted JAX
    images differ from the eager ones by 2e-4). Either moves the images by
    ~1e-4 of 255, and this tiny network turns that into 5% gradient
    differences. Without them the composed images agree to 1e-13.
    ``test_torch_augment.py`` holds all three against JAX on their own."""
    rng = np.random.default_rng(1)
    batch = geometry_batch(rng, 4, 32)
    batch["jitter_op"][np.isin(batch["jitter_op"], (1, 3))] = -1
    batch["fill_from_mean"][:] = False
    with jax.enable_x64(True):
        jm, model = _pair(variables64)
        tx = j_state.make_optimizer(7e-4, 4e-4)
        step = j_step.make_geometry_train_step(jm, SMALL_YOLO_CONFIG, tx, fused_aug=False)
        new_state, want_metrics = step(
            _jax_state(variables64, tx), *(jnp.asarray(batch[k]) for k in GEOMETRY_BATCH_KEYS),
            jnp.asarray(batch["gt"]), jnp.asarray(batch["n_gt"]), jax.random.PRNGKey(3),
            out_hw=(32, 32))
        want_loss = float(want_metrics["loss"])

    state = create_train_state(model)
    port_step = make_geometry_train_step(model, SMALL_YOLO_CONFIG, fused_aug=False,
                                         dtype=torch.float64)
    state, metrics = port_step(state, *(_t(batch[k]) for k in GEOMETRY_BATCH_KEYS),
                               _t(batch["gt"]), _t(batch["n_gt"]), 3, out_hw=(32, 32))
    np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=1e-6)
    got = dict(model.named_parameters())
    for key, want in state_dict_of("params", new_state.params).items():
        np.testing.assert_allclose(got[key].detach().numpy(), want, atol=1e-5, err_msg=key)
    _assert_bn_stats_match(model, new_state.batch_stats)


@pytest.mark.parametrize("fused_aug", [None, True, "split"])
def test_geometry_step_kernel_modes_on_cpu_tensors(fused_aug):
    """On CPU tensors the kernel modes run the kernels' plain twins: the
    step runs, the loss is finite and close to the plain mode's on the
    same weights and batch (noise off; the kernel paths round their images
    to bf16, about 1 intensity of 255: rtol 2e-2), and the parameters
    move."""
    rng = np.random.default_rng(2)
    batch = geometry_batch(rng, 4, 32)
    args = (*(_t(batch[k]) for k in GEOMETRY_BATCH_KEYS), _t(batch["gt"]),
            _t(batch["n_gt"]), 5)
    losses_by_mode = {}
    for mode in (False, fused_aug):
        model = MBv2YOLO(num_classes=3, width_mult=0.35,
                         generator=torch.Generator().manual_seed(0))
        before = model.backbone.stem.conv.weight.detach().clone()
        state = create_train_state(model)
        step = make_geometry_train_step(model, SMALL_YOLO_CONFIG, fused_aug=mode)
        state, metrics = step(state, *args, out_hw=(32, 32))
        losses_by_mode[mode] = float(metrics["loss"])
        assert np.isfinite(losses_by_mode[mode])
        assert not torch.equal(before, model.backbone.stem.conv.weight)
    np.testing.assert_allclose(losses_by_mode[fused_aug], losses_by_mode[False], rtol=2e-2)


def test_geometry_step_full_and_plain_share_the_noise():
    """Noise on every slot: the full kernel mode (its twin on CPU tensors)
    and the plain ops draw one noise stream from one ``aug_seed``, so their
    losses on the same weights and batch agree as closely as with noise
    off (only the full path's bf16 rounding of the images differs: rtol
    2e-2), while the noise itself moves the loss."""
    batch = geometry_batch(np.random.default_rng(2), 4, 32)
    batch["noise_gate"][:] = batch["active"]
    batch["noise_scale"][:] = 6.0
    batch["noise_per_channel"][:, ::2] = True
    geom = [_t(batch[k]) for k in GEOMETRY_BATCH_KEYS]
    losses = {}
    for name, mode, gate in (("full", True, geom[8]), ("plain", False, geom[8]),
                             ("quiet", False, torch.zeros_like(geom[8]))):
        model = MBv2YOLO(num_classes=3, width_mult=0.35,
                         generator=torch.Generator().manual_seed(0))
        step = make_geometry_train_step(model, SMALL_YOLO_CONFIG, fused_aug=mode)
        _, metrics = step(create_train_state(model), *geom[:8], gate, *geom[9:],
                          _t(batch["gt"]), _t(batch["n_gt"]), 5, out_hw=(32, 32))
        losses[name] = float(metrics["loss"])
    np.testing.assert_allclose(losses["full"], losses["plain"], rtol=2e-2)
    assert losses["plain"] != losses["quiet"]


def test_eval_step_matches_jax(variables64):
    """``make_eval_step``: the metrics of an eval-mode pass (running BN
    statistics) equal JAX's, float64 forwards (rtol 1e-5, atol 1e-6: the
    loss stays float32 on both sides), and nothing in the model moves."""
    rng = np.random.default_rng(4)
    x = rng.normal(0, 1, (2, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [3, 1], 5)
    with jax.enable_x64(True):
        jm, model = _pair(variables64)
        tx = optax.sgd(1.0)
        want = j_step.make_eval_step(jm, SMALL_YOLO_CONFIG)(_jax_state(variables64, tx), x, gt,
                                                            n_gt)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    got = make_eval_step(model, SMALL_YOLO_CONFIG)(create_train_state(model), _t(x), _t(gt),
                                                  _t(n_gt))
    assert set(got) == set(want)
    for k, v in want.items():
        np.testing.assert_allclose(float(got[k]), float(v), rtol=1e-5, atol=1e-6, err_msg=k)
    for k, v in model.state_dict().items():
        assert torch.equal(v, before[k]), k


def test_pixel_aug_step_equals_prejittered_images():
    """``pixel_aug=True`` applies the programs inside the step: the loss
    equals the normalize step's on images jittered beforehand (exactly:
    same ops, same order)."""
    from mobilenet_yolo_tpu_torch.ops.device_augment import planned_color_jitter

    rng = np.random.default_rng(3)
    raw = torch.from_numpy(rng.integers(0, 256, (2, 32, 32, 3), dtype=np.uint8))
    ops = torch.tensor([[0, 3, -1, 1, 4], [2, -1, 1, 3, 0]], dtype=torch.int32)
    facs = torch.tensor([[1.2, -0.05, 1.0, 0.7, 1.3], [0.6, 1.0, 1.4, 0.06, 0.8]])
    gt, n_gt = padded_gt(rng, [2, 1], 4)
    result = []
    for pixel_aug in (True, False):
        model = MBv2YOLO(num_classes=3, width_mult=0.35,
                         generator=torch.Generator().manual_seed(0))
        step = make_train_step(model, SMALL_YOLO_CONFIG, normalize=True, pixel_aug=pixel_aug)
        extra = (ops, facs) if pixel_aug else ()
        images = raw if pixel_aug else planned_color_jitter(raw, ops, facs)
        _, metrics = step(create_train_state(model), images, _t(gt), _t(n_gt), *extra)
        result.append(float(metrics["loss"]))
    assert result[0] == result[1]


def test_remat_train_step_matches_jax(variables64):
    """One ``make_train_step`` step of the remat model (``remat=True``: the
    backbone blocks recomputed in the backward, JAX's ``nn.remat``), float64
    on both sides, the JAX step under ``optax.sgd(1.0)`` so its parameter
    change is minus the gradient. Loss rtol 1e-6 (float32 loss on both
    sides), gradients as ``_assert_grads_match`` holds them, BN statistics 1e-9
    (one update, not two) and every ``num_batches_tracked`` at 1."""
    rng = np.random.default_rng(0)  # test_train_step_matches_jax's batch
    x = rng.normal(0, 1, (4, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [2, 0, 3, 6], 6)
    with jax.enable_x64(True):
        jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35, dtype=jnp.float64,
                         remat=True)
        sgd = optax.sgd(1.0)
        step = j_step.make_train_step(jm, SMALL_YOLO_CONFIG, sgd, donate=False)
        stepped, want_metrics = step(_jax_state(variables64, sgd), x, gt, n_gt)
        grads = jax.tree_util.tree_map(lambda p, q: np.asarray(p) - np.asarray(q),
                                       variables64["params"], stepped.params)
    model = load_flax_variables(MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
                                         remat=True, dtype=torch.float64), variables64)
    _, metrics = make_train_step(model, SMALL_YOLO_CONFIG)(create_train_state(model), _t(x),
                                                           _t(gt), _t(n_gt))
    np.testing.assert_allclose(float(metrics["loss"]), float(want_metrics["loss"]), rtol=1e-6)
    port_params = dict(model.named_parameters())
    _assert_grads_match(port_params, state_dict_of("params", grads))
    _assert_bn_stats_match(model, stepped.batch_stats)
    counts = {int(v) for k, v in model.state_dict().items() if k.endswith("num_batches_tracked")}
    assert counts == {1}


def test_remat_train_step_matches_the_plain_step_in_float64(variables64):
    """One ``make_train_step`` step, float64, the remat model against the
    plain model on the same weights and batch: the loss equal to 1e-12
    relative (the same forward), every gradient within 1e-7 of its leaf's
    largest, the parameters, BN statistics and counts after the step equal
    to 1e-12 (one BN update each, not two)."""
    rng = np.random.default_rng(5)
    x = rng.normal(0, 1, (4, 32, 32, 3))
    gt, n_gt = padded_gt(rng, [1, 3, 0, 2], 6)
    runs = []
    for remat in (False, True):
        model = load_flax_variables(MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
                                             remat=remat, dtype=torch.float64), variables64)
        _, metrics = make_train_step(model, SMALL_YOLO_CONFIG)(create_train_state(model), _t(x),
                                                               _t(gt), _t(n_gt))
        runs.append((float(metrics["loss"]), model))
    (loss_p, plain), (loss_r, remat) = runs
    np.testing.assert_allclose(loss_r, loss_p, rtol=1e-12)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        np.testing.assert_allclose(q.grad.numpy(), p.grad.numpy(),
                                   atol=1e-7 * float(p.grad.abs().max()) + 1e-15, err_msg=name)
    want, got = plain.state_dict(), remat.state_dict()
    assert list(want) == list(got)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), want[key].numpy(), rtol=1e-12, atol=1e-15,
                                   err_msg=key)
