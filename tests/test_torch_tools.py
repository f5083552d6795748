"""The port's measurement tools and kernel 7's twin, against the JAX package.

* ``kernels/stem_probe.py:stem_probe_reference`` (the twin of
  ``csrc/stem_probe.cu``) against the Pallas bodies of
  ``tools/probe_stem_pallas.py`` run in interpret mode with ``main.build``'s
  BlockSpecs;
* ``tools/probe_stem.py``'s folds against formulation a, and a against
  ``jax.lax.conv_general_dilated``;
* the ports of ``tests/test_bench_tools.py``: the backward's FLOPs guard
  and a ``--step-only --json`` smoke; a ``bench_geometry`` smoke;
* ``config.py`` against the VOC yaml, and the tools' device rule.

Inputs come from numpy seeds; each assert states its tolerance.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mobilenet_yolo_tpu_torch.config import TRAIN_BUCKETS, VOC_CONFIG
from mobilenet_yolo_tpu_torch.kernels.stem_probe import COUT, stem_probe, stem_probe_reference
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.tools import (bench_geometry, bench_train, probe_aug_kernels,
                                            probe_fused_tiles, probe_nms, probe_stem,
                                            probe_stem_cuda)
from mobilenet_yolo_tpu_torch.train import make_loss_fn
from mobilenet_yolo_tpu_torch.train.synthetic import random_geometry_batch
from mobilenet_yolo_tpu_torch.utils.profiling import device_ms

from _torch_parity import SMALL_YOLO_CONFIG, VOC_CONFIG as VOC_YAML, load_yaml
from tools.probe_stem_pallas import _kernel_a, _kernel_b, _kernel_c


def _pallas_probe(stage: str, b: int, s: int):
    """``tools/probe_stem_pallas.py:main.build`` (:113-134) in interpret mode."""
    h = s // 2
    in_specs = [pl.BlockSpec((1, s, s * 3), lambda i: (i, 0, 0), memory_space=pltpu.VMEM)]
    if stage == "c":
        in_specs += [pl.BlockSpec((9, 3, 32), lambda i: (0, 0, 0), memory_space=pltpu.VMEM),
                     pl.BlockSpec((32,), lambda i: (0,), memory_space=pltpu.VMEM)]
    return pl.pallas_call(
        {"a": _kernel_a, "b": _kernel_b, "c": _kernel_c}[stage], grid=(b,), in_specs=in_specs,
        out_specs=pl.BlockSpec((1, h, h * 32), lambda i: (i, 0, 0), memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, h, h * 32), jnp.bfloat16),
        interpret=pltpu.InterpretParams())


@pytest.mark.parametrize("stage", ["a", "b", "c"])
@pytest.mark.parametrize("s", [16, 18])
def test_stem_probe_twin_matches_the_pallas_bodies(stage, s):
    """Stages a and b: within one bf16 spacing of the largest output (both
    sum a row in float32 in another order, then round once). Stage c:
    within 1e-2 of the largest output (the Pallas body takes 3-wide dots,
    the twin single products; a bf16 rounding may tip). S=18 has an odd
    S/2."""
    x, *wb = probe_stem_cuda.stage_inputs(stage, 2, s, "cpu", seed=s)
    want = np.asarray(_pallas_probe(stage, 2, s)(*(jnp.asarray(t.numpy()) for t in (x, *wb))),
                      np.float32)
    got = stem_probe(x, stage, *wb)  # a CPU tensor: the twin
    assert got.shape == (2, s // 2, s // 2 * COUT) and got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want).max()
    top = np.abs(want).max()
    tol = 1e-2 * top if stage == "c" else 2.0 ** (np.floor(np.log2(top)) - 7)
    assert err <= tol, (err, tol)


def test_stem_probe_twin_stage_c_matches_conv2d():
    """The twin against ``F.conv2d`` + bias + clamp + cast and against
    ``lax.conv_general_dilated`` (the probe's oracle, :148-155) on the same
    input: within 2^-8 of the largest output (float32 sums, one bf16
    rounding each)."""
    x, w, b = probe_stem_cuda.stage_inputs("c", 2, 34, "cpu", seed=1)
    got = stem_probe_reference(x, "c", w, b).float()
    lib = probe_stem_cuda.conv_stem(x, w, b).float()
    ref = jax.lax.conv_general_dilated(
        jnp.asarray(x.numpy().reshape(2, 34, 34, 3)), jnp.asarray(w.numpy().reshape(3, 3, 3, 32)),
        (2, 2), [(1, 1), (1, 1)], dimension_numbers=("NHWC", "HWIO", "NHWC"))
    ref = np.clip(np.asarray(ref) + b.numpy(), 0.0, 6.0).reshape(2, 17, 17 * 32)
    tol = 2.0 ** -8 * np.abs(ref).max()
    assert np.abs(got.numpy() - ref).max() <= tol
    assert float((got - lib).abs().max()) <= tol


def test_probe_stem_folds_equal_formulation_a():
    """Float32, small shape: the b, c and d folds give formulation a's output
    to 1e-5, and a is ``lax.conv_general_dilated`` 3x3/s2 pad 1 to 1e-5."""
    rng = np.random.default_rng(0)
    x = rng.normal(0, 1, (2, 16, 16, 3)).astype(np.float32)
    k = rng.normal(0, 0.1, (3, 3, 3, 32)).astype(np.float32)
    f32 = torch.float32
    xd, kd = probe_stem.nchw(x, "cpu"), probe_stem.oihw(k, "cpu")
    k4 = probe_stem.oihw(probe_stem.fold_s2d(k), "cpu")
    a = probe_stem.stem_a(xd, kd, f32)
    b = probe_stem.stem_b(probe_stem.nchw(probe_stem.space_to_depth(x, 2), "cpu"), k4, f32)
    c = probe_stem.stem_c(xd, k4, f32)
    assert a.shape == b.shape == c.shape == (2, 32, 8, 8)
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
    np.testing.assert_allclose(c.numpy(), a.numpy(), atol=1e-5)
    ref = jax.lax.conv_general_dilated(jnp.asarray(x), jnp.asarray(k), (2, 2), [(1, 1), (1, 1)],
                                       dimension_numbers=("NHWC", "HWIO", "NHWC"))
    np.testing.assert_allclose(a.permute(0, 2, 3, 1).numpy(), np.asarray(ref), atol=1e-5)
    # formulation d (double space-to-depth, padded cell grid) equals a too
    d = probe_stem.stem_d(probe_stem.nchw(probe_stem.space_to_depth(x, 4), "cpu"),
                          probe_stem.oihw(probe_stem.fold_s2d4(k), "cpu"), f32)
    assert d.shape == a.shape
    np.testing.assert_allclose(d.numpy(), a.numpy(), atol=1e-5)


def test_backward_stage_carries_the_backward():
    """The port of ``test_bench_tools.py:37``: the fwd+loss+bwd chain counts
    at least twice the FLOPs of fwd+loss (a dropped backward gives ~1x),
    and the forward stage most of fwd+loss's."""
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
                     generator=torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    images = torch.from_numpy(rng.normal(0, 1, (2, 96, 96, 3)).astype(np.float32))
    gt = torch.zeros((2, 4, 5))
    gt[:, 0] = torch.tensor([1, 0.5, 0.5, 0.4, 0.4])
    n_gt = torch.ones(2, dtype=torch.int32)
    loss_fn = make_loss_fn(model, SMALL_YOLO_CONFIG)
    fwd, fwd_loss, fwd_bwd = bench_train.build_component_programs(model, loss_fn, gt, n_gt)
    f_fwd, f_loss, f_bwd = (bench_train.count_flops(f, images) for f in (fwd, fwd_loss, fwd_bwd))
    assert f_loss > 0 and f_fwd > 0.5 * f_loss
    assert f_bwd >= 2.0 * f_loss, (f_bwd, f_loss)
    loss, checksum = fwd_bwd(images)
    assert torch.isfinite(loss) and torch.isfinite(checksum)
    assert all(p.grad is None for p in model.parameters())


def test_conv_backward_flops_count_groups():
    """A depthwise conv's backward counts twice its forward (input and
    weight gradients), not PyTorch's groups-blind C/2 times over."""
    x = torch.randn(1, 16, 12, 12, requires_grad=True)
    w = torch.randn(16, 1, 3, 3, requires_grad=True)

    def conv():
        return torch.nn.functional.conv2d(x, w, padding=1, groups=16)

    fwd = bench_train.count_flops(conv)
    assert fwd == 2 * 16 * 12 * 12 * 9
    assert bench_train.count_flops(lambda: torch.autograd.grad(conv().sum(), [x, w])) == 3 * fwd


def test_bench_train_step_only_smoke_emits_sane_json(capsys):
    """The port of ``test_bench_tools.py:63``, at batch 1, 96x96, on the CPU."""
    bench_train.main(["--batch-size", "1", "--img-size", "96", "--iters", "1", "--step-only",
                      "--json", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["step_ms"] > 0 and rec["img_per_s"] > 0 and rec["device"] == "cpu"
    assert "fwd_ms" not in rec


def test_bench_geometry_smoke_in_plain_mode(capsys):
    bench_geometry.main(["--batch-size", "2", "--img-size", "64", "--iters", "1", "--fused",
                         "off", "--stages", "--device", "cpu"])
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["plain_step_ms"] > 0 and rec["geometry_step_ms"] > 0
    assert rec["stage_total_ms"] > 0 and "stage_fused_total_ms" not in rec  # off: no kernel path


def test_worst_case_batch_is_all_mosaics():
    batch = bench_geometry.worst_case_batch(np.random.default_rng(0), 3, 32)
    assert batch["active"].all() and batch["fill_from_mean"].all()
    assert batch["slots"].shape == (3, 4, 32, 32, 3) and batch["jitter_op"].shape == (3, 4, 5)
    np.testing.assert_array_equal(batch["dst_rect"][0, 3], [0.5, 0.5, 1.0, 1.0])


def test_probe_tools_run_on_the_cpu_when_asked():
    """On CPU tensors the kernels' wrappers run their twins, so these check
    the tools' plumbing: the twin's stage c against ``F.conv2d`` and the aug
    twins against the plain ops at the JAX probe's tolerances."""
    out = probe_stem_cuda.main(["--stage", "c", "--size", "18", "--batch", "2", "--device", "cpu"])
    assert out["check"]["conv2d_max_abs_err"] <= out["check"]["tol"]
    aug = probe_aug_kernels.main(["--size", "32", "--device", "cpu"])
    assert aug["slot_aug_max_abs_err"] < probe_aug_kernels.SLOT_TOL
    assert aug["aug_compose_max_abs_err"] < probe_aug_kernels.COMPOSE_MAX_TOL


def test_probe_stem_cuda_bench_reports_its_share_of_the_bound(monkeypatch):
    """``bench`` beside the bound: ``share_of_bound`` = bound / time, and
    for stage c ``vs_stage_a`` = c's time over stage a's on the same input
    (on the CPU the times are the twins' host-clock times, at a small
    shape)."""
    monkeypatch.setattr(probe_stem_cuda, "BENCH_BATCH", 1)
    monkeypatch.setattr(probe_stem_cuda, "BENCH_SIZE", 16)
    for stage in ("a", "c"):
        out = probe_stem_cuda.bench(stage, "cpu", iters=1)
        assert (out["batch"], out["size"]) == (1, 16)
        assert out["share_of_bound"] == pytest.approx(out["bound_ms"] / out["ms"])
        assert ("vs_stage_a" in out) == (stage == "c")
    assert out["vs_stage_a"] == pytest.approx(out["ms"] / out["stage_a_ms"])
    assert out["library_ms"] > 0


@pytest.mark.parametrize("full", [False, True])
def test_probe_nms_random_over_is_seeded(full):
    """The scan's seeded inputs, shared by the probe, ``chip_smoke.py`` and
    the card tests: strictly upper-triangular as ``batched_nms`` builds
    it, or ``full`` with the diagonal and lower triangle set too."""
    over, valid = probe_nms.random_over(2, 40, 0.2, "cpu", full=full, seed=3)
    again, _ = probe_nms.random_over(2, 40, 0.2, "cpu", full=full, seed=3)
    assert over.shape == (2, 40, 40) and valid.shape == (2, 40) and torch.equal(over, again)
    assert set(over.unique().tolist()) == {0.0, 1.0} and over.is_contiguous()
    lower = over.tril()
    assert lower.any() if full else not lower.any()
    assert torch.equal(over.triu(1), probe_nms.random_over(2, 40, 0.2, "cpu", seed=3)[0])
    assert 0 < valid.sum() < valid.numel()


@pytest.mark.parametrize("traffic", probe_aug_kernels.TRAFFIC)
def test_probe_aug_kernels_slot_classes(traffic):
    """``--traffic``: every slot copy-only (no noise, identity program),
    noised with an identity program, or a hue then a gamma step with the
    planner's factor ranges; ``loader`` keeps the batch's own plans."""
    rng = np.random.default_rng(0)
    batch = random_geometry_batch(np.random.default_rng(1), 3, 32)
    out = probe_aug_kernels.slot_class(batch, traffic, rng)
    if traffic == "loader":
        assert out is batch
        return
    assert out["noise_gate"].all() == (traffic == "noise") and \
        out["noise_gate"].any() == (traffic == "noise")
    ops, facs = out["jitter_op"], out["jitter_factor"]
    assert ops.shape == batch["jitter_op"].shape and ops.dtype == np.int32
    if traffic == "color":
        assert (ops[..., 0] == 3).all() and (ops[..., 1] == 4).all() and (ops[..., 2:] == -1).all()
        assert np.abs(facs[..., 0]).max() <= 18.0 / 255.0
        assert ((facs[..., 1] >= 0.5) & (facs[..., 1] <= 1.5)).all()
    else:
        assert (ops == -1).all() and (facs == 1.0).all()
    for key in ("slots", "src_rect", "active", "noise_scale"):
        assert out[key] is batch[key]
    with pytest.raises(ValueError, match="traffic"):
        probe_aug_kernels.slot_class(batch, "hue", rng)


@pytest.mark.parametrize("tool,argv", [
    (probe_nms, ["--batch", "1", "--k", "8"]),
    (probe_nms, []),
    (bench_train, ["--batch-size", "1", "--img-size", "32"]),
    (bench_geometry, ["--batch-size", "1", "--img-size", "32"]),
    (probe_stem, ["--batch", "1", "--size", "16"]),
    (probe_stem_cuda, ["--size", "16", "--batch", "1"]),
    (probe_aug_kernels, ["--size", "16"]),
    (probe_aug_kernels, ["--bench", "--batch", "1", "--size", "16"]),
    (probe_fused_tiles, ["--batch", "1", "--size", "32"]),
    (probe_fused_tiles, ["--stem", "--batch", "1", "--size", "32"]),
])
def test_tools_raise_without_a_card(tool, argv):
    """Every tool runs on the card by default and refuses the CPU unless
    asked: no silent fallback."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid here")
    with pytest.raises(RuntimeError, match="pass --device cpu"):
        tool.main(argv)
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        device_ms(lambda: None, device="cuda", iters=1)


def test_probe_fused_tiles_runs_on_the_cpu_when_asked():
    """The plan probe at 64x64: every distinct stride-1 and stride-2 block
    shape of the folded VOC backbone, each with its model-ranked plans (the
    picked one first), each within BF16_REL_TOL of the twin (on the CPU the
    wrapper runs the twin itself)."""
    out = probe_fused_tiles.main(["--device", "cpu", "--batch", "1", "--size", "64", "--iters", "1",
                                  "--top", "2"])
    assert [s["blocks"] for s in out["shapes"]][:3] == ["block1", "block2", "block3"]
    assert len(out["shapes"]) == 11 and out["shapes"][-1]["cout"] == 320
    for shape in out["shapes"]:
        picked = fb.plan_bf16(shape["stride"], 1, shape["x"][1] // shape["stride"],
                              shape["x"][2] // shape["stride"], shape["x"][3], shape["hidden"],
                              shape["cout"])
        assert shape["plans"][0]["plan"] == picked._asdict()
        assert all(p["rel_err"] == 0.0 for p in shape["plans"])


def test_probe_fused_tiles_takes_the_f32_kernel_on_the_cpu_when_asked(tmp_path):
    """``--dtype f32``: the same block shapes, each led by ``plan_f32``'s
    pick, the float32 twin's check at ``F32_REL_TOL``; ``--fit`` reads the
    saved sweep back and fits the float32 route's constants (here to CPU
    times: the plumbing, not the card's numbers)."""
    out = probe_fused_tiles.main(["--dtype", "f32", "--device", "cpu", "--batch", "1", "--size",
                                  "64", "--iters", "1", "--top", "2"])
    assert out["dtype"] == "f32" and len(out["shapes"]) == 11
    for shape in out["shapes"]:
        stride, x = shape["stride"], shape["x"]
        picked = fb.plan_f32(stride, 1, x[1] // stride, x[2] // stride, x[3], shape["hidden"],
                             shape["cout"])
        assert shape["plans"][0]["plan"] == picked._asdict()
        assert all(p["rel_err"] == 0.0 for p in shape["plans"])
    path = tmp_path / "sweep.json"
    path.write_text(json.dumps(out))
    fitted = probe_fused_tiles.main(["--fit", str(path)])
    assert list(fitted["constants"]) == list(fb.COST_CONSTANTS)
    assert all(c >= 0 for c in fitted["constants"].values())
    assert fitted["readings"] == sum(len(s["plans"]) for s in out["shapes"])


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_probe_fused_tiles_takes_the_stem_on_the_cpu_when_asked(dtype):
    """``--stem``: the stem's shape alone, led by ``plan_stem``'s pick, then
    the model's next plans with other tiles, each against the twin (on the
    CPU the twin itself)."""
    out = probe_fused_tiles.main(["--stem", "--dtype", dtype, "--device", "cpu", "--batch", "1",
                                  "--size", "64", "--iters", "1", "--top", "2"])
    (shape,) = out["shapes"]
    assert shape["blocks"] == "stem+0" and shape["x"] == [1, 64, 64, 3] and shape["cout"] == 16
    plans = [p["plan"] for p in shape["plans"]]
    assert plans[0] == fb.plan_stem(dtype, 1, 32, 32, 32, 16)._asdict() and len(plans) == 3
    assert len({(p["th"], p["tw"]) for p in plans}) == 3
    assert all(p["rel_err"] == 0.0 for p in shape["plans"])


def test_config_equals_the_voc_yaml():
    assert VOC_CONFIG == load_yaml(VOC_YAML)
    assert TRAIN_BUCKETS == (288, 320, 352, 384, 416)
