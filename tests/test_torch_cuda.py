"""The port on the card: each CUDA kernel against its plain twin (the two
augmentation kernels also on batches of the loader), the geometry train
step in each augmentation mode, and the BatchNorm-folded predict through
the fused-block kernels.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernel builds from
``mobilenet_yolo_tpu_torch/csrc/`` at first use) and skips elsewhere. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; the repository's ``conftest.py`` imports JAX, hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The scan is boolean logic, so the NMS kernel must equal its twin bit for
bit; the other kernels' tolerances are stated beside them.
"""

import copy
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu_torch.config import default_data_yaml, prune_plan
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader, batch_to_device
from mobilenet_yolo_tpu_torch.data.records import RecordReader
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose, aug_compose_reference
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug, slot_aug_reference
from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose, planned_color_jitter
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms
from mobilenet_yolo_tpu_torch.tools.probe_fused_tiles import block_shapes
from mobilenet_yolo_tpu_torch.tools.probe_nms import random_over as random_device_over
from mobilenet_yolo_tpu_torch.train.synthetic import random_geometry_batch

pytestmark = pytest.mark.cuda

VOC = {"yolo": {"num_classes": 20, "num_anchors": 3,
                "anchors": [[143, 265], [153, 121], [280, 279], [20, 37], [49, 94], [73, 201]],
                "mask": [[0, 1, 2], [3, 4, 5]]}}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU and nvcc")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def random_over(seed, b, k, density):
    rng = np.random.default_rng(seed)
    over = (rng.random((b, k, k)) < density).astype(np.float32)
    over *= np.triu(np.ones((k, k), np.float32), 1)
    valid = (rng.random((b, k)) < 0.8).astype(np.float32)
    return torch.from_numpy(over), torch.from_numpy(valid)


@pytest.mark.parametrize("b,k,density", [
    (128, 256, 0.05),   # the serving shape at 352x352
    (2, 60, 0.3),       # the candidate count at 64x64
    (3, 1000, 0.01),    # not a multiple of the warp or of the row chunk
    (1, 1, 0.0),
])
def test_kernel_matches_reference(cuda, b, k, density):
    over, valid = random_over(0, b, k, density)
    before = suppress.launches
    keep = suppress(over.to(cuda), valid.to(cuda))
    torch.cuda.synchronize()
    assert suppress.launches == before + 1
    assert keep.dtype == torch.bool and keep.shape == (b, k)
    np.testing.assert_array_equal(keep.cpu().numpy(), suppress_reference(over, valid).numpy())


def test_kernel_chain_case(cuda):
    over = torch.zeros(1, 128, 128)
    over[0, 0, 1] = over[0, 1, 2] = 1.0
    valid = torch.zeros(1, 128)
    valid[0, :3] = 1.0
    keep = suppress(over.to(cuda), valid.to(cuda)).cpu()
    assert keep[0, :3].tolist() == [True, False, True] and not keep[0, 3:].any()


@pytest.mark.parametrize("full", [False, True])
@pytest.mark.parametrize("b", [1, 128])
@pytest.mark.parametrize("k", [1, 31, 32, 33, 65, 256, 1000, 1024])
def test_suppress_kernel_matches_twin_at_every_width(cuda, k, b, full):
    """Bit-equal at every word layout of the bitmask scan: one partial
    word, one whole word, a word and one column, K % 4 != 0 (the scalar
    loads), the serving K and MAX_K (128 KB of shared memory); a full
    matrix shows the scan reads only the strict upper triangle."""
    over, valid = random_device_over(b, k, min(0.3, 8.0 / k), cuda, full, k + b + full)
    before = suppress.launches
    keep = suppress(over, valid)
    torch.cuda.synchronize()
    assert suppress.launches == before + 1
    assert torch.equal(keep, suppress_reference(over, valid))


def test_suppress_kernel_chain_crosses_words(cuda):
    """30 cuts 33, 33 would cut 64, 64 cuts 97: a chain whose links cross
    the 32-column words of the scan (30 -> 33 within a row's first two
    words, 33 -> 64 and 64 -> 97 from one chunk to the next)."""
    over = torch.zeros(1, 256, 256)
    for i, j in ((30, 33), (33, 64), (64, 97)):
        over[0, i, j] = 1.0
    valid = torch.zeros(1, 256)
    valid[0, [30, 33, 64, 97]] = 1.0
    keep = suppress(over.to(cuda), valid.to(cuda)).cpu()
    assert keep[0].nonzero().flatten().tolist() == [30, 64]
    assert torch.equal(keep, suppress_reference(over, valid))


def test_suppress_kernel_takes_a_misaligned_over(cuda):
    """A contiguous ``over`` whose first element is not 16-byte aligned
    takes the scalar loads."""
    over, valid = random_device_over(4, 256, 0.03, cuda, seed=5)
    store = torch.empty(over.numel() + 1, device=cuda)
    shifted = store[1:].view(over.shape)
    shifted.copy_(over)
    assert shifted.data_ptr() % 16 != 0
    assert torch.equal(suppress(shifted, valid), suppress_reference(over, valid))


def test_kernel_rejects_mixed_devices(cuda):
    over, valid = random_over(1, 1, 8, 0.1)
    with pytest.raises(ValueError, match="valid on cpu"):
        suppress(over.to(cuda), valid)


def test_batched_nms_cuda_equals_cpu(cuda):
    rng = np.random.default_rng(2)
    centers = rng.uniform(0.2, 0.8, (4, 1815, 2))
    sizes = rng.uniform(0.1, 0.4, (4, 1815, 2))
    preds = np.concatenate([centers - sizes / 2, centers + sizes / 2,
                            rng.uniform(0, 1, (4, 1815, 2)),
                            rng.integers(0, 20, (4, 1815, 1))], -1).astype(np.float32)
    preds = torch.from_numpy(preds)
    want = batched_nms(preds, torch.tensor(0.3))
    got = batched_nms(preds.to(cuda), torch.tensor(0.3, device=cuda))
    for w, g in zip(want, got):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


def test_predict_cuda_matches_cpu(cuda):
    """The whole slice, card vs CPU, in float64 with BatchNorm statistics
    calibrated on one batch. Straight from the init, eval-mode activations
    shrink at every depthwise conv until every score ties at 0.25; with
    calibrated statistics the random network amplifies float32 rounding
    enough to reorder near-equal scores. In float64 neither happens, so the
    kept set must be equal. The detections are decoded in float32, where
    exp and sigmoid differ by a few ulp between the card and the CPU, and
    boxes reach a few image widths at 96x96: rtol 1e-5, atol 1e-6."""
    rng = np.random.default_rng(3)
    model = build_model(VOC, device="cpu", generator=torch.Generator().manual_seed(0))
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.momentum = None  # cumulative average: one pass sets the batch stats
    with torch.no_grad():
        model(torch.from_numpy(rng.normal(size=(2, 3, 96, 96)).astype(np.float32)))
    model.double()
    images = torch.from_numpy(rng.normal(size=(2, 96, 96, 3)))
    val_conf = torch.tensor(0.3)
    dets_cpu, keep_cpu = make_predict_fn(model, VOC)(images, val_conf)
    model.to(cuda)
    dets, keep = make_predict_fn(model, VOC)(images.to(cuda), val_conf.to(cuda))
    keep_cpu = keep_cpu.numpy()
    assert 0 < keep_cpu.sum() < (dets_cpu[..., 4] > 0.3).sum().item()
    np.testing.assert_array_equal(keep.cpu().numpy(), keep_cpu)
    np.testing.assert_allclose(dets.cpu().numpy()[keep_cpu], dets_cpu.numpy()[keep_cpu],
                               atol=1e-6, rtol=1e-5)


# ------------------------------------------------ the augmentation kernels

# kernel vs twin on bf16 output in [0, 255]: both compute in float32 and
# round once, so a few ulp of float32 may tip a rounding: at most one bf16
# spacing (1.0 in [128, 256)), and rarely
AUG_MAX_ERR = 1.0
AUG_MEAN_ERR = 0.05


def _aug_batch(seed, b, s):
    """A synthetic batch with noise on every active slot (the loader gates
    a quarter), so each kernel test draws noise on both sides."""
    rng = np.random.default_rng(seed)
    batch = random_geometry_batch(rng, b, s)
    active = batch["active"]
    batch["noise_gate"] = active.copy()
    batch["noise_scale"] = np.where(active, rng.uniform(0.0, 0.03 * 255.0, active.shape),
                                    0.0).astype(np.float32)
    batch["noise_per_channel"] = active & (rng.random(active.shape) < 0.3)
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _slot_args(g, device, seed=7):
    n = g["slots"].shape[0] * g["slots"].shape[1]
    s = g["slots"].shape[2]
    return (g["slots"].reshape(n, s, s, 3).to(device), seed,
            *(g[k].reshape(n, *g[k].shape[2:]).to(device)
              for k in ("noise_gate", "noise_scale", "noise_per_channel", "jitter_op",
                        "jitter_factor")))


def _assert_aug_close(got, want):
    d = (got.float() - want.float()).abs()
    assert float(d.max()) <= AUG_MAX_ERR and float(d.mean()) < AUG_MEAN_ERR, \
        (float(d.max()), float(d.mean()))


@pytest.mark.parametrize("b,s,dtype", [(4, 352, torch.bfloat16), (2, 416, torch.bfloat16),
                                       (3, 34, torch.float32)])
def test_slot_aug_kernel_matches_twin(cuda, b, s, dtype):
    args = _slot_args(_aug_batch(b + s, b, s), cuda)
    before = slot_aug.launches
    got = slot_aug(*args, dtype=dtype)
    torch.cuda.synchronize()
    assert slot_aug.launches == before + 1 and got.dtype == dtype
    want = slot_aug_reference(*args, dtype=dtype)
    if dtype == torch.bfloat16:
        _assert_aug_close(got, want)
    else:  # float32 out: only float32 rounding differs
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


@pytest.mark.parametrize("bits", [False, True])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("s", [18, 34, 352, 416])
def test_slot_aug_kernel_matches_twin_at_every_size(cuda, s, dtype, bits):
    """The paired-row pixel pass at both instances: S = 18 and 34 (S % 4
    == 2, odd S/2: one column a thread) and the buckets 352 and 416 (four
    columns a thread), both output types, shared-plane and per-channel
    noise on every active slot, the generator or injected bits."""
    g = _aug_batch(s + bits, 2, s)
    g["noise_per_channel"] = g["active"] & (torch.arange(8).reshape(2, 4) % 2 == 0)
    args = _slot_args(g, cuda)
    n = args[0].shape[0]
    debug = None
    if bits:
        debug = torch.from_numpy(np.random.default_rng(s).integers(
            0, 2 ** 32, (2, n, 3, s // 2, s), dtype=np.uint64).astype(np.uint32)
            .view(np.int32)).to(cuda)
    got = slot_aug(*args, dtype=dtype, debug_bits=debug)
    want = slot_aug_reference(*args, dtype=dtype, debug_bits=debug)
    torch.cuda.synchronize()
    assert got.shape == (n, 3, s, s) and got.dtype == dtype
    if dtype == torch.bfloat16:
        _assert_aug_close(got, want)
    else:  # float32 out: only float32 rounding differs
        torch.testing.assert_close(got, want, atol=1e-2, rtol=0)


def test_slot_aug_kernel_takes_a_misaligned_base(cuda):
    """Slots whose first byte is not on a 32-bit word take the one-column
    instance, and agree with the twin."""
    args = _slot_args(_aug_batch(3, 2, 64), cuda)
    store = torch.empty(args[0].numel() + 1, dtype=torch.uint8, device=cuda)
    shifted = store[1:].view(args[0].shape)
    shifted.copy_(args[0])
    assert shifted.data_ptr() % 4 != 0
    got = slot_aug(shifted, *args[1:], dtype=torch.float32)
    torch.testing.assert_close(got, slot_aug_reference(*args), atol=1e-2, rtol=0)


def test_slot_aug_and_aug_compose_draw_the_same_pixels(cuda):
    """The slot pass's paired rows and the compose kernel's per-pixel taps
    (aug_common.cuh:pixel_state) give the same pixels, noise and program:
    one tile an image pasted onto the whole output, no fill, no flip, so
    each output pixel is its tap's value, rounded once to bf16 on both
    sides."""
    b, s = 3, 64
    g = _aug_batch(11, b, s)
    g["active"] = torch.tensor([[True, False, False, False]] * b)
    g["noise_gate"] = g["active"].clone()
    g["noise_per_channel"] = torch.tensor([[True, False, False, False], [False] * 4,
                                           [True, False, False, False]])
    g["jitter_op"][:, 0] = torch.tensor([[3, 1, 4, -1, -1], [2, 3, 0, -1, -1],
                                         [4, 3, -1, -1, -1]], dtype=g["jitter_op"].dtype)
    g["jitter_factor"][:, 0] = torch.tensor([[-0.05, 1.3, 0.7, 1, 1], [1.4, 0.06, 0.8, 1, 1],
                                             [1.2, -0.02, 1, 1, 1]])
    whole = torch.tensor([0.0, 0.0, 1.0, 1.0]).repeat(b, 4, 1)
    g["src_rect"], g["dst_rect"] = whole, whole.clone()
    g["fill_rect"] = torch.zeros(b, 4, 4)
    g["fill_from_mean"] = torch.zeros(b, 4, dtype=torch.bool)
    g["flip"] = torch.zeros(b, 4, dtype=torch.bool)
    composed = aug_compose(*_compose_args(g, cuda), (s, s))
    planar = slot_aug(*_slot_args(g, cuda, seed=9)).reshape(b, 4, 3, s, s)[:, 0]
    assert torch.equal(composed, planar.permute(0, 2, 3, 1))


def test_slot_aug_sincosf_matches_cosf_and_sinf_on_every_phase(cuda):
    """The pixel pass draws both rows of a pair from one ``sincosf``; the
    per-pixel path (the compose kernel's taps) calls ``cosf`` or ``sinf``.
    All 2^24 phases 2*pi*u2 that ``bits_to_unit`` can give, bit for bit."""
    from mobilenet_yolo_tpu_torch.kernels import _build

    out = torch.empty((4, 1 << 24), device=cuda)
    assert _build.load().myt_aug_trig_table(
        out.data_ptr(), torch.cuda.current_stream().cuda_stream) == 0
    torch.cuda.synchronize()
    assert torch.isfinite(out).all()
    assert torch.equal(out[0].view(torch.int32), out[2].view(torch.int32))
    assert torch.equal(out[1].view(torch.int32), out[3].view(torch.int32))


def test_slot_aug_kernel_negative_hue_and_debug_bits(cuda):
    """Floor-mod on negative hue operands, and the injected-bits seam."""
    n, s = 4, 64
    rng = np.random.default_rng(5)
    slots = torch.from_numpy(rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)).to(cuda)
    ops = torch.tensor([[3, -1, -1, -1, -1], [3, 0, -1, -1, -1], [1, 3, 4, -1, -1],
                        [2, 3, -1, -1, -1]], dtype=torch.int32, device=cuda)
    facs = torch.tensor([[-0.07, 1, 1, 1, 1], [-0.01, 1.3, 1, 1, 1], [0.6, -0.05, 0.8, 1, 1],
                         [1.4, 0.06, 1, 1, 1]], device=cuda)
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, (2, n, 3, s // 2, s), dtype=np.uint64)
                            .astype(np.uint32).view(np.int32)).to(cuda)
    plan = (torch.tensor([True, False, True, True], device=cuda), torch.full((n,), 6.0, device=cuda),
            torch.tensor([True, False, False, True], device=cuda), ops, facs)
    got = slot_aug(slots, 3, *plan, dtype=torch.float32, debug_bits=bits)
    want = slot_aug_reference(slots, 3, *plan, dtype=torch.float32, debug_bits=bits)
    torch.testing.assert_close(got, want, atol=1e-2, rtol=0)
    noiseless = slot_aug_reference(slots, 3, torch.zeros_like(plan[0]), *plan[1:],
                                   dtype=torch.float32)
    assert not torch.equal(got, noiseless)


def test_slot_aug_kernel_noise_statistics(cuda):
    """Mid-grey slots, noise on, no program: over all slots the added field
    has mean ~0 (|m| < 0.02, ~10 standard errors) and std ~scale (within
    0.5%); per slot |m| < 0.2 and std within 2% (a shared-plane slot draws
    124k values: standard error 0.034); seeds decorrelate."""
    n, s = 8, 352
    slots = torch.full((n, s, s, 3), 128, dtype=torch.uint8, device=cuda)
    plan = (torch.ones(n, dtype=torch.bool, device=cuda), torch.full((n,), 12.0, device=cuda),
            torch.arange(n, device=cuda) % 2 == 0,
            torch.full((n, 5), -1, dtype=torch.int32, device=cuda), torch.ones(n, 5, device=cuda))
    delta = slot_aug(slots, 11, *plan, dtype=torch.float32) - 128.0
    assert abs(float(delta.mean())) < 0.02 and abs(float(delta.std()) - 12.0) < 0.06
    for i in range(n):
        assert abs(float(delta[i].mean())) < 0.2 and abs(float(delta[i].std()) - 12.0) < 0.24
    other = slot_aug(slots, 12, *plan, dtype=torch.float32) - 128.0
    corr = torch.corrcoef(torch.stack([delta[0].flatten(), other[0].flatten()]))[0, 1]
    assert abs(float(corr)) < 0.01


def _compose_args(g, device, seed=9):
    return (g["slots"].to(device), seed,
            *(g[k].to(device) for k in ("noise_gate", "noise_scale", "noise_per_channel",
                                        "jitter_op", "jitter_factor", "src_rect", "dst_rect",
                                        "fill_rect", "fill_color", "fill_from_mean", "flip",
                                        "active")))


@pytest.mark.parametrize("b,s,out_hw", [(4, 352, (352, 352)), (3, 416, (416, 416)),
                                        (2, 64, (70, 50))])
def test_aug_compose_kernel_matches_twin(cuda, b, s, out_hw):
    args = _compose_args(_aug_batch(b * s, b, s), cuda)
    before = aug_compose.launches
    got = aug_compose(*args, out_hw)
    torch.cuda.synchronize()
    assert aug_compose.launches == before + 1
    assert got.shape == (b, *out_hw, 3) and got.dtype == torch.bfloat16
    _assert_aug_close(got, aug_compose_reference(*args, out_hw))


def test_aug_compose_kernel_inactive_tiles_and_debug_bits(cuda):
    """An image with every tile inactive comes out zero; injected bits
    drive both sides' noise."""
    g = _aug_batch(3, 2, 32)
    g["active"][1] = False
    n = 2 * 4
    bits = torch.from_numpy(np.random.default_rng(4).integers(
        0, 2 ** 32, (2, n, 3, 16, 32), dtype=np.uint64).astype(np.uint32).view(np.int32))
    g["noise_gate"][:] = True
    args = _compose_args(g, cuda)
    got = aug_compose(*args, (48, 40), debug_bits=bits.to(cuda))
    assert not got[1].any()
    _assert_aug_close(got, aug_compose_reference(*args, (48, 40), debug_bits=bits.to(cuda)))


def _prepass_batch(b, s):
    """Programs with 0, 1 and 5 contrast steps (and contrast between other
    ops), fills from the mean and constant, flipped and inactive tiles,
    B * 3 slots."""
    g = _aug_batch(b + s, b, s)
    g = {k: v[:, :3] if v.dim() > 1 and v.shape[1] == 4 else v for k, v in g.items()}
    programs = [([-1] * 5, [1.0] * 5), ([1, -1, -1, -1, -1], [1.4, 1, 1, 1, 1]),
                ([1, 1, 1, 1, 1], [1.3, 0.7, 1.2, 0.8, 1.5]),
                ([0, 1, 3, 1, 4], [1.1, 0.6, -0.05, 1.3, 0.8]), ([2, 4, 1, 0, 3], [0.5, 1.2, 1.5, 0.9, 0.1])]
    n = b * 3
    ops = torch.tensor([programs[i % len(programs)][0] for i in range(n)], dtype=torch.int32)
    facs = torch.tensor([programs[i % len(programs)][1] for i in range(n)])
    g["jitter_op"], g["jitter_factor"] = ops.reshape(b, 3, 5), facs.reshape(b, 3, 5)
    idx = torch.arange(n).reshape(b, 3)
    g["active"] = idx % 4 != 3
    g["fill_from_mean"] = idx % 2 == 0
    g["flip"] = idx % 3 == 1
    g["fill_rect"] = torch.tensor([0.0, 0.0, 1.0, 1.0]).repeat(b, 3, 1)
    g["src_rect"] = torch.tensor([0.1, 0.2, 0.8, 0.9]).repeat(b, 3, 1)
    g["dst_rect"] = torch.tensor([[0.0, 0.0, 0.6, 0.6], [0.4, 0.0, 1.0, 0.5],
                                  [0.2, 0.5, 1.0, 1.0]]).repeat(b, 1, 1)
    return g


def _in_order_slots(slots, seed, gate, scale, per_channel, ops, facs):
    """``slot_aug_reference`` (float32) for any program: the twin's noise,
    then each step through the twin as a program of its own. The twin runs
    a program as one pass per phase around the hue step, which is the
    program in order when each op appears at most once (the host planner's
    contract); one step a call is the program in order for any program."""
    none = torch.full_like(ops, -1)
    x = slot_aug_reference(slots, seed, gate, scale, per_channel, none, torch.ones_like(facs))
    for t in range(ops.shape[1]):
        step_ops, step_facs = none.clone(), torch.ones_like(facs)
        step_ops[:, 0], step_facs[:, 0] = ops[:, t], facs[:, t]
        x = planned_color_jitter(x.permute(0, 2, 3, 1), step_ops, step_facs).permute(0, 3, 1, 2)
    return x.contiguous()


@pytest.mark.parametrize("b,s", [(3, 64), (5, 352)])
def test_aug_prepass_programs_and_repeats(cuda, b, s):
    """The statistics pre-pass that both augmentation kernels run, spread
    over the card: programs with 0, 1, 2 and 5 contrast steps (the last two
    outside the host planner's contract, so the twin runs them a step at a
    time: ``_in_order_slots``), fill from the mean on and off, flipped and
    inactive slots, an odd number of slots (B * 3, and B * 3 - 2 for
    ``slot_aug``). Each kernel matches its twin, and two runs give the same
    bits (no floating-point atomics)."""
    g = _prepass_batch(b, s)
    args = _compose_args(g, cuda)
    runs = [aug_compose(*args, (s, s)) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    planar = _in_order_slots(*_slot_args(g, cuda, seed=args[1]))
    want = geometric_compose(planar.reshape(b, 3, 3, s, s), *args[7:10], args[10],
                             *(a.bool() for a in args[11:14]), (s, s), planar=True)
    _assert_aug_close(runs[0], want.to(torch.bfloat16))
    sargs = [a[:b * 3 - 2] if torch.is_tensor(a) else a for a in _slot_args(g, cuda)]
    runs = [slot_aug(*sargs, dtype=torch.float32) for _ in range(2)]
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    _assert_aug_close(runs[0], _in_order_slots(*sargs))


@pytest.mark.parametrize("fused_aug", [None, True, "split", False])
def test_geometry_step_runs_each_mode(cuda, fused_aug):
    """One width-0.35 geometry step per mode on the card: the loss is
    finite, the parameters move, and the mode's kernel launched once."""
    from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
    from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                                make_geometry_train_step)

    g = _aug_batch(1, 4, 64)
    model = MBv2YOLO(num_classes=20, width_mult=0.35,
                     generator=torch.Generator().manual_seed(0)).to(cuda)
    before = model.backbone.stem.conv.weight.detach().clone()
    step = make_geometry_train_step(model, {**VOC, "yolo": {
        **VOC["yolo"], "ignore_thresh": [0.6, 0.56], "iou_thresh": 0.55}}, fused_aug=fused_aug)
    counts = (slot_aug.launches, aug_compose.launches)
    _, metrics = step(create_train_state(model), *(g[k].to(cuda) for k in GEOMETRY_BATCH_KEYS),
                      g["gt"].to(cuda), g["n_gt"].to(cuda), 5, out_hw=(64, 64))
    torch.cuda.synchronize()
    assert np.isfinite(float(metrics["loss"]))
    assert not torch.equal(before, model.backbone.stem.conv.weight)
    full = fused_aug in (None, True)
    assert (slot_aug.launches - counts[0], aug_compose.launches - counts[1]) == \
        (int(fused_aug == "split"), int(full))


# ------------------------------------------- the kernels on loader batches


@pytest.fixture(scope="module")
def voc_shard(tmp_path_factory):
    """A fabricated VOC tree (16 trainval images of 240-480 px sides) built
    into a shard by the port's ``build_dataset`` CLI, as a user runs both."""
    root = tmp_path_factory.mktemp("voc")
    repo = Path(__file__).resolve().parent.parent
    for cmd in ([str(repo / "tools" / "make_fabricated_voc.py"), "--root", str(root),
                 "--train", "16", "--test", "2"],
                ["-m", "mobilenet_yolo_tpu_torch.cli.build_dataset", "-d",
                 str(root / "data.yaml")]):
        subprocess.run([sys.executable, *cmd], cwd=repo, check=True, capture_output=True,
                       timeout=300)
    return str(root / "train-records")


@pytest.mark.parametrize("size", [288, 320, 384])
def test_aug_kernels_on_a_loader_batch(cuda, voc_shard, size):
    """A ``Loader(device_geometry=True)`` batch of real JPEGs at a VOC
    bucket: both kernels against their twins; then 0xFF in the inactive
    slots (the slot ring hands the kernels stale bytes there) moves no
    active output bit."""
    ds = DetectionDataset(RecordReader(voc_shard), phase="train", apply_photometric=False)
    loader = Loader(ds, 8, [[size, size]], [0.5] * 3, [1.0] * 3, mosaic_num=[1, 4], prefetch=0,
                    device_geometry=True, seed=size)
    batch = next(iter(loader))
    active = batch["active"]
    assert batch["slots"].shape == (8, 4, size, size, 3)
    assert active.any(1).all() and not active.all()
    batch["slots"][~active] = 0
    g = batch_to_device(batch, cuda)
    stale = dict(g, slots=g["slots"].clone())
    stale["slots"][~g["active"]] = 0xFF
    sargs, stale_sargs = _slot_args(g, cuda), _slot_args(stale, cuda)
    got = slot_aug(*sargs)
    _assert_aug_close(got, slot_aug_reference(*sargs, dtype=torch.bfloat16))
    on = g["active"].reshape(-1)
    assert torch.equal(slot_aug(*stale_sargs)[on], got[on])
    cargs, stale_cargs = _compose_args(g, cuda), _compose_args(stale, cuda)
    got = aug_compose(*cargs, (size, size))
    _assert_aug_close(got, aug_compose_reference(*cargs, (size, size)))
    assert torch.equal(aug_compose(*stale_cargs, (size, size)), got)


# --------------------------------------- the fused blocks of the folded model

# kernel vs twin, relative to the largest output. float32: only the order
# of summation differs (the block kernel's three TF32 passes keep float32's
# accuracy and sum the project over 24-channel chunks; up to 960 terms at
# 6e-8 each is 5.8e-5 at worst). bf16
# (``fb.BF16_REL_TOL``): the block kernel rounds where pallas_fused.py does
# (float32 hidden and depthwise, the depthwise output rounded to bf16 for
# the project, one output rounding); the twin also rounds the hidden
# tensor, the project's output and the residual sum (2^-9 relative each).
# A hidden value rounded differently moves a depthwise output by up to one
# bf16 spacing, the project sums Ch such moves of random sign, and the two
# outputs may then sit one bf16 spacing of the largest (2^-7) apart plus a
# few roundings. The stem kernel keeps float32 inside and rounds once.
FUSED_F32_REL_TOL = 1e-4
FUSED_BF16_REL_TOL = fb.BF16_REL_TOL
# the float32 kernels against the float64 twin, relative to the largest
# output: float32's own rounding (a few 1e-7; one TF32 pass would sit at
# 2-5e-4)
FUSED_F64_REL_TOL = 1e-5


def _fused_args(seed, b, h, w, cin, ch, cout, dtype, device, stem=False):
    """Weights scaled so activations keep unit size through each block."""
    g = torch.Generator().manual_seed(seed)
    first = (3, 3, 3, ch) if stem else (cin, ch)
    fan_in = 27 if stem else cin
    args = [torch.randn((b, h, w, 3 if stem else cin), generator=g),
            torch.randn(first, generator=g) / fan_in ** 0.5, 0.1 * torch.randn(ch, generator=g),
            torch.randn((3, 3, ch), generator=g) / 3.0, 0.1 * torch.randn(ch, generator=g),
            torch.randn((ch, cout), generator=g) / ch ** 0.5, 0.1 * torch.randn(cout, generator=g)]
    return [a.to(device, dtype if a.dim() > 1 else torch.float32) for a in args]


def _assert_fused_close(got, want, dtype):
    tol = FUSED_F32_REL_TOL if dtype == torch.float32 else FUSED_BF16_REL_TOL
    err = float((got.float() - want.float()).abs().max() / want.float().abs().max())
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,stride,residual", [
    ((2, 16, 24, 24, 144, 24), 1, True),     # Cin 24: K padded to 32; Ch 144, Cout 24
    ((3, 13, 11, 24, 50, 24), 1, True),      # unaligned width, a ragged last chunk
    ((2, 11, 11, 160, 960, 320), 1, False),  # block 16's widths, output width 11
    ((2, 11, 11, 160, 960, 160), 1, True),   # blocks 14-15: Cout 160, residual
    ((2, 44, 44, 8, 48, 16), 2, False),      # ragged stride-2 tiles
    ((3, 22, 22, 96, 576, 160), 2, False),   # block 13: 22 -> 11
    ((2, 20, 14, 16, 96, 24), 2, False),     # Cin 16 at stride 2, ragged both ways
    ((1, 10, 6, 20, 70, 30), 2, False),      # channels off every multiple of 4 or 8
])
def test_fused_block_kernel_matches_twin(cuda, shape, stride, residual, dtype):
    args = _fused_args(sum(shape), *shape, dtype, cuda)
    wrapper = fb.fused_inverted_residual if stride == 1 else fb.fused_inverted_residual_s2
    before = wrapper.launches
    got = wrapper(*args, residual=residual) if stride == 1 else wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.dtype == dtype
    want = fb.inverted_residual_reference(*args, residual=residual, stride=stride)
    assert got.shape == want.shape
    _assert_fused_close(got, want, dtype)


# every block of the served slim50 plan (configs/voc/slim50.yaml) at 352x352:
# (block, stride, H in, Cin, hidden, Cout, residual). Hidden widths 176,
# 232, 312, 224, 216, 152, 80 and 264 are not multiples of the bf16
# kernel's 48-channel chunk (nor of the float32 kernel's 24), so each
# launch ends in a partial chunk, which no VOC width gives
SLIM50_BLOCKS = [
    ("block1", 2, 176, 16, 96, 24, False), ("block2", 1, 88, 24, 144, 24, True),
    ("block3", 2, 88, 24, 144, 32, False), ("block4", 1, 44, 32, 192, 32, True),
    ("block5", 1, 44, 32, 176, 32, True), ("block6", 2, 44, 32, 192, 64, False),
    ("block7", 1, 22, 64, 312, 64, True), ("block8", 1, 22, 64, 232, 64, True),
    ("block9", 1, 22, 64, 176, 64, True), ("block10", 1, 22, 64, 288, 96, False),
    ("block11", 1, 22, 96, 224, 96, True), ("block12", 1, 22, 96, 152, 96, True),
    ("block13", 2, 22, 96, 216, 160, False), ("block14", 1, 11, 160, 152, 160, True),
    ("block15", 1, 11, 160, 80, 160, True), ("block16", 1, 11, 160, 264, 320, False),
]


@pytest.fixture(scope="module")
def slim50_shapes():
    """block name -> (kernel, x shape, hidden, Cout, residual) of the folded
    slim50 backbone at batch 2, 352x352, from the model itself."""
    plan = prune_plan(default_data_yaml("voc/slim50.yaml"))
    backbone = build_model(dict(VOC, prune=plan), device="cpu").backbone
    return {name: key for names, *key in block_shapes(backbone, 2, 352)
            for name in names.split("/")}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("block,stride,h,cin,ch,cout,residual", SLIM50_BLOCKS)
def test_fused_block_kernel_at_slim50_widths(cuda, slim50_shapes, block, stride, h, cin, ch,
                                            cout, residual, dtype):
    kernel = "fused_inverted_residual" if stride == 1 else "fused_inverted_residual_s2"
    assert slim50_shapes[block] == [kernel, (2, h, h, cin), ch, cout, residual]
    args = _fused_args(h + ch, 2, h, h, cin, ch, cout, dtype, cuda)
    wrapper = fb.fused_inverted_residual if stride == 1 else fb.fused_inverted_residual_s2
    before = wrapper.launches
    got = wrapper(*args, residual=residual) if stride == 1 else wrapper(*args)
    torch.cuda.synchronize()
    assert wrapper.launches == before + 1 and got.dtype == dtype
    want = fb.inverted_residual_reference(*args, residual=residual, stride=stride)
    assert got.shape == want.shape == (2, h // stride, h // stride, cout)
    _assert_fused_close(got, want, dtype)


def test_bf16_kernel_takes_a_misaligned_base(cuda):
    """A contiguous x whose storage starts 2 bytes off a 16-byte boundary
    takes the element loads instead of the 16-byte copies."""
    args = _fused_args(7, 2, 16, 16, 32, 96, 32, torch.bfloat16, cuda)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16, device=cuda)
    args[0] = flat[1:].view(args[0].shape).copy_(args[0])
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 2
    got = fb.fused_inverted_residual(*args)
    _assert_fused_close(got, fb.inverted_residual_reference(*args), torch.bfloat16)


def test_f32_kernel_takes_a_misaligned_base(cuda):
    """A contiguous float32 x whose storage starts 4 bytes off a 16-byte
    boundary takes the element loads instead of the 16-byte copies."""
    args = _fused_args(7, 2, 16, 16, 32, 96, 32, torch.float32, cuda)
    flat = torch.empty(args[0].numel() + 1, dtype=torch.float32, device=cuda)
    args[0] = flat[1:].view(args[0].shape).copy_(args[0])
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 == 4
    got = fb.fused_inverted_residual(*args)
    _assert_fused_close(got, fb.inverted_residual_reference(*args), torch.float32)


@pytest.mark.parametrize("allow_tf32", [False, True])
@pytest.mark.parametrize("shape,stride,residual", [
    ((2, 11, 11, 160, 960, 320), 1, False),  # block 16
    ((2, 22, 22, 96, 576, 160), 2, False),   # block 13, stride 2
    ((2, 11, 11, 24, 144, 24), 1, True),     # block 2's widths
    ((2, 22, 22, 16, 96, 24), 2, False),     # block 1's widths, stride 2
])
def test_f32_kernel_is_float32_accurate(cuda, shape, stride, residual, allow_tf32, monkeypatch):
    """The float32 kernel's three TF32 passes against the float64 twin: within
    1e-5 of the largest output (one TF32 pass sits at 2-4e-4 on the CPU
    model, tests/test_torch_fused.py), whatever PyTorch's TF32 flags say;
    the float32 twin's own error (TF32 off) is reported beside it."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    args = _fused_args(sum(shape), *shape, torch.float32, cuda)
    wrapper = fb.fused_inverted_residual if stride == 1 else fb.fused_inverted_residual_s2
    got = wrapper(*args, residual=residual) if stride == 1 else wrapper(*args)
    want = fb.inverted_residual_reference(*[a.double() for a in args], residual=residual,
                                          stride=stride)
    scale = float(want.abs().max())
    err = float((got.double() - want).abs().max()) / scale
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    twin = fb.inverted_residual_reference(*args, residual=residual, stride=stride)
    twin_err = float((twin.double() - want).abs().max()) / scale
    print(f"kernel vs float64 {err:.3g}, float32 twin vs float64 {twin_err:.3g}")
    assert err <= 1e-5, (err, twin_err)


@pytest.mark.parametrize("stride", [1, 2])
def test_each_dtype_launches_its_own_block_kernel(cuda, monkeypatch, stride):
    """bf16 reaches only the tensor-core kernel and float32 only the
    float32 one: the C entry points a call reaches, and the launch count."""
    lib, calls = fb._build.load(), []

    class Spy:
        def __getattr__(self, name):
            def call(*a):
                calls.append(name)
                return getattr(lib, name)(*a)
            return call

    monkeypatch.setattr(fb._build, "load", lambda: Spy())
    wrapper = fb.fused_inverted_residual if stride == 1 else fb.fused_inverted_residual_s2
    for dtype, entry in ((torch.bfloat16, "myt_fused_block_bf16"),
                         (torch.float32, "myt_fused_block")):
        args = _fused_args(stride, 2, 22, 22, 32, 192, 32, dtype, cuda)
        calls.clear()
        before = wrapper.launches
        got = wrapper(*args)
        torch.cuda.synchronize()
        assert calls == [entry] and wrapper.launches == before + 1 and got.dtype == dtype
        want = fb.inverted_residual_reference(*args, residual=stride == 1, stride=stride)
        _assert_fused_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape", [(2, 32, 40, 3, 32, 16), (1, 30, 22, 3, 13, 6),
                                   (2, 64, 64, 3, 40, 70)])
def test_fused_stem_kernel_matches_twin(cuda, shape, dtype):
    args = _fused_args(sum(shape), *shape, dtype, cuda, stem=True)
    before = fb.fused_stem_block0.launches
    got = fb.fused_stem_block0(*args)
    torch.cuda.synchronize()
    assert fb.fused_stem_block0.launches == before + 1 and got.dtype == dtype
    want = fb.stem_block0_reference(*args)
    assert got.shape == want.shape
    _assert_fused_close(got, want, dtype)


@pytest.mark.parametrize("allow_tf32", [False, True])
@pytest.mark.parametrize("shape", [(2, 32, 40, 3, 32, 16), (2, 64, 64, 3, 40, 70),
                                   (4, 352, 352, 3, 32, 16)])
def test_f32_stem_is_float32_accurate(cuda, shape, allow_tf32, monkeypatch):
    """The float32 stem kernel's three TF32 passes (stem and project)
    against the float64 twin, within FUSED_F64_REL_TOL of the largest
    output whatever PyTorch's TF32 flags say."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", allow_tf32)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", allow_tf32)
    args = _fused_args(sum(shape), *shape, torch.float32, cuda, stem=True)
    got = fb.fused_stem_block0(*args)
    want = fb.stem_block0_reference(*[a.double() for a in args])
    err = float((got.double() - want).abs().max()) / float(want.abs().max())
    assert err <= FUSED_F64_REL_TOL, err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,tile", [
    ((2, 30, 22, 3, 13, 6), (15, 11)),    # the whole 15x11 output in one tile
    ((2, 30, 22, 3, 13, 6), (8, 8)),      # ragged tiles both ways
    ((2, 30, 22, 3, 13, 6), (3, 5)),
    ((1, 64, 64, 3, 40, 70), (8, 16)),    # two hidden chunks, Cout 70
    ((2, 40, 48, 3, 32, 16), (16, 16)),   # ragged 16x16 tiles
    ((1, 16, 128, 3, 32, 40), (2, 64)),   # 128-pixel rows
])
def test_stem_kernel_takes_each_plan(cuda, shape, tile, dtype):
    """The stem kernel under tiles its planner does not pick at these
    shapes (each with the warp tiling ``warp_config`` gives it) against
    the twin."""
    b, h, w, _, ch, cout = shape
    dt = "bf16" if dtype == torch.bfloat16 else "f32"
    plan = fb.Plan(*tile, *fb.warp_config(tile[0] * tile[1], cout, fb.STEM_CONFIGS),
                   fb._stem_smem_bytes(dt, *tile, cout))
    args = _fused_args(sum(shape) + tile[1], *shape, dtype, cuda, stem=True)
    got = fb._launch_stem(*args, plan=plan)
    torch.cuda.synchronize()
    _assert_fused_close(got, fb.stem_block0_reference(*args), dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_stem_kernel_takes_a_misaligned_base(cuda, dtype):
    """A contiguous x whose storage starts one element off a 16-byte
    boundary (rows of 3 * 32 values would take 16-byte copies) takes the
    element loads."""
    args = _fused_args(9, 2, 32, 32, 3, 32, 16, dtype, cuda, stem=True)
    flat = torch.empty(args[0].numel() + 1, dtype=dtype, device=cuda)
    args[0] = flat[1:].view(args[0].shape).copy_(args[0])
    assert args[0].is_contiguous() and args[0].data_ptr() % 16 != 0
    got = fb.fused_stem_block0(*args)
    _assert_fused_close(got, fb.stem_block0_reference(*args), dtype)


def test_fused_kernel_rejects_mixed_devices(cuda):
    args = _fused_args(0, 1, 8, 8, 8, 16, 8, torch.float32, cuda)
    args[1] = args[1].cpu()
    with pytest.raises(ValueError, match="w1 on cpu"):
        fb.fused_inverted_residual(*args)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_folded_predict_launches_the_fused_kernels(cuda, dtype):
    """A folded VOC model on the card: each request launches the stem
    kernel once, the stride-2 kernel 4 times and the stride-1 kernel 12
    times, and its heads match the unfolded model's (init weights, which
    contract, so the comparison sees the rounding of a few layers)."""
    model = build_model(VOC, generator=torch.Generator().manual_seed(0))
    folded = fold_batchnorm(model)
    predict = make_predict_fn(folded, VOC, dtype=dtype)
    images = torch.randn((2, 96, 96, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    counts = _fused_counts()
    for _ in range(2):
        dets, keep = predict(images, torch.tensor(0.3, device=cuda))
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_fused_counts(), counts)] == [2, 8, 24]
    assert bool(torch.isfinite(dets).all()) and keep.shape == (2, 135)  # (3*3 + 6*6) * 3
    with torch.inference_mode(), torch.autocast("cuda", dtype=dtype, enabled=dtype is not None):
        got = folded(images.permute(0, 3, 1, 2))
    with torch.inference_mode():
        want = model.eval()(images.permute(0, 3, 1, 2))
    tol = 1e-4 if dtype is None else 5e-2
    for key in want:
        err = float((got[key].float() - want[key]).abs().max() / want[key].abs().max())
        assert err <= tol, (key, err)


def _fused_counts():
    return [fb.fused_stem_block0.launches, fb.fused_inverted_residual_s2.launches,
            fb.fused_inverted_residual.launches]


# -------------------------------------------- the stem roofline probe kernel

# tolerances: ``probe_stem_cuda.tolerance``. Stages a and b sum thousands of
# floats in another order than the twin and round once to bf16: a rounding
# may tip by one bf16 spacing, at most that of the largest output. Stage c
# sums the 27 products in three TF32 passes on the tensor cores, the twin
# as rounded float32 products: a few float32 ulp apart before the one bf16
# rounding; held within 2^-8 of the largest output.

@pytest.mark.parametrize("stage", ["a", "b", "c"])
@pytest.mark.parametrize("b,s", [(2, 16), (3, 18), (4, 352), (2, 34)])
def test_stem_probe_kernel_matches_twin(cuda, stage, b, s):
    """S=18 has an odd S/2; S=34 rows (102 floats) take the scalar loads."""
    from mobilenet_yolo_tpu_torch.kernels.stem_probe import stem_probe, stem_probe_reference
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import stage_inputs, tolerance

    x, *wb = stage_inputs(stage, b, s, cuda, seed=b + s)
    before = stem_probe.launches
    got = stem_probe(x, stage, *wb)
    torch.cuda.synchronize()
    assert stem_probe.launches == before + 1
    assert got.shape == (b, s // 2, s // 2 * 32) and got.dtype == torch.bfloat16
    want = stem_probe_reference(x, stage, *wb)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tolerance(stage, want), (err, tolerance(stage, want))


def _stem_probe_against_twin(x, stage, wb):
    from mobilenet_yolo_tpu_torch.kernels.stem_probe import stem_probe, stem_probe_reference
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import tolerance

    got = stem_probe(x, stage, *wb)
    torch.cuda.synchronize()
    want = stem_probe_reference(x, stage, *wb)
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    err = float((got.float() - want.float()).abs().max())
    assert err <= tolerance(stage, want), (err, tolerance(stage, want))


@pytest.mark.parametrize("stage", ["a", "b", "c"])
@pytest.mark.parametrize("s", [64, 66])
@pytest.mark.parametrize("where", ["row 0", "column 0", "last row", "last column"])
def test_stem_probe_edges(cuda, stage, s, where):
    """An input that is zero but on one edge: stage c's zero padding (the
    row above row 0, the column left of column 0), stage b's wrap (row S-1
    above row 0, lanes modulo 3S) and the last row and column. S=66 rows
    take the element copies."""
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import stage_inputs

    x, *wb = stage_inputs(stage, 2, s, cuda, seed=s)
    edge = torch.zeros_like(x).reshape(2, s, s, 3)
    pick = {"row 0": (slice(None), 0), "column 0": (slice(None), slice(None), 0),
            "last row": (slice(None), s - 1), "last column": (slice(None), slice(None), s - 1)}
    edge[pick[where]] = x.reshape(2, s, s, 3)[pick[where]]
    _stem_probe_against_twin(edge.reshape(2, s, 3 * s), stage, wb)


@pytest.mark.parametrize("stage", ["b", "c"])
@pytest.mark.parametrize("b,s", [(300, 16), (7, 130)])
def test_stem_probe_work_items_span_images(cuda, stage, b, s):
    """Stages b and c walk work items of 16 output rows of the B*S/2, cut
    at image boundaries into segments. S=16: 2400 rows of 8 an image, 150
    items of two images each, more than the SMs (132 on an H100), so a
    block takes a second item; S=130: 16 does not divide h = 65, so items
    start mid-image and the last has 7 rows. The ring wraps many times."""
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import stage_inputs

    x, *wb = stage_inputs(stage, b, s, cuda, seed=b)
    _stem_probe_against_twin(x, stage, wb)


@pytest.mark.parametrize("stage", ["a", "b", "c"])
@pytest.mark.parametrize("b,s", [(2, 1024), (1, 352), (13, 352)])
def test_stem_probe_sizes_and_batches(cuda, stage, b, s):
    """S = MAX_SIZE (a 12 KB row a slot); B=1 (11 work items, a block
    each); B=13 (143 items: on an H100's 132 SMs the persistent grid's
    second wave is 11 items, the rest of its blocks idle)."""
    from mobilenet_yolo_tpu_torch.kernels.stem_probe import MAX_SIZE
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import stage_inputs

    assert s <= MAX_SIZE
    x, *wb = stage_inputs(stage, b, s, cuda, seed=s + b)
    _stem_probe_against_twin(x, stage, wb)


@pytest.mark.parametrize("stage", ["a", "b", "c"])
def test_stem_probe_misaligned_base(cuda, stage):
    """A contiguous view one float into its storage: no 16-byte bulk
    copies, the element path."""
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import stage_inputs

    x, *wb = stage_inputs(stage, 3, 64, cuda, seed=9)
    store = torch.empty(x.numel() + 1, device=cuda)
    shifted = store[1:].view_as(x)
    shifted.copy_(x)
    assert shifted.is_contiguous() and shifted.data_ptr() % 16 == 4
    _stem_probe_against_twin(shifted, stage, wb)


def test_stem_probe_stage_c_matches_conv2d(cuda):
    from mobilenet_yolo_tpu_torch.kernels.stem_probe import stem_probe
    from mobilenet_yolo_tpu_torch.tools.probe_stem_cuda import conv_stem, stage_inputs, tolerance

    args = stage_inputs("c", 2, 64, cuda, seed=3)
    got, want = stem_probe(args[0], "c", *args[1:]), conv_stem(*args)
    err = float((got.float() - want.float()).abs().max())
    assert err <= tolerance("c", want), err


def test_stem_probe_rejects_what_it_does_not_take(cuda):
    from mobilenet_yolo_tpu_torch.kernels.stem_probe import stem_probe

    with pytest.raises(ValueError, match="S even"):
        stem_probe(torch.zeros((1, 15, 45), device=cuda), "a")
    with pytest.raises(ValueError, match="w on cpu"):
        stem_probe(torch.zeros((1, 16, 48), device=cuda), "c", torch.zeros(9, 3, 32),
                   torch.zeros(32, device=cuda))


# --------------------------------------------------------- remat on the card

def test_remat_step_matches_the_plain_step(cuda):
    """One width-0.35 float64 step of the remat model against the plain
    model on the same weights and batch: the loss within 1e-6 relative,
    the gradients within 1e-7 of each leaf's largest (the recompute runs
    the same kernels; cuDNN's backward may sum in another order), the
    BatchNorm buffers equal and every count at one."""
    from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
    from mobilenet_yolo_tpu_torch.train import create_train_state, make_train_step

    cfg = {**VOC, "yolo": {**VOC["yolo"], "ignore_thresh": [0.6, 0.56], "iou_thresh": 0.55}}
    rng = np.random.default_rng(4)
    images = torch.from_numpy(rng.normal(size=(4, 96, 96, 3))).to(cuda)
    gt = torch.zeros((4, 8, 5), dtype=torch.float64, device=cuda)
    gt[:, 0] = torch.tensor([1.0, 0.5, 0.5, 0.4, 0.4])
    n_gt = torch.ones(4, dtype=torch.int32, device=cuda)
    runs = {}
    for remat in (False, True):
        model = MBv2YOLO(num_classes=20, width_mult=0.35, remat=remat, dtype=torch.float64,
                         generator=torch.Generator().manual_seed(0)).to(cuda)
        _, metrics = make_train_step(model, cfg)(create_train_state(model), images, gt, n_gt)
        runs[remat] = (float(metrics["loss"]), model)
    (loss_p, plain), (loss_r, remat) = runs[False], runs[True]
    assert abs(loss_r - loss_p) <= 1e-6 * abs(loss_p)
    for (name, p), q in zip(plain.named_parameters(), remat.parameters()):
        assert float((p.grad - q.grad).abs().max()) <= 1e-7 * float(p.grad.abs().max()) + 1e-12, name
    want, got = plain.state_dict(), remat.state_dict()
    for key in want:
        if "running" in key or "num_batches" in key:
            assert torch.equal(got[key], want[key]), key
        if key.endswith("num_batches_tracked"):
            assert int(got[key]) == 1, key


# ------------------------------------------------- the training loop on the card


def _fit_shard(root, n=16):
    """``n`` JPEG records of 64x72, one box each of class 1-3."""
    import cv2

    from mobilenet_yolo_tpu_torch.data.records import RecordWriter

    rng = np.random.default_rng(0)
    with RecordWriter(str(root)) as w:
        for i in range(n):
            img = rng.integers(0, 255, (64, 72, 3), np.uint8)
            labels = np.asarray([[1 + i % 3, *rng.uniform(0.3, 0.7, 2), 0.4, 0.5]], np.float32)
            w.append_record(cv2.imencode(".jpg", img)[1].tobytes(), labels)
    return str(root)


FIT_CFG = {"img_w": 64, "img_h": 64, "iou_weighting": 0.02, "expand_scale": 1.5,
           "normalize": {"mean": [0.5] * 3, "std": [1.0] * 3},
           "yolo": {"num_classes": 3, "num_anchors": 3, "ignore_thresh": [0.6, 0.55],
                    "iou_thresh": 0.55, "mask": [[0, 1, 2], [3, 4, 5]],
                    "anchors": [[18, 22], [24, 24], [30, 28], [6, 8], [10, 12], [14, 10]]}}


def _geometry_trainer(device, ckdir, every=0):
    from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
    from mobilenet_yolo_tpu_torch.train.loop import Trainer, TrainerConfig

    model = MBv2YOLO(num_classes=3, width_mult=0.35, generator=torch.Generator().manual_seed(0))
    tcfg = TrainerConfig(epochs=2, learning_rate=1e-3, checkpoint_dir=str(ckdir),
                         tensorboard_dir=None, eval_every=2, checkpoint_every_batches=every)
    return Trainer(model, FIT_CFG, ["background", "a", "b", "c"], tcfg, verbose=False,
                   device_normalize=True, device_geometry=True, device=device)


def _geometry_loaders(shard):
    norm = FIT_CFG["normalize"]
    train = Loader(DetectionDataset(RecordReader(shard), phase="train", expand_scale=1.5,
                                    apply_photometric=False), 4, [[64, 64]], norm["mean"],
                   norm["std"], mosaic_num=[1], max_gt=10, prefetch=0, seed=3,
                   output_uint8=True, device_geometry=True)
    test = Loader(DetectionDataset(RecordReader(shard), phase="test"), 4, [[64, 64]],
                  norm["mean"], norm["std"], shuffle=False, pad_final=False, output_uint8=True)
    return train, test


def test_geometry_fit_checkpoint_restores_on_the_cpu(cuda, tmp_path):
    """A 2-epoch ``Trainer.fit`` on the card in geometry mode (the
    ``aug_compose`` kernel, once per step; the scan once per eval batch):
    its last checkpoint restores on the CPU, every tensor equal to the
    card's, and into a CPU trainer's state."""
    from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager

    shard = _fit_shard(tmp_path / "shard")
    trainer = _geometry_trainer(cuda, tmp_path / "ck")
    train, test = _geometry_loaders(shard)
    before = (aug_compose.launches, suppress.launches)
    best = trainer.fit(lambda: train, lambda: test)
    torch.cuda.synchronize()
    assert np.isfinite(best)
    assert aug_compose.launches - before[0] == 8       # 2 epochs of 4 batches
    assert suppress.launches - before[1] == 4          # one eval of 4 batches
    raw = CheckpointManager(str(tmp_path / "ck")).restore_latest_raw()
    assert raw["epoch"] == 2
    card = trainer.model.state_dict()
    for k, v in raw["model"].items():
        assert v.device.type == "cpu" and torch.equal(v, card[k].cpu()), k
    cpu_trainer = _geometry_trainer("cpu", tmp_path / "ck")
    assert cpu_trainer.maybe_resume() and cpu_trainer.state.epoch == 2
    for k, v in cpu_trainer.model.state_dict().items():
        assert torch.equal(v, card[k].cpu()), k


def test_geometry_resume_on_the_card(cuda, tmp_path):
    """The port's mid-epoch resume on the card: run C, restored from run B's
    snapshot after batch 1 of epoch 1, against the uninterrupted run A.
    cuDNN's backward may sum in another order from run to run, and A's
    four steps and the three of B that C starts from are separate runs, so
    the parameters are held within 2 * lr per step (an AdamW update moves a
    weight by about lr at most) and the largest difference is printed;
    epoch, batch and step counts exactly."""
    from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager

    shard = _fit_shard(tmp_path / "shard", n=8)

    def run(trainer):
        train, test = _geometry_loaders(shard)
        trainer.fit(lambda: train, lambda: test)
        return dict(trainer.model.named_parameters()), trainer.state

    a, a_state = run(_geometry_trainer(cuda, tmp_path / "a"))
    run(_geometry_trainer(cuda, tmp_path / "b", every=1))
    c_trainer = _geometry_trainer(cuda, tmp_path / "c", every=1)
    c_trainer.state = CheckpointManager(str(tmp_path / "b")).restore(1_000_001, c_trainer.state)
    assert (c_trainer.state.epoch, c_trainer.state.batch_idx) == (1, 1)
    c, c_state = run(c_trainer)
    assert c_state.optimizer_steps() == a_state.optimizer_steps() == 4
    worst = max(float((a[k] - c[k]).detach().abs().max()) for k in a)
    print(f"resumed vs uninterrupted, largest parameter difference: {worst:.3g}")
    assert worst <= 2 * 1e-3 * 4


def test_entry_points_raise_without_a_card(cuda, tmp_path, monkeypatch):
    """``Trainer``, ``cli/train.py`` and ``cli/eval.py`` asked for ``cuda``
    where no card is visible raise rather than carry on on the CPU."""
    from mobilenet_yolo_tpu_torch.cli import eval as cli_eval
    from mobilenet_yolo_tpu_torch.cli import train as cli_train

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        _geometry_trainer("cuda", tmp_path / "ck")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_train.main(cli_train.get_params(["--synthetic", "-c", str(tmp_path / "ck")]))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        cli_eval.main(["--random-weights"])


# ------------------------------------- pruned widths, MBv3 and slimming


def _random_plan(round_to: int, seed: int) -> dict:
    """The ``prune:`` block of a half cut of the VOC MBv2 along random
    |gamma| (``prune.plan_prune``): hidden widths that are multiples of
    ``round_to``, odd ones among them with ``round_to`` 1."""
    from mobilenet_yolo_tpu_torch import prune

    state = build_model(VOC, device="cpu", generator=torch.Generator().manual_seed(seed)
                        ).state_dict()
    rng = np.random.default_rng(seed)
    for site in prune.prunable_gammas(state):
        key = prune._gamma_key(site)
        state[key] = torch.from_numpy(rng.uniform(0.0, 1.0, state[key].numel())).float()
    _, cfg = prune.apply_prune(state, prune.plan_prune(state, 0.5, round_to=round_to))
    return cfg


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("round_to", [8, 1])
def test_fused_block_kernels_at_a_pruned_plans_widths(cuda, round_to, dtype):
    """Kernels 2-3 against their twins at every block shape of a pruned
    VOC backbone at 352x352: hidden widths off every 24- and 48-channel
    chunk, and odd ones (``--round-to 1``), which the wrappers take as
    they are (element copies)."""
    cfg = _random_plan(round_to, seed=round_to)
    widths = [w for w in cfg["backbone_hidden"] if w]
    assert any(w % 48 for w in widths) and (round_to == 8 or any(w % 2 for w in widths))
    backbone = build_model(dict(VOC, prune=cfg), device="cpu").backbone
    for names, kernel, x_shape, ch, cout, residual in block_shapes(backbone, 2, 352)[1:]:
        args = _fused_args(ch + cout, *x_shape, ch, cout, dtype, cuda)
        wrapper = getattr(fb, kernel)
        stride = 2 if kernel.endswith("s2") else 1
        before = wrapper.launches
        got = wrapper(*args, residual=residual) if stride == 1 else wrapper(*args)
        torch.cuda.synchronize()
        assert wrapper.launches == before + 1, names
        want = fb.inverted_residual_reference(*args, residual=residual, stride=stride)
        _assert_fused_close(got, want, dtype)


@pytest.mark.parametrize("dtype", [None, torch.bfloat16])
def test_folded_odd_width_plan_serves_through_the_fused_kernels(cuda, dtype):
    """A ``--round-to 1`` plan folded: its odd hidden widths reach the
    kernels zero-padded to a multiple of 8 (exact), every block launches
    its kernel, and the folded heads match the unfolded float32 heads on
    the init weights (float32 1e-4, bf16 5e-2 relative to the largest, as
    ``chip_smoke.py``'s INIT_FOLD_CASES)."""
    cfg = dict(VOC, prune=_random_plan(1, seed=5))
    model = build_model(cfg, generator=torch.Generator().manual_seed(6)).eval()
    model.to(memory_format=torch.channels_last)
    folded = fold_batchnorm(model)
    x = torch.randn((2, 3, 352, 352), device=cuda).to(memory_format=torch.channels_last)
    with torch.no_grad():
        want = model(x)
        before = {k: getattr(fb, k).launches for k in ("fused_stem_block0",
                                                       "fused_inverted_residual_s2",
                                                       "fused_inverted_residual")}
        with torch.autocast("cuda", dtype=dtype or torch.float32, enabled=dtype is not None):
            got = folded(x)
        torch.cuda.synchronize()
    launched = {k: getattr(fb, k).launches - n for k, n in before.items()}
    assert launched == {"fused_stem_block0": 1, "fused_inverted_residual_s2": 4,
                        "fused_inverted_residual": 12}
    tol = 1e-4 if dtype is None else 5e-2
    for key in want:
        err = float((got[key].float() - want[key]).abs().max() / want[key].abs().max())
        assert err <= tol, (key, err)


@pytest.mark.parametrize("backbone", ["mbv3", "mbv3_macc"])
def test_mbv3_predict_cuda_matches_cpu(cuda, backbone):
    """MBv3 through ``make_predict_fn`` (the NMS kernel on the card), card
    vs CPU in float64 with calibrated BatchNorm statistics, as
    ``test_predict_cuda_matches_cpu``: ``keep`` equal, kept detections
    within rtol 1e-5, atol 1e-6 (decode in float32)."""
    rng = np.random.default_rng(7)
    model = build_model(VOC, backbone, device="cpu", generator=torch.Generator().manual_seed(0))
    for bn in (m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)):
        bn.momentum = None
    with torch.no_grad():
        model.train()(torch.from_numpy(rng.normal(size=(2, 3, 96, 96)).astype(np.float32)))
    model.eval().double()
    images = torch.from_numpy(rng.normal(size=(2, 96, 96, 3)))
    val_conf = torch.tensor(0.3)
    dets_cpu, keep_cpu = make_predict_fn(model, VOC)(images, val_conf)
    model.to(cuda)
    before = suppress.launches
    dets, keep = make_predict_fn(model, VOC)(images.to(cuda), val_conf.to(cuda))
    torch.cuda.synchronize()
    assert suppress.launches == before + 1
    keep_cpu = keep_cpu.numpy()
    assert 0 < keep_cpu.sum() < (dets_cpu[..., 4] > 0.3).sum().item()
    np.testing.assert_array_equal(keep.cpu().numpy(), keep_cpu)
    np.testing.assert_allclose(dets.cpu().numpy()[keep_cpu], dets_cpu.numpy()[keep_cpu],
                               atol=1e-6, rtol=1e-5)


SLIM_CFG = {"iou_weighting": 0.02, "slim_l1": 1e-2, "slim_mode": "prox",
            "yolo": {"num_classes": 3, "num_anchors": 3, "ignore_thresh": [0.6, 0.55],
                     "iou_thresh": 0.55,
                     "anchors": [[18, 22], [24, 24], [30, 28], [6, 8], [10, 12], [14, 10]],
                     "mask": [[0, 1, 2], [3, 4, 5]]}}


def test_prox_step_on_the_card_matches_the_cpu(cuda):
    """Two ``make_train_step`` steps with ``slim_mode: prox`` on the
    width-0.35 MBv2-YOLO in float64, card against CPU, a third of the
    prunable gammas small enough to be shrunk to 0: the same gammas are 0
    on both, and every gamma agrees within 1e-4 (the YOLO loss is float32,
    whose reductions run in other orders on the card, and Adam's update
    lr * m_hat / sqrt(v_hat) moves by a share of lr = 7e-4 where a gradient
    is small against the largest; ``tests/test_torch_prune.py`` holds the
    same bound against JAX)."""
    from mobilenet_yolo_tpu_torch import prune
    from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
    from mobilenet_yolo_tpu_torch.train import create_train_state, make_train_step

    rng = np.random.default_rng(8)
    cpu = MBv2YOLO(num_classes=3, width_mult=0.35, dtype=torch.float64,
                   generator=torch.Generator().manual_seed(9))
    state = cpu.state_dict()
    keys = [prune._gamma_key(s) for s in prune.prunable_gammas(state)]
    for key in keys:
        small = torch.from_numpy(rng.random(state[key].numel()) < 1 / 3)
        state[key][small] = 1e-4
    card = copy.deepcopy(cpu).to(cuda)
    x = rng.normal(0, 1, (4, 32, 32, 3))
    gt = np.zeros((4, 6, 5))
    gt[..., 0] = rng.integers(1, 4, (4, 6))
    gt[..., 1:3] = rng.uniform(0.2, 0.8, (4, 6, 2))
    gt[..., 3:5] = rng.uniform(0.1, 0.5, (4, 6, 2))
    n_gt = np.asarray([2, 0, 3, 6], np.int32)
    params = {}
    for model, device in ((cpu, torch.device("cpu")), (card, cuda)):
        step, st = make_train_step(model, SLIM_CFG), create_train_state(model)
        args = [torch.from_numpy(a).to(device) for a in (x, gt, n_gt)]
        for _ in range(2):
            st, _ = step(st, *args)
        named = dict(model.named_parameters())
        params[device.type] = {k: named[k].detach().cpu() for k in keys}
    zeros = 0
    for key in keys:
        want, got = params["cpu"][key], params["cuda"][key]
        assert torch.equal(got == 0, want == 0), key
        assert float((got - want).abs().max()) <= 1e-4, key
        zeros += int((want == 0).sum())
    assert zeros > 0


# ------------------------------------ kernels 1-4 as registered ops, exported

def _op_cases(cuda):
    """Each registered op with CUDA arguments at a small shape."""
    over, valid = random_over(3, 2, 64, 0.2)
    block = _fused_args(11, 2, 16, 16, 32, 192, 32, torch.float32, cuda)
    stem = _fused_args(12, 2, 32, 32, 3, 32, 16, torch.float32, cuda, stem=True)
    return {"nms_suppress": (over.to(cuda), valid.to(cuda)),
            "fused_inverted_residual": (*block, True),
            "fused_inverted_residual_s2": tuple(block),
            "fused_stem_block0": tuple(stem)}


@pytest.mark.parametrize("name", ["nms_suppress", "fused_inverted_residual",
                                  "fused_inverted_residual_s2", "fused_stem_block0"])
def test_opcheck_on_cuda_tensors(cuda, name):
    """The CUDA implementation of each op (the kernel's launch) passes
    ``torch.library.opcheck``: schema, fake against real shapes and
    strides, autograd registration, dispatch."""
    torch.library.opcheck(getattr(torch.ops.myt, name).default, _op_cases(cuda)[name])
    torch.cuda.synchronize()


def test_exported_folded_predict_launches_kernels_1_to_4(cuda, tmp_path):
    """A folded VOC predict exported with ``tools/export.py``'s
    ``export_predict``, saved and loaded: each call of the loaded program
    launches the NMS scan once and the fused blocks 1 + 4 + 12 times, and
    its outputs equal the eager predict's (``keep`` equal, ``dets`` within
    1e-5: the same kernels and convolutions on the same inputs)."""
    from mobilenet_yolo_tpu_torch.models.bn_fold import calibrate_bn
    from mobilenet_yolo_tpu_torch.tools.export import export_predict

    model = build_model(VOC, generator=torch.Generator().manual_seed(0))
    images = torch.randn((2, 96, 96, 3), generator=torch.Generator().manual_seed(1)).to(cuda)
    calibrate_bn(model, images)
    folded = fold_batchnorm(model)
    val_conf = torch.tensor(0.3, device=cuda)
    path = str(tmp_path / "folded.pt2")
    torch.export.save(export_predict(folded, VOC, images, val_conf), path)
    program = torch.export.load(path).module()
    want_dets, want_keep = make_predict_fn(folded, VOC)(images, val_conf)
    counts, nms = _fused_counts(), suppress.launches
    dets, keep = program(images, val_conf)
    torch.cuda.synchronize()
    assert [a - b for a, b in zip(_fused_counts(), counts)] == [1, 4, 12]
    assert suppress.launches - nms == 1
    assert torch.equal(keep, want_keep) and 0 < int(keep.sum())
    assert float((dets - want_dets).abs().max()) <= 1e-5


# ------------------------------------------------------------ parallelism


def test_nccl_world_of_one_runs_the_data_parallel_step_and_predict(cuda, tmp_path):
    """The backend the port picks for the card (NCCL) at world size 1: a
    data-parallel geometry step and the sharded predict on a 1x1 mesh run
    every collective on the card (NCCL refuses host tensors) and give the
    one-process results: a sum over one rank is the identity, and the two
    runs differ only by the card's own run-to-run rounding (cuDNN's
    backward), so the losses and parameters within JAX's DP tolerances
    (rtol 2e-4; one flipped AdamW step, 2.5e-3) and the predict within
    ``test_mesh_sharded_predict_matches_single_device``'s."""
    import torch.distributed as dist
    from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
    from mobilenet_yolo_tpu_torch.parallel import create_mesh
    from mobilenet_yolo_tpu_torch.parallel.mesh import default_backend, join_process_group
    from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                                make_geometry_train_step)

    assert default_backend(cuda) == "nccl"
    join_process_group(f"file://{tmp_path / 'rendezvous'}", 1, 0, device="cuda")
    try:
        assert dist.get_backend() == "nccl" and torch.cuda.current_device() == 0
        mesh = create_mesh(1, 1)
        cfg = {**VOC, "yolo": {**VOC["yolo"], "ignore_thresh": [0.6, 0.56], "iou_thresh": 0.55}}
        g = _aug_batch(3, 4, 64)
        args = (*(g[k].to(cuda) for k in GEOMETRY_BATCH_KEYS), g["gt"].to(cuda),
                g["n_gt"].to(cuda), 5)
        runs = []
        for grid in (None, mesh):
            model = MBv2YOLO(num_classes=20, width_mult=0.35,
                             generator=torch.Generator().manual_seed(0)).to(cuda)
            step = make_geometry_train_step(model, cfg, fused_aug=True, mesh=grid)
            _, metrics = step(create_train_state(model), *args, out_hw=(64, 64))
            x = torch.rand(4, 64, 64, 3, device=cuda, generator=torch.Generator(cuda).manual_seed(1))
            out = make_predict_fn(model, cfg, top_k=32, mesh=grid)(x, torch.tensor(0.01, device=cuda))
            runs.append((float(metrics["loss"]), model.state_dict(), out))
        (loss0, sd0, out0), (loss1, sd1, out1) = runs
        assert abs(loss1 - loss0) <= 2e-4 * abs(loss0)
        for k, v in sd0.items():
            torch.testing.assert_close(sd1[k], v, rtol=0, atol=2.5e-3, msg=k)
        torch.testing.assert_close(out1[0], out0[0], rtol=1e-4, atol=1e-5)
        assert torch.equal(out1[1], out0[1])
    finally:
        dist.destroy_process_group()


_GLOO_RANK = r"""
import sys
import numpy as np, torch, torch.distributed as dist
from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose, aug_compose_reference
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug, slot_aug_reference
from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose, shard_seed
from mobilenet_yolo_tpu_torch.parallel import create_mesh, global_batch, initialize_distributed
from mobilenet_yolo_tpu_torch.train import GEOMETRY_BATCH_KEYS, random_geometry_batch
from mobilenet_yolo_tpu_torch.train.step import augment_geometry

rank, port = int(sys.argv[1]), int(sys.argv[2])
assert initialize_distributed(f"localhost:{port}", 2, rank, backend="gloo", device="cuda")
mesh = create_mesh(2, 1)
rng = np.random.default_rng(5)
batch = random_geometry_batch(rng, 4, 64)
batch["noise_gate"] = batch["active"].copy()
batch["noise_scale"] = np.where(batch["active"], 6.0, 0.0).astype(np.float32)
dev = torch.device("cuda", 0)
g = global_batch(mesh, tuple(torch.from_numpy(batch[k]).to(dev) for k in GEOMETRY_BATCH_KEYS))
(slots, src, dst, fill, color, ffm, flip, active, gate, scale, pc, ops, facs) = g
seed = shard_seed(2 ** 31 - 1, rank)
launches = aug_compose.launches
got = augment_geometry(g, 2 ** 31 - 1, (64, 64), True, mesh=mesh)
torch.cuda.synchronize()
assert aug_compose.launches == launches + 1
want = aug_compose_reference(slots, seed, gate, scale, pc, ops, facs, src, dst, fill, color, ffm,
                             flip, active, (64, 64))
d = (got.float() - want.float()).abs()
assert float(d.max()) <= 1.0 and float(d.mean()) < 0.05, (float(d.max()), float(d.mean()))
launches = slot_aug.launches
split = augment_geometry(g, 2 ** 31 - 1, (64, 64), "split", mesh=mesh)
torch.cuda.synchronize()
assert slot_aug.launches == launches + 1
n = slots.shape[0] * slots.shape[1]
planar = slot_aug_reference(slots.reshape(n, 64, 64, 3), seed, gate.reshape(n), scale.reshape(n),
                            pc.reshape(n), ops.reshape(n, -1), facs.reshape(n, -1))
want = geometric_compose(planar.reshape(slots.shape[0], -1, 3, 64, 64), src, dst, fill, color, ffm,
                         flip, active, (64, 64), dtype=torch.bfloat16, planar=True)
d = (split.float() - want.float()).abs()
assert float(d.max()) <= 1.0 and float(d.mean()) < 0.05, (float(d.max()), float(d.mean()))
# the two ranks' noise differs: their images are not equal
mine = got.float().contiguous()
other = [torch.empty_like(mine) for _ in range(2)]
dist.all_gather(other, mine)
assert not torch.equal(other[0], other[1])
dist.destroy_process_group()
"""


def test_two_gloo_ranks_on_one_card_take_their_shard_seeds(cuda):
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), each augmenting its rows of a global geometry batch with noise
    on: kernel 6 (and kernel 5 in "split" mode) launches under the rank's
    ``shard_seed``, held against the twin on the same seed (the kernels'
    tolerance above)."""
    import os
    import socket

    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    root = Path(__file__).resolve().parent.parent
    env = dict(os.environ, PYTHONPATH=os.pathsep.join(
        p for p in (str(root), os.environ.get("PYTHONPATH")) if p))
    procs = [subprocess.Popen([sys.executable, "-c", _GLOO_RANK, str(r), str(port)], cwd=root,
                              env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for r in range(2)]
    outs = [p.communicate(timeout=300)[0] for p in procs]
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-4000:]
