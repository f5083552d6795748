"""The port on the card: the CUDA NMS kernel against its plain twin.

Every test here needs an NVIDIA GPU and ``nvcc`` (the kernel builds from
``mobilenet_yolo_tpu_torch/csrc/`` at first use) and skips elsewhere. The
file imports neither JAX nor the JAX package, so it runs on a machine that
has only PyTorch; the repository's ``conftest.py`` imports JAX, hence:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py -q

The scan is boolean logic, so the kernel must equal the twin bit for bit.
"""

import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms

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
    model = build_model(VOC, generator=torch.Generator().manual_seed(0))
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
