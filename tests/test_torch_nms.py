"""The port's NMS against the JAX package's, on the CPU.

The scan is pure boolean logic, so every comparison here is bit-equal: the
plain twin ``suppress_reference`` against the Pallas kernel in interpret
mode and against the XLA ``_suppress_scan``, and ``batched_nms`` against
the JAX ``batched_nms`` on identical decoded ``preds`` (the top-K order,
the gathered detections and the keep mask). The CUDA kernel itself is held
against the twin on the card (``test_torch_cuda.py``, ``chip_smoke.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.kernels.pallas_nms import pallas_suppress
from mobilenet_yolo_tpu.ops.nms import _suppress_scan
from mobilenet_yolo_tpu.ops.nms import batched_nms as jax_batched_nms
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.ops.nms import batched_nms

import _torch_parity  # noqa: F401  (sets the test thread count)


def random_over(rng, b, k, density=0.1):
    over = (rng.random((b, k, k)) < density).astype(np.float32)
    over *= np.triu(np.ones((k, k), np.float32), 1)  # strictly later, as batched_nms builds it
    valid = (rng.random((b, k)) < 0.8).astype(np.float32)
    return over, valid


def chain_case(k=128):
    """a suppresses b, b would suppress c: c survives because b is dead."""
    over = np.zeros((1, k, k), np.float32)
    over[0, 0, 1] = over[0, 1, 2] = 1.0
    valid = np.zeros((1, k), np.float32)
    valid[0, :3] = 1.0
    return over, valid


@pytest.mark.parametrize("case", ["random_k128", "random_k60", "chain"])
def test_suppress_reference_matches_pallas_and_xla_scan(case):
    rng = np.random.default_rng(0)
    over, valid = {"random_k128": lambda: random_over(rng, 2, 128),
                   "random_k60": lambda: random_over(rng, 3, 60, density=0.3),
                   "chain": chain_case}[case]()
    got = suppress_reference(torch.from_numpy(over), torch.from_numpy(valid)).numpy()
    pallas = np.asarray(pallas_suppress(jnp.asarray(over), jnp.asarray(valid),
                                        interpret=True))
    xla = np.asarray(jax.vmap(_suppress_scan)(jnp.asarray(over), jnp.asarray(valid) > 0.5))
    np.testing.assert_array_equal(got, pallas)
    np.testing.assert_array_equal(got, xla)
    if case == "chain":
        assert got[0, :3].tolist() == [True, False, True] and not got[0, 3:].any()


def test_suppress_on_cpu_is_the_reference_and_counts_no_launch():
    over, valid = random_over(np.random.default_rng(1), 2, 64)
    before = suppress.launches
    got = suppress(torch.from_numpy(over), torch.from_numpy(valid))
    assert suppress.launches == before
    np.testing.assert_array_equal(
        got.numpy(), suppress_reference(torch.from_numpy(over), torch.from_numpy(valid)).numpy())


@pytest.mark.parametrize("bad,match", [
    (lambda o, v: (o.double(), v), "float32"),
    (lambda o, v: (o, v.bool()), "float32"),
    (lambda o, v: (o[:, :, :-1], v), r"\(B, K, K\)"),
    (lambda o, v: (o, v[:1]), r"\(B, K, K\)"),
    (lambda o, v: (o[0], v[0]), r"\(B, K, K\)"),
    (lambda o, v: (o.transpose(1, 2), v), "contiguous"),
    (lambda o, v: (torch.zeros(1, 1025, 1025), torch.zeros(1, 1025)), "K <= 1024"),
    (lambda o, v: (torch.zeros(0, 4, 4), torch.zeros(0, 4)), "B >= 1"),
    (lambda o, v: (o.to("meta"), v.to("meta")), "CPU or CUDA"),
    (lambda o, v: (o, v.to("meta")), "valid on meta"),
])
def test_suppress_rejects_bad_input(bad, match):
    over, valid = random_over(np.random.default_rng(2), 2, 8)
    with pytest.raises((TypeError, ValueError), match=match):
        suppress(*bad(torch.from_numpy(over), torch.from_numpy(valid)))


def random_preds(seed, b, n, num_classes=3, ties=False):
    """Decoded candidates clustered so that same-class boxes overlap."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (b, n, 2))
    sizes = rng.uniform(0.1, 0.4, (b, n, 2))
    conf = rng.uniform(0.0, 1.0, (b, n))
    score = rng.uniform(0.2, 1.0, (b, n))
    if ties:  # exact ties in conf * cls_score: the order must follow the index
        conf = np.round(conf * 4) / 4
        score = np.full((b, n), 0.5)
    cls = rng.integers(0, num_classes, (b, n))
    preds = np.concatenate([centers - sizes / 2, centers + sizes / 2,
                            conf[..., None], score[..., None], cls[..., None]], -1)
    return preds.astype(np.float32)


@pytest.mark.parametrize("b,n,ties", [(2, 60, False), (2, 300, False), (2, 300, True)])
def test_batched_nms_matches_jax(b, n, ties):
    preds = random_preds(3, b, n, ties=ties)
    val_conf = 0.3
    want_dets, want_keep = jax_batched_nms(jnp.asarray(preds), jnp.float32(val_conf))
    dets, keep = batched_nms(torch.from_numpy(preds), torch.tensor(val_conf))
    assert dets.shape == (b, min(256, n), 7) and keep.dtype == torch.bool
    np.testing.assert_array_equal(dets.numpy(), np.asarray(want_dets))
    np.testing.assert_array_equal(keep.numpy(), np.asarray(want_keep))
    assert 0 < keep.sum() < (preds[..., 4] > val_conf).sum()  # NMS did suppress
