"""The port's parallel layer in one process, against the JAX package's:
``parallel/mesh.py`` (spec parsing, process-group bring-up, the rows of a
host-complete batch), ``parallel/sharding.py``'s split rule, the per-shard
noise seed of the geometry step and the global-batch BatchNorm's arithmetic
(a one-rank gloo group). The multi-process jobs are
``tests/test_torch_multiprocess.py``.
"""

import datetime
import types

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from mobilenet_yolo_tpu.models import MBv2YOLO as JaxMBv2YOLO
from mobilenet_yolo_tpu.parallel import mesh as j_mesh
from mobilenet_yolo_tpu.parallel.sharding import _leaf_sharding
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict
from mobilenet_yolo_tpu_torch.kernels.aug_compose import aug_compose
from mobilenet_yolo_tpu_torch.kernels.slot_aug import slot_aug
from mobilenet_yolo_tpu_torch.models import layers as tl
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.ops.device_augment import shard_seed, slot_noise
from mobilenet_yolo_tpu_torch.parallel import mesh
from mobilenet_yolo_tpu_torch.parallel.sharding import _split_modules, leaf_is_split
from mobilenet_yolo_tpu_torch.train.step import GEOMETRY_BATCH_KEYS, augment_geometry

from _torch_parity import geometry_batch, jax_init


def _t(x):
    return torch.from_numpy(np.asarray(x).copy())


# ------------------------------------------------------------------ mesh --


@pytest.mark.parametrize("spec,batch_size", [
    ("none", None), ("off", None), ("1", None), (None, 16), ("auto", 16), ("auto", None),
    ("8", 16), ("4x2", None), ("2x2", 8), ("1x2", 3), ("auto", 12), ("16", None), ("4x4", None),
    ("4", 6),
])
def test_mesh_shape_matches_jax_mesh_from_spec(spec, batch_size):
    """``test_sharding.py:test_mesh_from_spec``'s cases and more, the world
    size in place of JAX's 8 devices: the same shape, or ``ValueError``
    with the same message."""
    try:
        jm = j_mesh.mesh_from_spec(spec, batch_size=batch_size)
    except ValueError as err:
        with pytest.raises(ValueError) as got:
            mesh.mesh_shape(spec, 8, batch_size)
        assert str(got.value) == str(err)
        return
    want = None if jm is None else (jm.shape["data"], jm.shape["model"])
    assert mesh.mesh_shape(spec, 8, batch_size) == want


def test_global_batch_takes_the_rows_jax_places_on_the_data_index():
    """JAX's ``global_batch`` on a 4x2 mesh puts rows [2d, 2d + 2) of an
    8-row batch on the devices of data index d (both model indices); the
    port's rank at data index d takes the same rows, and a 0-d leaf whole."""
    jm = j_mesh.create_mesh(n_data=4, n_model=2)
    x = np.arange(8 * 3).reshape(8, 3)
    placed = j_mesh.global_batch(jm, x)
    grid = np.asarray(jm.devices)
    for shard in placed.addressable_shards:
        d, m = map(int, np.argwhere(grid == shard.device)[0])
        port = mesh.Mesh(4, 2)
        port.data_index, port.model_index = d, m
        rows, scalar = mesh.global_batch(port, (x, np.float32(0.3)))
        np.testing.assert_array_equal(rows, np.asarray(shard.data))
        assert scalar == np.float32(0.3)
    with pytest.raises(ValueError, match="does not split over the data axis"):
        mesh.global_batch(mesh.Mesh(4, 2), np.zeros((6, 2)))


def test_one_process_mesh_and_bring_up(monkeypatch):
    """Without a process group a 1x1 mesh has no groups and the bring-up is
    a no-op; a job is detected from ``torchrun``'s environment only."""
    assert not mesh.initialize_distributed()
    assert not mesh.initialize_distributed("localhost:1234")
    assert not mesh.initialize_distributed(None, 1, 0)
    with pytest.raises(ValueError, match="needs --coordinator and --process-id"):
        mesh.initialize_distributed(None, 2, None)
    m = mesh.create_mesh(1, 1)
    assert m.shape == {"data": 1, "model": 1} and m.data_group is None
    with pytest.raises(ValueError, match="needs 2 ranks"):
        mesh.create_mesh(2, 1)
    for env, want in (({}, False), ({"WORLD_SIZE": "2"}, False),
                      ({"WORLD_SIZE": "1", "MASTER_ADDR": "h"}, False),
                      ({"WORLD_SIZE": "4", "MASTER_ADDR": "h"}, True)):
        for k in ("WORLD_SIZE", "MASTER_ADDR"):
            monkeypatch.delenv(k, raising=False)
        for k, v in env.items():
            monkeypatch.setenv(k, v)
        assert mesh.multihost_env_detected() is want


def test_rank_device_shares_the_cards_by_local_rank(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setenv("LOCAL_RANK", "3")
    assert mesh.rank_device("cuda") == torch.device("cuda", 1)
    assert mesh.rank_device("cuda:0") == torch.device("cuda", 0)
    assert mesh.rank_device("cpu") == torch.device("cpu")


# -------------------------------------------------------------- sharding --


@pytest.mark.parametrize("width,n_model,min_channels", [
    (0.35, 2, 128), (0.35, 2, 256), (0.35, 4, 64), (1.0, 2, 256), (1.0, 8, 256),
])
def test_split_rule_selects_the_leaves_jax_shards(width, n_model, min_channels):
    """The port's rule on its state dict selects, by flax path, the leaves
    JAX's ``_leaf_sharding`` puts on the model axis (its ``shape[-1]`` is
    the torch axis ``convert.flax_last_axis`` names), and it selects whole
    layers."""
    jm = JaxMBv2YOLO(num_classes=3, num_anchors=3, width_mult=width)
    variables = jax_init(jm, np.zeros((1, 32, 32, 3), np.float32))
    grid = j_mesh.create_mesh(n_data=8 // n_model, n_model=n_model)
    want = set()
    for collection in ("params", "batch_stats"):
        flags = jax.tree_util.tree_map(
            lambda leaf: "model" in str(_leaf_sharding(leaf, grid, min_channels).spec),
            variables[collection])
        want |= {k for k, v in flax_to_state_dict({collection: flags}).items() if v.item()}
    model = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=width)
    got = {k for k, t in model.state_dict().items() if leaf_is_split(t, n_model, min_channels)}
    assert want and got == want
    layers = {name for name, _ in _split_modules(model, n_model, min_channels)}
    assert {k.rsplit(".", 1)[0] for k in got} == layers


# ------------------------------------------------------------- the seed --


@pytest.mark.parametrize("seed", [0, 17, 1234, 2 ** 31 - 1, -2 ** 31, 2 ** 31 - 150_000])
def test_shard_seed_is_jax_int32_arithmetic(seed):
    """``seed + axis_index * 101159`` in int32, as JAX's ``shard_map`` body
    computes it (``device_augment.py:451-452``)."""
    for index in range(8):
        want = jnp.int32(seed) + jnp.asarray(index).astype(jnp.int32) * jnp.int32(101159)
        assert shard_seed(seed, index) == int(want)


def _shard(index: int):
    return types.SimpleNamespace(data_index=index)


def test_a_shard_of_the_plain_mode_draws_its_global_slots():
    """Plain mode: shard d's noise is the global batch's on its slots (GSPMD
    runs the JAX plain path on the global batch)."""
    rng = np.random.default_rng(0)
    slots = _t(rng.integers(0, 255, (4, 2, 8, 8, 3), np.uint8))
    gate = torch.ones(4, 2, dtype=torch.bool)
    scale = _t(rng.uniform(5, 20, (4, 2)).astype(np.float32))
    pc = _t(rng.integers(0, 2, (4, 2)).astype(bool))
    full = slot_noise(slots, 77, gate, scale, pc)
    for d in range(2):
        rows = slice(2 * d, 2 * d + 2)
        got = slot_noise(slots[rows], 77, gate[rows], scale[rows], pc[rows], first_slot=4 * d)
        torch.testing.assert_close(got, full[rows], rtol=0, atol=0)
    geo = geometry_batch(np.random.default_rng(3), 4, 16)
    geo["noise_gate"][:] = True
    geo["noise_scale"][:] = 10.0
    g = tuple(_t(geo[k]) for k in GEOMETRY_BATCH_KEYS)
    full = augment_geometry(g, 5, (16, 16), False)
    for d in range(2):
        local = tuple(t[2 * d:2 * d + 2] for t in g)
        got = augment_geometry(local, 5, (16, 16), False, mesh=_shard(d))
        torch.testing.assert_close(got, full[2 * d:2 * d + 2], rtol=0, atol=0)


def test_the_kernel_modes_take_the_shard_seed():
    """``True`` and ``"split"``: shard d runs the kernel (its twin on CPU
    tensors) on its local slots under ``shard_seed(seed, d)``."""
    geo = geometry_batch(np.random.default_rng(4), 2, 16)
    geo["noise_gate"][:] = True
    geo["noise_scale"][:] = 10.0
    g = tuple(_t(geo[k]) for k in GEOMETRY_BATCH_KEYS)
    (slots, src, dst, fill, color, ffm, flip, active, gate, scale, pc, ops, facs) = g
    seed = shard_seed(2 ** 31 - 1, 1)
    assert seed < 0
    want = aug_compose(slots, seed, gate, scale, pc, ops, facs, src, dst, fill, color, ffm,
                       flip, active, (16, 16))
    torch.testing.assert_close(augment_geometry(g, 2 ** 31 - 1, (16, 16), True, mesh=_shard(1)),
                               want, rtol=0, atol=0)
    n = slots.shape[0] * slots.shape[1]
    planar = slot_aug(slots.reshape(n, 16, 16, 3), seed, gate.reshape(n), scale.reshape(n),
                      pc.reshape(n), ops.reshape(n, -1), facs.reshape(n, -1))
    split = augment_geometry(g, 2 ** 31 - 1, (16, 16), "split", mesh=_shard(1))
    unshifted = augment_geometry(g, 2 ** 31 - 1, (16, 16), "split")
    assert not torch.equal(split, unshifted)
    from mobilenet_yolo_tpu_torch.ops.device_augment import geometric_compose
    torch.testing.assert_close(
        split, geometric_compose(planar.reshape(2, -1, 3, 16, 16), src, dst, fill, color, ffm,
                                 flip, active, (16, 16), dtype=torch.bfloat16, planar=True),
        rtol=0, atol=0)


# ---------------------------------------------------- global BatchNorm --


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank in this process, torn down after the test."""
    dist.init_process_group("gloo", store=dist.HashStore(), rank=0, world_size=1,
                            timeout=datetime.timedelta(seconds=60))
    try:
        yield dist.group.WORLD
    finally:
        dist.destroy_process_group()


def test_global_batchnorm_matches_flax(one_rank_group):
    """``BatchNorm2d._global`` (the data-parallel path; over one rank its sums
    are this rank's) against flax's train-mode BatchNorm in float64: the
    output, its input and parameter gradients and both running statistics
    (rtol 1e-10: both take E[x^2] - E[x]^2)."""
    rng = np.random.default_rng(0)
    x = rng.normal(0.7, 1.5, (3, 4, 5, 6))
    stats = {"mean": rng.normal(0, 0.3, 6), "var": rng.uniform(0.5, 2.0, 6)}
    params = {"scale": rng.uniform(0.8, 1.2, 6), "bias": rng.normal(0, 0.1, 6)}
    cot = rng.normal(0, 1, x.shape)
    with jax.enable_x64(True):
        bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5,
                           dtype=jnp.float64, param_dtype=jnp.float64)

        def f(p, xx):
            y, mut = bn.apply({"params": p, "batch_stats": stats}, xx, mutable=["batch_stats"])
            return jnp.sum(y * cot), (y, mut["batch_stats"])

        (_, (want_y, want_stats)), (g_p, g_x) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(params, x)
    layer = tl.BatchNorm2d(6, eps=tl.BN_EPS, momentum=tl.BN_MOMENTUM, dtype=torch.float64)
    with torch.no_grad():
        layer.weight.copy_(_t(params["scale"]))
        layer.bias.copy_(_t(params["bias"]))
        layer.running_mean.copy_(_t(stats["mean"]))
        layer.running_var.copy_(_t(stats["var"]))
    xt = _t(x).permute(0, 3, 1, 2).requires_grad_()
    layer.process_group = one_rank_group
    y = layer.train()._global(xt)
    (y * _t(cot).permute(0, 3, 1, 2)).sum().backward()
    close = dict(rtol=1e-10, atol=1e-12)
    np.testing.assert_allclose(y.detach().permute(0, 2, 3, 1).numpy(), want_y, **close)
    np.testing.assert_allclose(xt.grad.permute(0, 2, 3, 1).numpy(), g_x, **close)
    np.testing.assert_allclose(layer.weight.grad.numpy(), g_p["scale"], **close)
    np.testing.assert_allclose(layer.bias.grad.numpy(), g_p["bias"], **close)
    np.testing.assert_allclose(layer.running_mean.numpy(), want_stats["mean"], **close)
    np.testing.assert_allclose(layer.running_var.numpy(), want_stats["var"], **close)
    assert int(layer.num_batches_tracked) == 1


def test_a_group_of_one_keeps_the_one_process_batchnorm(one_rank_group):
    """With a one-rank ``process_group`` the layer takes the one-process
    path: the same output and buffers, bit for bit."""
    x = _t(np.random.default_rng(1).normal(0.3, 1.2, (2, 6, 5, 5)).astype(np.float32))
    outs = []
    for group in (None, one_rank_group):
        layer = tl.BatchNorm2d(6, eps=tl.BN_EPS, momentum=tl.BN_MOMENTUM).train()
        tl.set_process_group(layer, group)
        outs.append((layer(x), layer.running_mean.clone(), layer.running_var.clone()))
    for a, b in zip(*outs):
        assert torch.equal(a, b)
