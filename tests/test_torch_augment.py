"""The port's device augmentation against the JAX package's, on the CPU.

The plain ops (``planned_color_jitter``, ``geometric_compose`` HWC and
planar, ``seg_compose``) are held against ``ops/device_augment.py``; the
plain twins of the two CUDA kernels against the Pallas kernels in
interpret mode (``kernels/pallas_aug.py``), which is how the JAX package's
own tests run them on the CPU. The kernels themselves run only on the card
(``tests/test_torch_cuda.py``).

Each tolerance is stated where it is used.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.data import augment as host_aug
from mobilenet_yolo_tpu.kernels.pallas_aug import fused_slot_aug
from mobilenet_yolo_tpu.ops import device_augment as j_aug
from mobilenet_yolo_tpu.train.step import GEOMETRY_BATCH_KEYS
from mobilenet_yolo_tpu_torch.kernels import aug_compose as k6
from mobilenet_yolo_tpu_torch.kernels import slot_aug as k5
from mobilenet_yolo_tpu_torch.ops import device_augment as aug
from mobilenet_yolo_tpu_torch.train.step import augment_geometry

from _torch_parity import geometry_batch


def _programs(rng, n):
    """n host-planned programs, the last two forced to carry a negative
    and a positive hue delta (floor-mod of a negative operand)."""
    plans = [host_aug.sample_photometric(rng) for _ in range(n)]
    ops = np.stack([p[0] for p in plans]).astype(np.int32)
    facs = np.stack([p[1] for p in plans]).astype(np.float32)
    ops[-2:] = [[1, 3, -1, 0, 4], [3, 2, 1, -1, -1]]
    facs[-2:] = [[1.3, -0.06, 1.0, 0.8, 1.2], [0.05, 1.4, 0.6, 1.0, 1.0]]
    return ops, facs


def _geo(batch, keys=GEOMETRY_BATCH_KEYS):
    return {k: torch.from_numpy(np.ascontiguousarray(batch[k])) for k in keys}


# -------------------------------------------------------------- plain ops


def test_planned_color_jitter_matches_jax(rng):
    """float32 programs (every op, both hue signs) equal JAX's to atol 1e-3
    of 255: the same f32 formulas, reductions summed in another order."""
    n, s = 8, 24
    images = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    ops, facs = _programs(rng, n)
    want = np.asarray(j_aug.planned_color_jitter(jnp.asarray(images), jnp.asarray(ops),
                                                 jnp.asarray(facs)))
    got = aug.planned_color_jitter(torch.from_numpy(images), torch.from_numpy(ops),
                                   torch.from_numpy(facs))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_geometric_compose_matches_jax(rng):
    """The HWC compose of a planner batch (1-tile and 4-tile images, flips,
    crops, mean and constant fills) with the programs applied per source,
    float32: atol 1e-3 of 255 against JAX."""
    batch = geometry_batch(rng, 4, 32)
    g = _geo(batch)
    keys = GEOMETRY_BATCH_KEYS[1:8]
    # jitted: eagerly the vmapped compose dispatches for ~10 s
    compose = jax.jit(lambda *a: j_aug.geometric_compose(*a[:8], (40, 36), jitter_op=a[8],
                                                         jitter_factor=a[9]))
    want = np.asarray(compose(*(jnp.asarray(batch[k]) for k in GEOMETRY_BATCH_KEYS[:8]),
                              jnp.asarray(batch["jitter_op"]), jnp.asarray(batch["jitter_factor"])))
    got = aug.geometric_compose(g["slots"], *(g[k] for k in keys), (40, 36),
                                jitter_op=g["jitter_op"], jitter_factor=g["jitter_factor"])
    assert got.shape == (4, 40, 36, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_planar_geometric_compose_matches_jax(rng):
    """The channel-planar compose (the split kernel path's layout) of
    pre-programmed float slots: atol 1e-3 of 255 against JAX's planar
    compose, and equal to the port's own HWC compose to 1e-3."""
    batch = geometry_batch(rng, 4, 32)
    planar = rng.uniform(0, 255, (4, 4, 3, 32, 32)).astype(np.float32)
    keys = GEOMETRY_BATCH_KEYS[1:8]
    want = np.asarray(j_aug.geometric_compose(
        jnp.asarray(planar), *(jnp.asarray(batch[k]) for k in keys), (32, 32), planar=True))
    g = _geo(batch)
    got = aug.geometric_compose(torch.from_numpy(planar), *(g[k] for k in keys), (32, 32),
                                planar=True)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    hwc = aug.geometric_compose(torch.from_numpy(planar).permute(0, 1, 3, 4, 2),
                                *(g[k] for k in keys), (32, 32))
    np.testing.assert_allclose(got.numpy(), hwc.numpy(), atol=1e-3)
    with pytest.raises(ValueError, match="already programmed"):
        aug.geometric_compose(torch.from_numpy(planar), *(g[k] for k in keys), (32, 32),
                              jitter_op=g["jitter_op"], jitter_factor=g["jitter_factor"],
                              planar=True)


def test_seg_compose_matches_jax(rng):
    """Area-resampled per-class coverage of the seg slots through the
    image's tile rects and flips: atol 1e-5 on fractions in [0, 1]."""
    batch = geometry_batch(rng, 4, 32)
    seg = rng.integers(0, 4, (4, 4, 32, 32), dtype=np.uint8)
    seg_active = batch["active"] & (np.arange(4)[:, None] % 2 == 0)
    args = (batch["src_rect"], batch["dst_rect"], batch["flip"], seg_active)
    want = np.asarray(j_aug.seg_compose(jnp.asarray(seg), *(jnp.asarray(a) for a in args),
                                        (8, 6), 3))
    got = aug.seg_compose(torch.from_numpy(seg), *(torch.from_numpy(a) for a in args), (8, 6), 3)
    assert got.shape == (4, 8, 6, 3)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


def test_slot_noise_gates_and_shares_the_plane(rng):
    """The plain path's noise draws the kernels' counter-based stream (the
    JAX path draws its own from ``jax.random``): gated-off slots come back
    unchanged, a shared-plane slot adds one field to all channels, the
    field has std ~scale (within 10%), the seed keys it, and slot (b, t)
    equals the slot twin's noise of slot ``b * T + t`` exactly."""
    slots = np.full((2, 4, 32, 32, 3), 128, np.uint8)
    gate = torch.tensor([[True, True, False, True], [False, True, True, False]])
    scale = torch.tensor([[7.0, 7.0, 7.0, 0.0], [5.0, 5.0, 5.0, 5.0]])
    pc = torch.tensor([[True, False, True, False], [True, True, False, False]])
    x = torch.from_numpy(slots)
    out = aug.slot_noise(x, 11, gate, scale, pc)
    assert out.shape == x.shape and out.dtype == torch.float32
    assert torch.equal(out[0, 2], x[0, 2].float()) and torch.equal(out[0, 3], x[0, 3].float())
    assert torch.equal(out[0, 1, ..., 0], out[0, 1, ..., 2])
    assert not torch.equal(out[0, 0, ..., 0], out[0, 0, ..., 1])
    assert abs(float((out[0, 0] - 128).std()) - 7.0) < 0.7
    assert torch.equal(out, aug.slot_noise(x, 11, gate, scale, pc))
    assert not torch.equal(out, aug.slot_noise(x, 12, gate, scale, pc))
    twin = k5.slot_aug_reference(x.reshape(8, 32, 32, 3), 11, gate.reshape(8), scale.reshape(8),
                                 pc.reshape(8), torch.full((8, 5), -1), torch.ones(8, 5))
    assert torch.equal(out.reshape(8, 32, 32, 3), twin.permute(0, 2, 3, 1))
    half = aug.slot_noise(x, 11, gate, scale, pc, dtype=torch.bfloat16)
    assert torch.equal(half, out.to(torch.bfloat16))


# --------------------------------------------------- the kernels' generator


def _mix32_numpy(x):
    x = x.astype(np.uint32)
    x ^= x >> np.uint32(16)
    x *= np.uint32(0x7FEB352D)
    x ^= x >> np.uint32(15)
    x *= np.uint32(0x846CA68B)
    x ^= x >> np.uint32(16)
    return x


def test_noise_generator_bits_are_uint32_arithmetic(rng):
    """The int64 emulation of the kernels' 32-bit hash equals
    wrapping uint32 arithmetic exactly, and ``noise_bits`` lays the words
    out as the JAX seam's (2, N, 3, S/2, S) field."""
    x = rng.integers(0, 2 ** 32, 4096, dtype=np.uint64)
    x[:4] = [0, 1, 2 ** 32 - 1, 0x9E3779B9]
    got = aug._mix32(torch.from_numpy(x.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, _mix32_numpy(x).astype(np.int64))

    seed, n, s = -123, 3, 8
    bits = aug.noise_bits(seed, n, s).numpy()
    assert bits.shape == (2, n, 3, s // 2, s) and bits.min() >= 0 and bits.max() < 2 ** 32
    slot = np.arange(n, dtype=np.uint64)
    key = _mix32_numpy((np.uint64(seed & 0xFFFFFFFF) ^ (slot * np.uint64(0x9E3779B9)))
                       & np.uint64(0xFFFFFFFF))
    j = np.arange(2 * 3 * (s // 2) * s, dtype=np.uint64)
    want = _mix32_numpy(key[:, None].astype(np.uint32) ^ _mix32_numpy(j)[None, :])
    np.testing.assert_array_equal(bits, want.reshape(n, 2, 3, s // 2, s).transpose(1, 0, 2, 3, 4))


def test_noise_generator_statistics():
    """Box-Muller on the generator's words: mean ~0 (|m| < 0.01) and std
    ~1 (within 1%) over 3 slots of 64x64x3, every value finite, slots
    and seeds decorrelated (|corr| < 0.02)."""
    z = aug.gaussians(aug.noise_bits(7, 3, 64)).numpy()
    assert np.isfinite(z).all() and z.shape == (3, 3, 64, 64)
    assert abs(z.mean()) < 0.01 and abs(z.std() - 1.0) < 0.01
    assert abs(np.corrcoef(z[0].ravel(), z[1].ravel())[0, 1]) < 0.02
    z2 = aug.gaussians(aug.noise_bits(8, 1, 64)).numpy()
    assert abs(np.corrcoef(z[0].ravel(), z2[0].ravel())[0, 1]) < 0.02


@pytest.mark.parametrize("s", [18, 352])
def test_rows_y_and_y_plus_half_share_one_bit_pair(s):
    """The noise layout the card kernel's paired rows rely on: row y and
    row y + S/2 of a plane are r cos and r sin of one Box-Muller draw, so
    z_y^2 + z_{y+S/2}^2 = -2 log(u1) and atan2(z_{y+S/2}, z_y) = 2 pi u2
    (mod 2 pi), u1 and u2 from word j of the bit field's two streams, in
    the twin (``gaussians``) and in the Pallas kernel (interpret mode,
    injected bits). S = 18 has an odd S/2. Word pairs at both ends of the
    24-bit range are forced in. Tolerances: float32 Box-Muller against the
    float64 identities, rtol 1e-5 on r^2 and 1e-5 rad on the angle where
    r > 0 (u1 rounds to 1.0 in float32 at the top word: r = 0); the Pallas
    output is 128 + 21 z in float32, so its z agrees with the twin's to
    2e-5."""
    rng = np.random.default_rng(s)
    bits = rng.integers(0, 2 ** 32, (2, 1, 3, s // 2, s), dtype=np.uint64).astype(np.uint32)
    bits[:, 0, 0, 0, :4] = [[0, 0xFFFFFFFF, 0, 0xFFFFFFFF], [0, 0, 0xFFFFFFFF, 0xFFFFFFFF]]
    z = aug.gaussians(torch.from_numpy(bits.astype(np.int64))).numpy()[0].astype(np.float64)
    u = ((bits >> 8).astype(np.float32) * np.float32(2.0 ** -24)
         + np.float32(2.0 ** -25)).astype(np.float64)
    top, bottom = z[:, : s // 2], z[:, s // 2:]
    np.testing.assert_allclose(top ** 2 + bottom ** 2, -2.0 * np.log(u[0, 0]), rtol=1e-5,
                               atol=1e-30)
    live = top ** 2 + bottom ** 2 > 0
    turn = np.arctan2(bottom, top) - 2.0 * np.pi * u[1, 0]
    wrapped = np.abs((turn + np.pi) % (2.0 * np.pi) - np.pi)
    assert live.mean() > 0.99 and wrapped[live].max() < 1e-5

    scale = 21.0  # 128 + 21 z stays inside [0, 255] for |z| <= 5.9
    grey = jnp.full((1, 3, s, s), 128, jnp.uint8)
    out = np.asarray(fused_slot_aug(
        grey, jnp.int32(0), jnp.asarray([True]), jnp.asarray([scale], jnp.float32),
        jnp.asarray([True]), jnp.full((1, 5), -1, jnp.int32), jnp.ones((1, 5), jnp.float32),
        interpret=True, debug_bits=jnp.asarray(bits)))
    np.testing.assert_allclose((out[0].astype(np.float64) - 128.0) / scale, z, atol=2e-5)


# ------------------------------------------------- the kernels' plain twins


def test_slot_aug_twin_matches_pallas_kernel(rng):
    """Kernel 5's twin against ``fused_slot_aug(interpret=True,
    debug_bits=...)``: the same injected bits, gates on and off, per-channel
    and shared-plane noise, every op with both hue signs, atol 1e-2 of 255
    (Box-Muller and the program in float32, transcendentals from two
    libraries)."""
    n, s = 6, 16
    slots = rng.integers(0, 256, (n, s, s, 3), dtype=np.uint8)
    gate = np.asarray([True, True, False, True, True, False])
    scale = rng.uniform(0, 0.03 * 255, n).astype(np.float32)
    pc = np.asarray([True, False, True, False, True, False])
    ops, facs = _programs(rng, n)
    bits = rng.integers(0, 2 ** 32, (2, n, 3, s // 2, s), dtype=np.uint64).astype(np.uint32)
    want = np.asarray(fused_slot_aug(
        jnp.transpose(jnp.asarray(slots), (0, 3, 1, 2)), jnp.int32(5), jnp.asarray(gate),
        jnp.asarray(scale), jnp.asarray(pc), jnp.asarray(ops), jnp.asarray(facs),
        interpret=True, debug_bits=jnp.asarray(bits)))
    args = (torch.from_numpy(slots), 5, torch.from_numpy(gate), torch.from_numpy(scale),
            torch.from_numpy(pc), torch.from_numpy(ops), torch.from_numpy(facs))
    got = k5.slot_aug_reference(*args, debug_bits=torch.from_numpy(bits.view(np.int32)))
    assert got.shape == (n, 3, s, s) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, atol=1e-2)
    # the wrapper on CPU tensors is the twin, rounded once to bf16
    wrapped = k5.slot_aug(*args, debug_bits=torch.from_numpy(bits.view(np.int32)))
    assert wrapped.dtype == torch.bfloat16
    assert torch.equal(wrapped, got.to(torch.bfloat16))


def test_aug_compose_twin_matches_pallas_kernel(rng):
    """Kernel 6's twin against ``fused_aug_compose(interpret=True,
    full=True)`` on a planner batch, noise off (the Pallas interpreter
    stubs the TPU's generator): within the JAX test's own bound, max < 4
    and mean < 0.5 of 255 (the TPU kernel resamples through bf16 matmuls;
    the twin stays float32 until one rounding to bf16)."""
    batch = geometry_batch(rng, 4, 32)
    j = {k: jnp.asarray(v) for k, v in batch.items()}
    want = np.asarray(j_aug.fused_aug_compose(
        j["slots"], j["src_rect"], j["dst_rect"], j["fill_rect"], j["fill_color"],
        j["fill_from_mean"], j["flip"], j["active"], (32, 32), j["noise_gate"],
        j["noise_scale"], j["noise_per_channel"], j["jitter_op"], j["jitter_factor"],
        jnp.zeros((2,), jnp.uint32), dtype=jnp.bfloat16, interpret=True, full=True),
        np.float32)
    g = _geo(batch)
    got = k6.aug_compose(g["slots"], 3, g["noise_gate"], g["noise_scale"],
                         g["noise_per_channel"], g["jitter_op"], g["jitter_factor"],
                         g["src_rect"], g["dst_rect"], g["fill_rect"], g["fill_color"],
                         g["fill_from_mean"], g["flip"], g["active"], (32, 32))
    assert got.shape == (4, 32, 32, 3) and got.dtype == torch.bfloat16
    d = np.abs(got.float().numpy() - want)
    assert d.max() < 4.0 and d.mean() < 0.5, (d.max(), d.mean())


@pytest.mark.parametrize("mode", ["split", False])
def test_aug_compose_twin_equals_split_path_with_noise(rng, mode):
    """With noise on, every augmentation mode draws the same gaussians from
    one seed. The full path (``aug_compose``) rounds its output to bf16;
    the split path (slot twin, then the planar compose) its slots; the
    plain ops (``slot_noise``, the HWC compose with the programs) round
    nothing in float32. Each rounding is at most half a bf16 spacing (0.5
    in [128, 256), a quarter on average), and the HWC and planar composes
    agree to 1e-3: max <= 2 and mean < 0.4 of 255 against the split path,
    max <= 1 and mean < 0.3 against the plain ops. The plain compose of the twin's float32 slots
    equals the full twin exactly."""
    batch = geometry_batch(rng, 2, 16)
    batch["noise_gate"][:] = True
    batch["noise_scale"][:] = 6.0
    g = _geo(batch)
    geom = [g[k] for k in GEOMETRY_BATCH_KEYS]
    full = augment_geometry(geom, 9, (24, 20), True)
    other = augment_geometry(geom, 9, (24, 20), mode)
    assert full.dtype == torch.bfloat16 and other.shape == full.shape
    d = (full.float() - other.float()).abs()
    bound = (2.0, 0.4) if mode == "split" else (1.0, 0.3)
    assert float(d.max()) <= bound[0] and float(d.mean()) < bound[1], (d.max(), d.mean())
    noise = geom[8:]
    planar = k5.slot_aug_reference(g["slots"].reshape(8, 16, 16, 3), 9,
                                   *(x.reshape(8, *x.shape[2:]) for x in noise))
    composed = aug.geometric_compose(planar.reshape(2, 4, 3, 16, 16), *geom[1:8], (24, 20),
                                     planar=True)
    assert torch.equal(full, composed.to(torch.bfloat16))
    noiseless = augment_geometry([*geom[:8], torch.zeros_like(noise[0]), *noise[1:]], 9,
                                 (24, 20), True)
    assert not torch.equal(full, noiseless)


def test_kernel_wrappers_check_their_inputs():
    slots = torch.zeros((2, 8, 8, 3), dtype=torch.uint8)
    plan = (torch.zeros(2, dtype=torch.bool), torch.zeros(2), torch.zeros(2, dtype=torch.bool),
            torch.full((2, 5), -1, dtype=torch.int32), torch.ones(2, 5))
    with pytest.raises(TypeError, match="uint8"):
        k5.slot_aug(slots.float(), 0, *plan)
    with pytest.raises(ValueError, match="S even"):
        k5.slot_aug(torch.zeros((2, 7, 7, 3), dtype=torch.uint8), 0, *plan)
    with pytest.raises(ValueError, match="op_ids"):
        k5.slot_aug(slots, 0, *plan[:3], plan[3][:, :4], plan[4])
    with pytest.raises(ValueError, match="int32"):
        k5.slot_aug(slots, 2 ** 31, *plan)
    with pytest.raises(ValueError, match="debug_bits"):
        k5.slot_aug(slots, 0, *plan, debug_bits=torch.zeros((2, 2, 3, 8, 8), dtype=torch.int32))
    out = k5.slot_aug(slots, 0, *plan, dtype=torch.float32)
    assert torch.equal(out, torch.zeros((2, 3, 8, 8)))


def test_random_geometry_batch_follows_the_planner_contract(rng):
    """The synthetic batch ``chip_smoke.py`` trains on has the planner's
    keys, shapes and dtypes; 1 or 4 active tiles per image, the active
    slots first; noise plans only on gated slots; every program holds each
    op at most once with factors in the planner's ranges; and the JAX
    compose of it equals the port's (atol 1e-3 of 255, as above)."""
    from mobilenet_yolo_tpu_torch.train import random_geometry_batch

    planned = geometry_batch(rng, 4, 16)
    batch = random_geometry_batch(np.random.default_rng(3), 4, 16, num_classes=3, max_gt=8)
    for k in (*GEOMETRY_BATCH_KEYS, "gt", "n_gt"):
        assert batch[k].shape == planned[k].shape and batch[k].dtype == planned[k].dtype, k
    ops, facs = batch["jitter_op"], batch["jitter_factor"]
    for op in range(5):
        assert ((ops == op).sum(-1) <= 1).all()
    hue = ops == 3
    assert (np.abs(facs[hue]) <= 18 / 255).all()
    assert ((facs[(ops >= 0) & ~hue] >= 0.5) & (facs[(ops >= 0) & ~hue] <= 1.5)).all()
    tiles = batch["active"].sum(1)
    assert set(tiles.tolist()) <= {1, 4}
    assert (batch["active"] == (np.arange(4) < tiles[:, None])).all()
    assert not (batch["noise_scale"][~batch["noise_gate"]]).any()
    rects = np.stack([batch[k] for k in ("src_rect", "dst_rect", "fill_rect")])
    assert (rects >= 0).all() and (rects <= 1).all()

    compose = jax.jit(lambda *a: j_aug.geometric_compose(*a[:8], (16, 16), jitter_op=a[8],
                                                         jitter_factor=a[9]))
    want = np.asarray(compose(*(jnp.asarray(batch[k]) for k in GEOMETRY_BATCH_KEYS[:8]),
                              jnp.asarray(ops), jnp.asarray(facs)))
    g = _geo(batch)
    got = aug.geometric_compose(*(g[k] for k in GEOMETRY_BATCH_KEYS[:8]), (16, 16),
                                jitter_op=g["jitter_op"], jitter_factor=g["jitter_factor"])
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)


def test_synthetic_traffic_draws_as_the_voc_loader():
    """The synthetic batch's group sizes and noise gates are the VOC
    loader's draws: from one seed, ``sample_group_size`` picks what
    ``data/mosaic.py:sample_group_size`` picks with ``mosaic_num: [1, 4]``
    and ``noise_gated`` gates as ``pixel_noise(defer_noise=True)`` defers
    its noise, draw for draw; over 400 seeds about a quarter of each."""
    from mobilenet_yolo_tpu.data.mosaic import sample_group_size as host_group_size
    from mobilenet_yolo_tpu_torch.train import synthetic

    img = np.full((8, 8, 3), 128, np.uint8)
    sizes, gates = [], []
    for seed in range(400):
        size = synthetic.sample_group_size(np.random.default_rng(seed))
        assert size == host_group_size([1, 4], np.random.default_rng(seed))
        gate = synthetic.noise_gated(np.random.default_rng(seed))
        _, deferred = host_aug.pixel_noise(img, np.random.default_rng(seed), defer_noise=True)
        assert gate == (deferred is not None)
        sizes.append(size)
        gates.append(gate)
    assert 0.18 < np.mean(np.asarray(sizes) == 4) < 0.32
    assert 0.18 < np.mean(gates) < 0.32
