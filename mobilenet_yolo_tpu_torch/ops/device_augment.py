"""Device-side pixel augmentation: noise, photometric programs, geometry.

Port of the plain (XLA) half of ``mobilenet_yolo_tpu/ops/device_augment.py``
that the device-geometry train step runs: ``slot_noise``,
``planned_color_jitter``, the geometric compose (``_axis_taps``,
``_resample_bilinear``, ``_rect_mask``, ``_compose_one``,
``geometric_compose``, HWC and channel-planar) and ``seg_compose``. The
hand-written kernels that fuse these stages (``kernels/slot_aug.py``,
``kernels/aug_compose.py``) build their plain twins on this module.

The standalone ops (``color_jitter``, ``additive_noise``,
``device_pixel_aug``; no train path runs them) draw their gates, factors
and noise from the caller's ``torch.Generator`` where JAX takes a key.

The noise comes from one counter-based generator (``noise_bits``), the
same in the plain ops, the twins and the CUDA kernels
(``csrc/aug_common.cuh``): the uniform word j of slot n under ``seed`` is
``mix32(key ^ mix32(j))`` with ``key = mix32(seed ^ n * 0x9E3779B9)``
(lowbias32), j indexing the ``(2, 3, S/2, S)`` bit field of the JAX seam
(``pallas_aug.py:186-190``). So every augmentation mode of the train step
draws the same gaussians from one seed. The JAX package draws its own
from ``jax.random``; only the distribution is shared with it.

``vmap`` over images becomes a leading batch dimension: every per-image
scalar of the JAX functions is a ``(B,)`` tensor here. Pixels are raw
[0, 255] values throughout.
"""

from __future__ import annotations

import torch

F32 = torch.float32


def _luma(x: torch.Tensor) -> torch.Tensor:
    return 0.299 * x[..., 0] + 0.587 * x[..., 1] + 0.114 * x[..., 2]


def _rgb_to_hsv(x: torch.Tensor):
    """x in [0, 1] channels last -> (h in [0, 1), s, v)."""
    mx = x.amax(-1)
    diff = mx - x.amin(-1)
    one = torch.ones_like(diff)
    safe = torch.where(diff == 0, one, diff)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    # torch's % is floor-mod, as jnp's is
    h = torch.where(mx == r, ((g - b) / safe) % 6.0,
                    torch.where(mx == g, (b - r) / safe + 2.0, (r - g) / safe + 4.0))
    h = torch.where(diff == 0, torch.zeros_like(h), h) / 6.0
    s = torch.where(mx == 0, torch.zeros_like(mx), diff / torch.where(mx == 0, one, mx))
    return h, s, mx


def _hsv_to_rgb(h, s, v) -> torch.Tensor:
    def chan(n):
        k = (n + h * 6.0) % 6.0
        return v - v * s * torch.clamp(torch.minimum(k, 4.0 - k), 0.0, 1.0)
    return torch.stack([chan(5.0), chan(3.0), chan(1.0)], -1)


def planned_color_jitter(images: torch.Tensor, op_ids: torch.Tensor, factors: torch.Tensor,
                         dtype: torch.dtype = F32) -> torch.Tensor:
    """Host-planned photometric programs (``device_augment.py:107-195``).

    images (N, H, W, 3) uint8/float in [0, 255]; op_ids (N, 5) int, the op
    at each step (0 brightness, 1 contrast, 2 saturation, 3 hue, 4 gamma,
    -1 identity); factors (N, 5) float (hue: the delta in turns). Returns
    ``dtype`` in [0, 255], clipped after every op.

    The JAX function's formulation is kept: the program is split at the
    hue step, so the HSV round trip runs once, in f32, between two phases
    of 4 select steps over the cheap ops (brightness, contrast, saturation,
    gamma). That equals applying the 5 steps in order whenever each op
    appears at most once, which is the host planner's contract
    (``data/augment.py:sample_photometric``). Contrast means accumulate in
    f32 under a bf16 ``dtype``.
    """
    x = images.to(dtype)
    n, steps = op_ids.shape
    dev = images.device
    op_ids = op_ids.long()
    factors = factors.to(F32)

    is_hue = op_ids == 3
    hue_gate = is_hue.any(dim=1)
    hue_step = is_hue.long().argmax(dim=1)                    # first (only) hue slot
    hue_delta = factors.gather(1, hue_step[:, None])[:, 0]
    pos = torch.arange(steps, device=dev)[None, :]
    live = (op_ids >= 0) & ~is_hue

    def compact(selected):
        # the selected ops first, in program order
        order = torch.where(selected, pos, steps + pos).argsort(dim=1)
        ops = torch.where(selected, op_ids, torch.full_like(op_ids, -1)).gather(1, order)
        fac = torch.where(selected, factors, torch.ones_like(factors)).gather(1, order)
        return ops[:, :steps - 1], fac[:, :steps - 1]

    pre_ops, pre_f = compact(live & (~hue_gate[:, None] | (pos < hue_step[:, None])))
    post_ops, post_f = compact(live & hue_gate[:, None] & (pos > hue_step[:, None]))

    def cheap_phase(x, ops, facs):
        for t in range(ops.shape[1]):
            op = ops[:, t].view(-1, 1, 1, 1)
            f = facs[:, t].view(-1, 1, 1, 1).to(dtype)
            xb = torch.clamp(x * f, 0.0, 255.0)
            mean = _luma(x).mean(dim=(1, 2), dtype=F32).to(dtype).view(-1, 1, 1, 1)
            xc = torch.clamp(mean + f * (x - mean), 0.0, 255.0)
            gray = _luma(x)[..., None]
            xs = torch.clamp(gray + f * (x - gray), 0.0, 255.0)
            xg = torch.clamp((x / 255.0) ** f * 255.0, 0.0, 255.0)
            x = torch.where(op == 0, xb, torch.where(
                op == 1, xc, torch.where(op == 2, xs, torch.where(op == 4, xg, x))))
        return x

    x = cheap_phase(x, pre_ops, pre_f)
    # hue's HSV round trip stays f32 (small channel differences divide)
    xf = x.to(F32)
    h, s, v = _rgb_to_hsv(xf / 255.0)
    xh = torch.clamp(_hsv_to_rgb((h + hue_delta.view(-1, 1, 1)) % 1.0, s, v) * 255.0,
                     0.0, 255.0)
    x = torch.where(hue_gate.view(-1, 1, 1, 1), xh, xf).to(dtype)
    return cheap_phase(x, post_ops, post_f)


def _uniform(n: int, generator, device, lo: float = 0.0, hi: float = 1.0) -> torch.Tensor:
    """(n,) U(lo, hi) from ``generator`` (on ``device``)."""
    return torch.rand(n, generator=generator, device=device) * (hi - lo) + lo


def jitter_params(n: int, generator: torch.Generator | None = None, device=None) -> dict:
    """The gates and factors of :func:`color_jitter` for ``n`` images, drawn
    in order brightness, contrast, saturation, hue, gamma, each a (n,) gate
    U < 0.5 then its (n,) value: factors U(0.5, 1.5), the hue delta
    U(-18, 18)/255 of a turn. A gated-off factor is 1 and a gated-off hue
    ``apply_hue`` False."""
    out = {}
    for name in ("brightness", "contrast", "saturation", "hue", "gamma"):
        gate = _uniform(n, generator, device) < 0.5
        if name == "hue":
            out["apply_hue"] = gate
            out["hue"] = _uniform(n, generator, device, -18 / 255.0, 18 / 255.0)
        else:
            out[name] = torch.where(gate, _uniform(n, generator, device, 0.5, 1.5),
                                    torch.ones(n, device=device))
    return out


def apply_color_jitter(images: torch.Tensor, brightness, contrast, saturation, apply_hue, hue,
                       gamma) -> torch.Tensor:
    """:func:`color_jitter` with its draws given ((B,) tensors): the JAX op's
    fixed order and clip points (``device_augment.py:80-101``). Brightness
    feeds the contrast mean unclipped; one clip after saturation, one
    after hue and one after gamma."""
    x = images.to(F32)

    def per_image(v):
        return v.to(F32).view(-1, 1, 1, 1)

    x = x * per_image(brightness)
    mean = _luma(x).mean(dim=(1, 2)).view(-1, 1, 1, 1)
    x = mean + per_image(contrast) * (x - mean)
    gray = _luma(x)[..., None]
    x = torch.clamp(gray + per_image(saturation) * (x - gray), 0.0, 255.0)
    h, s, v = _rgb_to_hsv(x / 255.0)
    h = torch.where(apply_hue.view(-1, 1, 1), (h + hue.to(F32).view(-1, 1, 1)) % 1.0, h)
    x = torch.clamp(_hsv_to_rgb(h, s, v) * 255.0, 0.0, 255.0)
    return torch.clamp((x / 255.0) ** per_image(gamma) * 255.0, 0.0, 255.0)


def color_jitter(images: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """Per-image photometric distortion in a fixed order on a raw [0, 255]
    batch (``device_augment.py:65-105``): brightness, contrast, saturation,
    hue, gamma, each applied with p=0.5 per image. images (B, H, W, 3)
    uint8 or float; ``generator`` (on the images' device; None: the
    global one) draws :func:`jitter_params`. Returns f32 in [0, 255].

    The train paths run :func:`planned_color_jitter` instead (the host
    planner's shuffled order, clipped after every op)."""
    params = jitter_params(images.shape[0], generator, images.device)
    return apply_color_jitter(images, **params)


def additive_noise(images: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """imgaug AdditiveGaussianNoise (``device_augment.py:198-213``): per
    image a gate U < 0.5, a scale U(0, 0.03 * 255) and a per-channel gate
    U < 0.3, then a per-channel field (B, H, W, 3) and a shared one
    (B, H, W) of standard normals; a per-channel image takes the first, the
    others the second. Draws in that order from ``generator`` (on the
    images' device). Returns f32 in [0, 255]."""
    x = images.to(F32)
    b, dev = x.shape[0], x.device
    apply = (_uniform(b, generator, dev) < 0.5).view(-1, 1, 1, 1)
    scale = _uniform(b, generator, dev, 0.0, 0.03 * 255.0).view(-1, 1, 1, 1)
    per_channel = (_uniform(b, generator, dev) < 0.3).view(-1, 1, 1, 1)
    n3 = torch.randn(x.shape, generator=generator, device=dev)
    n1 = torch.randn(x.shape[:3], generator=generator, device=dev)[..., None]
    noise = torch.where(per_channel, n3, n1) * scale
    return torch.clamp(torch.where(apply, x + noise, x), 0.0, 255.0)


def device_pixel_aug(images: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
    """:func:`color_jitter`, then independently gated :func:`additive_noise`,
    both from ``generator`` (``device_augment.py:216-225``; for standalone
    use, not a train path)."""
    return additive_noise(color_jitter(images, generator), generator)


_MASK32 = 0xFFFFFFFF
_TWO_PI = 6.283185307179586


def _mul32(a: torch.Tensor, b: int) -> torch.Tensor:
    """(a * b) mod 2^32 for int64 ``a`` in [0, 2^32) and a 32-bit constant,
    with no intermediate over 2^49."""
    lo, hi = b & 0xFFFF, b >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK32


def _mix32(x: torch.Tensor) -> torch.Tensor:
    """lowbias32 on int64 tensors holding uint32 values (aug_common.cuh:mix32)."""
    x = x ^ (x >> 16)
    x = _mul32(x, 0x7FEB352D)
    x = x ^ (x >> 15)
    x = _mul32(x, 0x846CA68B)
    return x ^ (x >> 16)


def shard_seed(seed: int, index: int) -> int:
    """The noise seed of data shard ``index``: ``seed + index * 101159`` with
    int32 wrap-around, as the JAX kernels take it under a mesh
    (``device_augment.py:449-452``)."""
    return (int(seed) + int(index) * 101159 + 2 ** 31) % 2 ** 32 - 2 ** 31


def noise_bits(seed: int, n: int, size: int, device=None, first_slot: int = 0) -> torch.Tensor:
    """The generator's words for slots ``first_slot .. first_slot + n - 1``
    at stage size ``size``: (2, n, 3, S/2, S) int64 in [0, 2^32)."""
    slot = torch.arange(first_slot, first_slot + n, dtype=torch.int64, device=device)
    key = _mix32((int(seed) & _MASK32) ^ _mul32(slot, 0x9E3779B9))
    per_slot = 2 * 3 * (size // 2) * size
    j = torch.arange(per_slot, dtype=torch.int64, device=device)
    words = _mix32(key[:, None] ^ _mix32(j)[None, :])
    return words.reshape(n, 2, 3, size // 2, size).transpose(0, 1)


def gaussians(bits: torch.Tensor) -> torch.Tensor:
    """(2, N, 3, S/2, S) uniform words -> (N, 3, S, S) standard normals
    (``pallas_aug.py:48-53,76-80``): 24 bits, never 0; rows [0, S/2)
    r*cos, rows [S/2, S) r*sin."""
    u = (bits >> 8).to(F32) * (1.0 / 16777216.0) + (1.0 / 33554432.0)
    r = torch.sqrt(-2.0 * torch.log(u[0]))
    phase = _TWO_PI * u[1]
    return torch.cat([r * torch.cos(phase), r * torch.sin(phase)], dim=2)


def _as_words(debug_bits: torch.Tensor) -> torch.Tensor:
    """uint32 (or its int32 view) -> int64 in [0, 2^32)."""
    if debug_bits.dtype not in (torch.uint32, torch.int32):
        raise TypeError(f"debug_bits must be uint32 or int32, got {debug_bits.dtype}")
    return debug_bits.view(torch.int32).to(torch.int64) & _MASK32


def noised_planar(slots: torch.Tensor, seed: int, gate, scale, pc,
                  debug_bits: torch.Tensor | None = None, first_slot: int = 0) -> torch.Tensor:
    """(N, S, S, 3) uint8/float -> (N, 3, S, S) f32 with the generator's (or
    ``debug_bits``') gated noise added and clipped (``pallas_aug.py:60-86``);
    channel 0 of the per-channel field doubles as the shared plane. The
    slots draw the generator's slots from ``first_slot`` on."""
    n, s = slots.shape[0], slots.shape[1]
    x = slots.permute(0, 3, 1, 2).to(F32)
    bits = (_as_words(debug_bits) if debug_bits is not None
            else noise_bits(seed, n, s, slots.device, first_slot))
    z = gaussians(bits)
    z = torch.where(pc.view(-1, 1, 1, 1), z, z[:, 0:1])
    noised = torch.clamp(x + z * scale.to(F32).view(-1, 1, 1, 1), 0.0, 255.0)
    return torch.where(gate.view(-1, 1, 1, 1), noised, x)


def slot_noise(slots: torch.Tensor, seed: int, gate: torch.Tensor, scale: torch.Tensor,
               per_channel: torch.Tensor, dtype: torch.dtype = F32,
               first_slot: int = 0) -> torch.Tensor:
    """Additive gaussian noise per staged slot (``device_augment.py:355-386``).

    slots (B, T, S, S, 3) uint8/float; gate / per_channel (B, T) bool;
    scale (B, T) float in [0, 255] units. Slot (b, t) draws the generator's
    slot ``first_slot + b * T + t`` under ``seed``, as the kernels do
    (``first_slot`` 0). The sum is taken
    in f32 and rounded once to ``dtype``. Returns (B, T, S, S, 3) ``dtype``
    in [0, 255].
    """
    b, t, s = slots.shape[:3]
    n = b * t
    noised = noised_planar(slots.reshape(n, s, s, 3), seed, gate.reshape(n).bool(),
                           scale.reshape(n), per_channel.reshape(n).bool(),
                           first_slot=first_slot)
    return noised.permute(0, 2, 3, 1).reshape(b, t, s, s, 3).to(dtype)


def _axis_taps(out_size: int, in_size: int, src0, src1, dst0, dst1):
    """Two-tap bilinear sampling along one axis (``device_augment.py:250-265``)
    for (B,) span endpoints: per image and output index the two
    straddling source indices (B, out) and the lerp fraction, edge-clamped
    like cv2.INTER_LINEAR."""
    denom = torch.clamp(dst1 - dst0, min=1e-6)[:, None]
    o = torch.arange(out_size, dtype=F32, device=src0.device)[None, :]
    u = src0[:, None] + (o + 0.5 - dst0[:, None]) * (src1 - src0)[:, None] / denom
    u = torch.clamp(u - 0.5, 0.0, in_size - 1.0)
    i0f = torch.floor(u)
    i0 = i0f.long()
    return i0, torch.clamp(i0 + 1, max=in_size - 1), u - i0f


def _resample_bilinear(img: torch.Tensor, sr: torch.Tensor, dr: torch.Tensor, out_h: int,
                       out_w: int, flip: torch.Tensor | None = None, dtype: torch.dtype = F32,
                       planar: bool = False) -> torch.Tensor:
    """(B, out_h, out_w, 3) bilinear resample of each image's source window
    ``sr`` onto its destination rect ``dr`` (B, 4) normalized
    (``device_augment.py:268-300``); pixels outside ``dr`` hold clamped
    values the caller masks. ``flip`` (B,) bool samples the mirrored image
    through the column taps. ``planar``: img is (B, 3, S, S)."""
    b = img.shape[0]
    s_h, s_w = (img.shape[2], img.shape[3]) if planar else (img.shape[1], img.shape[2])
    iy0, iy1, fy = _axis_taps(out_h, s_h, sr[:, 1] * s_h, sr[:, 3] * s_h,
                              dr[:, 1] * out_h, dr[:, 3] * out_h)
    ix0, ix1, fx = _axis_taps(out_w, s_w, sr[:, 0] * s_w, sr[:, 2] * s_w,
                              dr[:, 0] * out_w, dr[:, 2] * out_w)
    if flip is not None:
        ix0 = torch.where(flip[:, None], s_w - 1 - ix0, ix0)
        ix1 = torch.where(flip[:, None], s_w - 1 - ix1, ix1)
    fy, fx = fy.to(dtype), fx.to(dtype)
    if planar:
        def rows_at(i):
            return img.gather(2, i[:, None, :, None].expand(b, 3, out_h, s_w))

        def cols_at(rows, i):
            return rows.gather(3, i[:, None, None, :].expand(b, 3, out_h, out_w))

        rows = (rows_at(iy0) * (1.0 - fy)[:, None, :, None]
                + rows_at(iy1) * fy[:, None, :, None])          # (B, 3, out_h, s_w)
        res = (cols_at(rows, ix0) * (1.0 - fx)[:, None, None, :]
               + cols_at(rows, ix1) * fx[:, None, None, :])     # (B, 3, out_h, out_w)
        return res.permute(0, 2, 3, 1)

    def rows_at(i):
        return img.gather(1, i[:, :, None, None].expand(b, out_h, s_w, 3))

    def cols_at(rows, i):
        return rows.gather(2, i[:, None, :, None].expand(b, out_h, out_w, 3))

    rows = rows_at(iy0) * (1.0 - fy)[:, :, None, None] + rows_at(iy1) * fy[:, :, None, None]
    return (cols_at(rows, ix0) * (1.0 - fx)[:, None, :, None]
            + cols_at(rows, ix1) * fx[:, None, :, None])


def _rect_mask(rect: torch.Tensor, out_h: int, out_w: int) -> torch.Tensor:
    """(B, out_h, out_w) bool mask of normalized (B, 4) rects, pixel centres
    against the edges (``device_augment.py:303-310``)."""
    yy = ((torch.arange(out_h, dtype=F32, device=rect.device) + 0.5) / out_h)[None, :, None]
    xx = ((torch.arange(out_w, dtype=F32, device=rect.device) + 0.5) / out_w)[None, None, :]
    r = rect[:, :, None, None]
    return (yy >= r[:, 1]) & (yy < r[:, 3]) & (xx >= r[:, 0]) & (xx < r[:, 2])


def _compose_one(slots, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip,
                 active, out_h: int, out_w: int, dtype: torch.dtype = F32,
                 planar: bool = False) -> torch.Tensor:
    """Compose (B, out_h, out_w, 3) ``dtype`` images from their tiles
    (``device_augment.py:313-352``), tile by tile: the fill rect painted
    with a constant or the source-window mean, then the paste.

    ``planar``: slots are (B, T, 3, S, S)."""
    b, t = slots.shape[:2]
    s_h, s_w = (slots.shape[3], slots.shape[4]) if planar else (slots.shape[2], slots.shape[3])
    out = torch.zeros((b, out_h, out_w, 3), dtype=dtype, device=slots.device)
    for k in range(t):
        img = slots[:, k].to(dtype)
        sr, dr, fl = src_rect[:, k], dst_rect[:, k], flip[:, k]
        # the rects arrive mirrored for a flipped tile; the window over the
        # unflipped slot mirrors them back
        sr_mask = torch.where(fl[:, None],
                              torch.stack([1.0 - sr[:, 2], sr[:, 1], 1.0 - sr[:, 0], sr[:, 3]], -1),
                              sr)
        smask = _rect_mask(sr_mask, s_h, s_w)
        cnt = smask.sum(dim=(1, 2)).to(F32).clamp(min=1.0)[:, None]
        # the window mean accumulates in f32 under a bf16 compose
        if planar:
            src_mean = (img * smask[:, None]).sum(dim=(2, 3), dtype=F32) / cnt
        else:
            src_mean = (img * smask[..., None]).sum(dim=(1, 2), dtype=F32) / cnt
        fcol = torch.where(fill_from_mean[:, k, None], src_mean, fill_color[:, k].to(F32))
        fmask = _rect_mask(fill_rect[:, k], out_h, out_w) & active[:, k, None, None]
        out = torch.where(fmask[..., None], fcol.to(dtype)[:, None, None, :], out)
        res = _resample_bilinear(img, sr, dr, out_h, out_w, flip=fl, dtype=dtype, planar=planar)
        pmask = _rect_mask(dr, out_h, out_w) & active[:, k, None, None]
        out = torch.where(pmask[..., None], res, out)
    return out


def geometric_compose(slots, src_rect, dst_rect, fill_rect, fill_color, fill_from_mean, flip,
                      active, out_hw, jitter_op=None, jitter_factor=None,
                      dtype: torch.dtype = F32, planar: bool = False) -> torch.Tensor:
    """Batched device geometry (``device_augment.py:529-567``).

    slots (B, T, S, S, 3) uint8 staged sources; rects (B, T, 4) normalized
    [x1, y1, x2, y2]; fill_color (B, T, 3) raw [0, 255]; fill_from_mean,
    flip, active (B, T) bool; ``out_hw`` (H, W). With ``jitter_op`` /
    ``jitter_factor`` (B, T, 5) the photometric programs run per source
    first. Returns (B, H, W, 3) ``dtype`` in [0, 255].

    ``planar=True``: slots are (B, T, 3, S, S), already programmed by the
    slot kernel; ``jitter_op`` must then be None.
    """
    b, t = slots.shape[:2]
    if jitter_op is not None:
        if planar:
            raise ValueError("planar slots arrive already programmed; pass no jitter_op")
        s = slots.shape[2:]
        slots = planned_color_jitter(slots.reshape((b * t,) + s), jitter_op.reshape(b * t, -1),
                                     jitter_factor.reshape(b * t, -1), dtype=dtype
                                     ).reshape((b, t) + s)
    return _compose_one(slots, src_rect.to(F32), dst_rect.to(F32), fill_rect.to(F32),
                        fill_color, fill_from_mean, flip, active, int(out_hw[0]),
                        int(out_hw[1]), dtype=dtype, planar=planar)


def _axis_weights_area(out_size: int, in_size: int, src0, src1, dst0, dst1) -> torch.Tensor:
    """(B, out_size, in_size) area-average weights (exact cv2.INTER_AREA for
    a separable scale; ``device_augment.py:471-488``)."""
    denom = torch.clamp(dst1 - dst0, min=1e-6)[:, None]
    o = torch.arange(out_size, dtype=F32, device=src0.device)[None, :]
    step = (src1 - src0)[:, None] / denom
    u0 = src0[:, None] + (o - dst0[:, None]) * step
    u1 = u0 + step
    u0 = torch.clamp(u0, 0.0, float(in_size))
    u1 = torch.clamp(u1, 0.0, float(in_size))
    i = torch.arange(in_size, dtype=F32, device=src0.device)[None, None, :]
    overlap = (torch.minimum(u1[..., None], i + 1.0) - torch.maximum(u0[..., None], i))
    return overlap.clamp(min=0.0) / torch.clamp(u1 - u0, min=1e-6)[..., None]


def seg_compose(seg_slots, src_rect, dst_rect, flip, seg_active, out_hw16,
                num_classes: int) -> torch.Tensor:
    """Segmentation targets composed on the device (``device_augment.py:491-526``).

    seg_slots (B, T, S, S) uint8 class-id maps; the image's tile rects and
    flips; seg_active (B, T) bool. Returns (B, H16, W16, num_classes) f32
    coverage fractions in [0, 1]; outside every tile is background (0).
    """
    out_h, out_w = int(out_hw16[0]), int(out_hw16[1])
    b, t, s_h, s_w = seg_slots.shape
    src_rect, dst_rect = src_rect.to(F32), dst_rect.to(F32)
    out = torch.zeros((b, out_h, out_w, num_classes), dtype=F32, device=seg_slots.device)
    classes = torch.arange(1, num_classes + 1, device=seg_slots.device)
    for k in range(t):
        ids = torch.where(flip[:, k, None, None], seg_slots[:, k].flip(-1), seg_slots[:, k])
        sr, dr = src_rect[:, k], dst_rect[:, k]
        wy = _axis_weights_area(out_h, s_h, sr[:, 1] * s_h, sr[:, 3] * s_h,
                                dr[:, 1] * out_h, dr[:, 3] * out_h)
        wx = _axis_weights_area(out_w, s_w, sr[:, 0] * s_w, sr[:, 2] * s_w,
                                dr[:, 0] * out_w, dr[:, 2] * out_w)
        masks = (ids[..., None].long() == classes).to(F32)          # (B, S, S, C)
        res = torch.einsum("boi,bijc->bojc", wy, masks)
        res = torch.einsum("bpj,bojc->bopc", wx, res)
        pmask = _rect_mask(dr, out_h, out_w) & seg_active[:, k, None, None]
        out = torch.where(pmask[..., None], res, out)
    return out.clamp(0.0, 1.0)
