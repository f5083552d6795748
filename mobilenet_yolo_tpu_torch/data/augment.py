"""SSD-style detection augmentations (host-side numpy/PIL; port of
``mobilenet_yolo_tpu/data/augment.py``, a copy).

Re-implements the semantics of reference utils/image_augmentation.py:

* ``photometric_distort`` (169-198): brightness/contrast/saturation/hue/
  gamma, each applied with p=0.5 in random order with the Caffe-repo factor
  ranges.
* ``expand`` (14-52): zoom-out onto a mean-filled canvas, scale drawn from
  U(1, expand_scale).
* ``random_crop`` (54-145): retry loop over min-overlap choices
  {0,.1,.2,.3,.4,.5,None} with [0.5,1] scales, aspect-ratio gate and
  center-keep box filtering.
* ``hflip`` (147-166): the reference's exact coordinate math, including its
  "-1" pixel convention.
* ``pixel_noise`` replaces the imgaug sometimes-pipeline
  (folder2lmdb.py:29-42): gaussian/median blur, sharpen, additive gaussian
  noise — 1-2 of them with p=0.5.

Everything operates on uint8 RGB HWC arrays + float corner boxes in pixels
and an explicit ``np.random.Generator`` (no global RNG), so the pipeline is
reproducible and per-worker seedable.
"""

from __future__ import annotations

import numpy as np


def _try_cv2():
    """cv2 accelerates the hot filters ~10-100x on the 1-core host (and is
    what imgaug itself uses); every op keeps a numpy fallback with
    identical math, cross-tested in tests/test_torch_data.py."""
    global _CV2
    if _CV2 is _UNSET:
        try:
            import cv2
            _CV2 = cv2
        except ImportError:
            _CV2 = None
    return _CV2


_UNSET = object()
_CV2 = _UNSET


# --------------------------------------------------------------- photometric

def _blend(a: np.ndarray, b: np.ndarray, factor: float) -> np.ndarray:
    out = b + factor * (a - b)
    return np.clip(out, 0, 255)


def adjust_brightness(img: np.ndarray, factor: float) -> np.ndarray:
    return _blend(img.astype(np.float32), np.zeros_like(img, np.float32), factor)


def adjust_contrast(img: np.ndarray, factor: float) -> np.ndarray:
    # torchvision contrast pivots on the mean of the grayscale image
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    mean = gray.mean()
    return _blend(img.astype(np.float32), np.full_like(img, mean, np.float32), factor)


def adjust_saturation(img: np.ndarray, factor: float) -> np.ndarray:
    gray = (0.299 * img[..., 0] + 0.587 * img[..., 1] + 0.114 * img[..., 2])
    gray3 = np.repeat(gray[..., None], 3, axis=-1).astype(np.float32)
    return _blend(img.astype(np.float32), gray3, factor)


def adjust_hue(img: np.ndarray, delta: float) -> np.ndarray:
    """delta in [-0.5, 0.5] revolutions (torchvision convention)."""
    cv2 = _try_cv2()
    if cv2 is not None:
        hsv = cv2.cvtColor(np.ascontiguousarray(img, np.float32) / 255.0,
                           cv2.COLOR_RGB2HSV)  # H in degrees for float input
        hsv[..., 0] = (hsv[..., 0] + delta * 360.0) % 360.0
        return np.clip(cv2.cvtColor(hsv, cv2.COLOR_HSV2RGB) * 255.0, 0, 255)
    hsv = _rgb_to_hsv(img.astype(np.float32) / 255.0)
    hsv[..., 0] = (hsv[..., 0] + delta) % 1.0
    return np.clip(_hsv_to_rgb(hsv) * 255.0, 0, 255)


def adjust_gamma(img: np.ndarray, gamma: float) -> np.ndarray:
    x = img.astype(np.float32) / 255.0
    return np.clip((x ** gamma) * 255.0, 0, 255)


def _rgb_to_hsv(rgb):
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    diff = mx - mn
    safe = np.where(diff == 0, 1.0, diff)
    r, g, b = rgb[..., 0], rgb[..., 1], rgb[..., 2]
    h = np.where(mx == r, ((g - b) / safe) % 6,
                 np.where(mx == g, (b - r) / safe + 2, (r - g) / safe + 4))
    h = np.where(diff == 0, 0.0, h) / 6.0
    s = np.where(mx == 0, 0.0, diff / np.where(mx == 0, 1.0, mx))
    return np.stack([h, s, mx], axis=-1)


def _hsv_to_rgb(hsv):
    h, s, v = hsv[..., 0] * 6.0, hsv[..., 1], hsv[..., 2]
    i = np.floor(h)
    f = h - i
    p = v * (1 - s)
    q = v * (1 - s * f)
    t = v * (1 - s * (1 - f))
    i = (i.astype(np.int32) % 6)[..., None]  # (H, W, 1) vs (H, W, 3) choices
    out = np.select(
        [i == 0, i == 1, i == 2, i == 3, i == 4, i == 5],
        [np.stack([v, t, p], -1), np.stack([q, v, p], -1),
         np.stack([p, v, t], -1), np.stack([p, q, v], -1),
         np.stack([t, p, v], -1), np.stack([v, p, q], -1)])
    return out


PHOTOMETRIC_OPS = ("brightness", "contrast", "saturation", "hue", "gamma")
_PHOTOMETRIC_FNS = (adjust_brightness, adjust_contrast, adjust_saturation,
                    adjust_hue, adjust_gamma)


def sample_photometric(rng: np.random.Generator):
    """Pixel-free sampler for :func:`photometric_distort` — the same draws
    in the same order (shuffle, then per shuffled op: p=0.5 gate, then the
    factor only when applied), so the device-geometry planner samples the
    EXACT host/reference distribution (reference :169-198).

    Returns ``(op_ids, factors)``: (5,) int32 op index per program step
    (-1 = identity at that step) and (5,) f32 factor (hue: the delta).
    """
    ops = list(PHOTOMETRIC_OPS)
    rng.shuffle(ops)
    op_ids = np.full(5, -1, np.int32)
    factors = np.ones(5, np.float32)
    for t, op in enumerate(ops):
        if rng.random() >= 0.5:
            continue
        op_ids[t] = PHOTOMETRIC_OPS.index(op)
        if op == "hue":
            factors[t] = rng.uniform(-18 / 255.0, 18 / 255.0)
        else:
            factors[t] = rng.uniform(0.5, 1.5)
    return op_ids, factors


def apply_photometric(img: np.ndarray, op_ids: np.ndarray,
                      factors: np.ndarray) -> np.ndarray:
    """Apply a sampled photometric program to a float [0,255] image."""
    for t in range(len(op_ids)):
        if op_ids[t] >= 0:
            img = _PHOTOMETRIC_FNS[op_ids[t]](img, float(factors[t]))
    return img


def photometric_distort(img: np.ndarray, rng: np.random.Generator) -> np.ndarray:
    """Each distortion with p=0.5 in random order (reference :169-198)."""
    op_ids, factors = sample_photometric(rng)
    return apply_photometric(img.astype(np.float32), op_ids,
                             factors).astype(np.uint8)


# ------------------------------------------------------------- pixel noise

def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    """Separable true-gaussian blur, sigma in pixels, edge-padded.

    Matches imgaug GaussianBlur semantics: sigma below a small epsilon is
    the identity; kernel truncated at 3 sigma.
    """
    if sigma < 1e-3:
        return img.astype(np.float32)
    radius = max(1, int(round(3.0 * sigma)))
    cv2 = _try_cv2()
    if cv2 is not None:
        return cv2.GaussianBlur(img.astype(np.float32),
                                (2 * radius + 1, 2 * radius + 1), sigma,
                                borderType=cv2.BORDER_REPLICATE)
    t = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-0.5 * (t / sigma) ** 2)
    k /= k.sum()
    out = img.astype(np.float32)
    for axis in (0, 1):
        pad = [(radius, radius) if a == axis else (0, 0)
               for a in range(out.ndim)]
        xp = np.pad(out, pad, mode="edge")
        win = np.lib.stride_tricks.sliding_window_view(
            xp, 2 * radius + 1, axis=axis)
        out = win @ k
    return out


def median_blur(img: np.ndarray, k: int) -> np.ndarray:
    """k x k local-median filter, edge-padded (imgaug MedianBlur)."""
    cv2 = _try_cv2()
    if cv2 is not None and k in (3, 5):
        # cv2.medianBlur replicates the border, same as the edge pad below
        return cv2.medianBlur(np.ascontiguousarray(img, np.float32), k)
    pad = k // 2
    xp = np.pad(img, [(pad, pad), (pad, pad)] + [(0, 0)] * (img.ndim - 2),
                mode="edge")
    win = np.lib.stride_tricks.sliding_window_view(xp, (k, k), axis=(0, 1))
    return np.median(win, axis=(-2, -1)).astype(np.float32)


def sharpen(img: np.ndarray, alpha: float, lightness: float) -> np.ndarray:
    """imgaug Sharpen: 3x3 kernel (1-a)*I + a*[[-1..],[-1,8+l,-1],[-1..]].

    Convolution is linear, so blending the kernels equals blending the
    outputs.
    """
    x = img.astype(np.float32)
    cv2 = _try_cv2()
    if cv2 is not None:
        kern = np.full((3, 3), -alpha, np.float32)
        kern[1, 1] = (1.0 - alpha) + alpha * (8.0 + lightness)
        return cv2.filter2D(x, -1, kern, borderType=cv2.BORDER_REPLICATE)
    xp = np.pad(x, [(1, 1), (1, 1)] + [(0, 0)] * (x.ndim - 2), mode="edge")
    h, w = x.shape[:2]
    neigh = np.zeros_like(x)
    for dy in (0, 1, 2):
        for dx in (0, 1, 2):
            if dy == 1 and dx == 1:
                continue
            neigh += xp[dy:dy + h, dx:dx + w]
    effect = (8.0 + lightness) * x - neigh
    return (1.0 - alpha) * x + alpha * effect


def pixel_noise(img: np.ndarray, rng: np.random.Generator,
                defer_noise: bool = False):
    """Sometimes(0.5, SomeOf((1,2), [OneOf(gaussian|median blur), sharpen,
    additive gaussian noise], random_order)) — reference folder2lmdb.py:29-42
    with imgaug's sampled parameter distributions.

    ``defer_noise=True`` (the device-geometry path) samples the pipeline
    identically but does not APPLY the additive-noise op on host — drawing
    ~600k gaussians per image is the single most expensive host op on a
    slow core — and instead returns ``(img, (scale, per_channel) | None)``
    so the jitted step can add the noise on device
    (ops/device_augment.py:slot_noise). Note the op-order simplification:
    deferred noise lands after any host blur/sharpen even when the shuffle
    placed it first (noise commutes with neither, but both orders are in
    the reference's random_order distribution anyway)."""
    deferred = None
    if rng.random() >= 0.5:
        return (img, None) if defer_noise else img
    ops = ["blur", "sharpen", "noise"]
    rng.shuffle(ops)
    n = int(rng.integers(1, 3))
    out = img.astype(np.float32)
    for op in ops[:n]:
        if op == "blur":
            if rng.random() < 0.5:
                out = gaussian_blur(out, float(rng.uniform(0.0, 1.0)))
            else:
                out = median_blur(out, int(rng.choice([3, 5])))
        elif op == "sharpen":
            alpha = rng.uniform(0, 0.1)
            light = rng.uniform(0.9, 1.1)
            out = np.clip(sharpen(out, alpha, light), 0, 255)
        else:
            scale = np.float32(rng.uniform(0.0, 0.03 * 255))
            per_channel = rng.random() < 0.3
            if defer_noise:
                deferred = (float(scale), bool(per_channel))
                continue
            if per_channel:
                noise = rng.standard_normal(out.shape, np.float32) * scale
            else:
                noise = (rng.standard_normal(out.shape[:2], np.float32)
                         * scale)[..., None]
            out = out + noise
    out = np.clip(out, 0, 255).astype(np.uint8)
    return (out, deferred) if defer_noise else out


# ----------------------------------------------------------- geometric ops
#
# Every geometric op is split into a pixel-free parameter sampler + label
# math (shared with the device-side path, data/geometry.py, which resamples
# pixels on TPU) and a host pixel application. The samplers own ALL rng
# draws, in the reference's order, so host and device modes see identical
# geometry distributions by construction.

def sample_expand(h: int, w: int, expand_scale: float,
                  rng: np.random.Generator) -> tuple[int, int, int, int]:
    """Expand-canvas parameters (reference :14-52): (new_h, new_w, top, left)."""
    scale = rng.uniform(1.0, expand_scale)
    new_h, new_w = int(scale * h), int(scale * w)
    left = int(rng.integers(0, new_w - w + 1))
    top = int(rng.integers(0, new_h - h + 1))
    return new_h, new_w, top, left


def expand(img: np.ndarray, boxes: np.ndarray, filler, expand_scale: float,
           rng: np.random.Generator, seg: np.ndarray | None = None):
    """Zoom-out onto a filler canvas (reference :14-52). filler in [0,1]."""
    h, w = img.shape[:2]
    new_h, new_w, top, left = sample_expand(h, w, expand_scale, rng)
    canvas = np.empty((new_h, new_w, 3), img.dtype)
    canvas[:] = (np.asarray(filler, np.float32) * 255.0).astype(img.dtype)
    canvas[top:top + h, left:left + w] = img
    new_boxes = boxes + np.asarray([left, top, left, top], np.float32)
    new_seg = None
    if seg is not None:
        new_seg = np.zeros((new_h, new_w), seg.dtype)
        new_seg[top:top + h, left:left + w] = seg
    return canvas, new_boxes, new_seg


def sample_crop(h: int, w: int, boxes: np.ndarray,
                rng: np.random.Generator):
    """Min-overlap retry crop sampler (reference :54-145), pixel-free.

    Returns ``(crop, keep)``: ``crop`` is an int [left, top, right, bottom]
    window or None for the no-crop branch; ``keep`` is the center-keep box
    mask (None when there are no boxes)."""
    # The reference runs up to 50 sequential trials per overlap choice
    # (:66-145). The trials are i.i.d., so drawing all 50 up front and
    # taking the FIRST valid one samples the identical distribution while
    # replacing ~50 tiny numpy calls with a handful of (50,)-vectorized
    # ones (~5x faster on a slow host; the crop sampler is on the hot path
    # of every training image).
    T = 50
    while True:
        min_overlap = rng.choice([0.0, 0.1, 0.2, 0.3, 0.4, 0.5, None])
        if min_overlap is None:
            return None, None
        min_scale = 0.5
        new_h = (rng.uniform(min_scale, 1.0, T) * h).astype(np.int64)
        new_w = (rng.uniform(min_scale, 1.0, T) * w).astype(np.int64)
        aspect_ok = (new_h * 2 > new_w) & (new_h < 2 * new_w)  # 0.5<h/w<2
        left = rng.integers(0, w - new_w + 1)
        top = rng.integers(0, h - new_h + 1)
        right, bottom = left + new_w, top + new_h
        valid = aspect_ok
        if boxes.shape[0] > 0:
            crops = np.stack([left, top, right, bottom], -1).astype(np.float32)
            # jaccard overlap of each trial crop with each box
            lower = np.maximum(crops[:, None, :2], boxes[None, :, :2])
            upper = np.minimum(crops[:, None, 2:], boxes[None, :, 2:])
            wh = np.clip(upper - lower, 0, None)
            inter = wh[..., 0] * wh[..., 1]
            area_c = (new_w * new_h).astype(np.float32)
            area_b = (boxes[:, 2] - boxes[:, 0]) * (boxes[:, 3] - boxes[:, 1])
            overlap = inter / (area_c[:, None] + area_b[None, :] - inter)
            valid &= overlap.max(1) >= min_overlap
            centers = (boxes[:, :2] + boxes[:, 2:]) / 2.0
            keeps = ((centers[None, :, 0] > left[:, None])
                     & (centers[None, :, 0] < right[:, None])
                     & (centers[None, :, 1] > top[:, None])
                     & (centers[None, :, 1] < bottom[:, None]))
            valid &= keeps.any(1)
        if not valid.any():
            continue
        t = int(np.argmax(valid))
        crop = (int(left[t]), int(top[t]), int(right[t]), int(bottom[t]))
        if boxes.shape[0] > 0:
            return crop, keeps[t]
        return crop, None


def crop_boxes(boxes: np.ndarray, crop, keep):
    """Clip kept boxes into crop-window pixel coordinates (reference :132-141)."""
    left, top, right, bottom = crop
    corners = np.asarray([left, top, right, bottom], np.float32)
    nb = boxes[keep].copy() if keep is not None else boxes.copy()
    nb[:, :2] = np.maximum(nb[:, :2], corners[:2]) - corners[:2]
    nb[:, 2:] = np.minimum(nb[:, 2:], corners[2:]) - corners[:2]
    return nb


def random_crop(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                difficulties: np.ndarray, rng: np.random.Generator,
                seg: np.ndarray | None = None):
    """Min-overlap retry crop with center-keep filtering (reference :54-145)."""
    h, w = img.shape[:2]
    crop, keep = sample_crop(h, w, boxes, rng)
    if crop is None:
        return img, boxes, labels, difficulties, seg
    left, top, right, bottom = crop
    new_img = img[top:bottom, left:right]
    new_seg = seg[top:bottom, left:right] if seg is not None else None
    if boxes.shape[0] > 0:
        nb = crop_boxes(boxes, crop, keep)
        return new_img, nb, labels[keep], difficulties[keep], new_seg
    return new_img, boxes, labels, difficulties, new_seg


def flip_boxes(boxes: np.ndarray, w: int) -> np.ndarray:
    """Horizontal-flip label math incl. the reference's "-1" pixel
    convention (:147-166)."""
    nb = boxes.copy()
    nb[:, 0] = w - boxes[:, 0] - 1
    nb[:, 2] = w - boxes[:, 2] - 1
    return nb[:, [2, 1, 0, 3]]


def hflip(img: np.ndarray, boxes: np.ndarray, seg: np.ndarray | None = None):
    """Horizontal flip with the reference's coordinate math (:147-166)."""
    new_img = img[:, ::-1].copy()
    new_seg = seg[:, ::-1].copy() if seg is not None else None
    return new_img, flip_boxes(boxes, img.shape[1]), new_seg


def transform_od(img: np.ndarray, boxes: np.ndarray, labels: np.ndarray,
                 difficulties: np.ndarray, rng: np.random.Generator,
                 mean=(0.5, 0.5, 0.5), phase: str = "train",
                 allow_expand: bool = True, expand_scale: float = 1.5,
                 seg: np.ndarray | None = None, photometric: bool = True):
    """Full train-time pipeline (reference :279-334): photometric ->
    expand(p=.5) -> random crop -> hflip(p=.5). Test phase is identity.
    ``photometric=False`` skips the pixelwise distortion (it then runs on
    device, ops/device_augment.py)."""
    assert phase in ("train", "test")
    if phase == "test":
        return img, boxes, labels, difficulties, seg
    if photometric:
        img = photometric_distort(img, rng)
    if rng.random() < 0.5 and allow_expand:
        img, boxes, seg = expand(img, boxes, mean, expand_scale, rng, seg)
    img, boxes, labels, difficulties, seg = random_crop(
        img, boxes, labels, difficulties, rng, seg)
    if rng.random() < 0.5:
        img, boxes, seg = hflip(img, boxes, seg)
    return img, boxes, labels, difficulties, seg
