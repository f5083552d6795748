"""Plain reference of MobileNetV2-YOLO serving: the forward with the
optional segmentation head, the eval decode, and class-aware greedy NMS.

Plain PyTorch, written for any floating type (the benchmark runs it in
float64). It follows the published graph of eric612/Mobilenet-YOLO-Pytorch
(MobileNetV2 backbone, a two-scale FPN-lite neck, YOLOv3 heads, an optional
drivable-area head on the stride-16 tap) and uses no kernel, cache or
batching of the program under test, and imports nothing of it.

Parameter names are the served program's state-dict names (``backbone.stem
.conv.weight``, ``yolo_headS32.out.bias``, ...), so the benchmark hands the
same seeded tensors to both. BatchNorm is kept unfolded: ``calibrate``
sets every BatchNorm's statistics from one batch (the batch mean and the
biased variance, each layer normalising with them as it goes, as a
train-mode pass does), and ``forward`` then normalises with them.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

BN_EPS = 1e-5
LEAKY_SLOPE = 0.1
WH_CLIP = 18.0


def _per_channel(v: torch.Tensor) -> torch.Tensor:
    return v[None, :, None, None]


def _act(x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "relu6":
        return x.clamp(0.0, 6.0)
    if act == "leaky":
        return torch.where(x >= 0, x, x * LEAKY_SLOPE)
    return x


class BatchNorm(nn.Module):
    """Inference BatchNorm whose statistics ``calibrate`` mode sets."""

    def __init__(self, channels: int, device=None, dtype=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(channels, device=device, dtype=dtype))
        self.bias = nn.Parameter(torch.empty(channels, device=device, dtype=dtype))
        self.register_buffer("mean", torch.zeros(channels, device=device, dtype=dtype))
        self.register_buffer("var", torch.ones(channels, device=device, dtype=dtype))
        self.calibrating = False

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.calibrating:
            self.mean = x.mean(dim=(0, 2, 3))
            self.var = ((x - _per_channel(self.mean)) ** 2).mean(dim=(0, 2, 3))
        return ((x - _per_channel(self.mean)) / torch.sqrt(_per_channel(self.var) + BN_EPS)
                * _per_channel(self.weight) + _per_channel(self.bias))


class ConvBNAct(nn.Module):
    def __init__(self, cin: int, cout: int, kernel: int = 3, stride: int = 1,
                 depthwise: bool = False, act: str = "leaky", device=None, dtype=None):
        super().__init__()
        self.conv = nn.Module()
        shape = (cout, 1 if depthwise else cin, kernel, kernel)
        self.conv.weight = nn.Parameter(torch.empty(shape, device=device, dtype=dtype))
        self.bn = BatchNorm(cout, device, dtype)
        self.stride, self.groups, self.act = stride, cin if depthwise else 1, act

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.conv.weight
        y = F.conv2d(x, w, None, self.stride, w.shape[-1] // 2, 1, self.groups)
        return _act(self.bn(y), self.act)


class InvertedResidual(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, t: int, **kw):
        super().__init__()
        hidden = round(cin * t)
        self.expand = ConvBNAct(cin, hidden, 1, act="relu6", **kw) if t != 1 else None
        hidden = hidden if t != 1 else cin
        self.depthwise = ConvBNAct(hidden, hidden, 3, stride, depthwise=True, act="relu6", **kw)
        self.project = ConvBNAct(hidden, cout, 1, act="none", **kw)
        self.identity = stride == 1 and cin == cout
        self.shape = (cin, hidden, cout, stride)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = x if self.expand is None else self.expand(x)
        y = self.project(self.depthwise(y))
        return x + y if self.identity else y


class Backbone(nn.Module):
    """MobileNetV2: ``widths["inverted_residual"]`` lists (expand ratio t,
    channels c, repeats n, stride s); the stride-16 tap follows the first
    ``c4_after`` of them."""

    def __init__(self, widths: dict, **kw):
        super().__init__()
        self.stem = ConvBNAct(3, widths["stem"], 3, 2, act="relu6", **kw)
        ch, idx = widths["stem"], 0
        for k, (t, c, n, s) in enumerate(widths["inverted_residual"]):
            for i in range(n):
                self.add_module(f"block{idx}", InvertedResidual(ch, c, s if i == 0 else 1, t, **kw))
                ch, idx = c, idx + 1
            if k + 1 == widths["c4_after"]:
                self.c4_blocks, self.c4_channels = idx, ch
        self.num_blocks = idx
        self.head_conv = ConvBNAct(ch, widths["c5"], 1, act="relu6", **kw)

    def blocks(self) -> list[InvertedResidual]:
        return [getattr(self, f"block{i}") for i in range(self.num_blocks)]

    def forward(self, x: torch.Tensor):
        x = self.stem(x)
        for idx, block in enumerate(self.blocks()):
            x = block(x)
            if idx + 1 == self.c4_blocks:
                c4 = x
        return c4, self.head_conv(x)


class Connect(nn.Module):
    def __init__(self, ch: int, **kw):
        super().__init__()
        self.dw = ConvBNAct(ch, ch, 3, depthwise=True, **kw)
        self.pw = ConvBNAct(ch, ch, 1, **kw)

    def forward(self, x):
        return x + self.pw(self.dw(x))


class DepthwiseConvolution(nn.Module):
    def __init__(self, cin: int, cout: int, **kw):
        super().__init__()
        self.dw = ConvBNAct(cin, cin, 3, depthwise=True, **kw)
        self.pw1 = ConvBNAct(cin, cin, 1, **kw)
        self.pw2 = ConvBNAct(cin, cout, 1, **kw)

    def forward(self, x):
        return self.pw2(self.pw1(self.dw(x)))


class HeadStack(nn.Module):
    def __init__(self, cin: int, mid: int, cout: int, device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        self.dw = ConvBNAct(cin, cin, 3, depthwise=True, **kw)
        self.pw1 = ConvBNAct(cin, cin, 1, **kw)
        self.pw2 = ConvBNAct(cin, mid, 1, **kw)
        self.out = nn.Module()
        self.out.weight = nn.Parameter(torch.empty((cout, mid, 1, 1), **kw))
        self.out.bias = nn.Parameter(torch.empty(cout, **kw))

    def forward(self, x):
        return F.conv2d(self.pw2(self.pw1(self.dw(x))), self.out.weight, self.out.bias)


class MBv2YOLO(nn.Module):
    """The detector. ``forward`` takes NCHW normalised images and returns
    raw NCHW logits ``{"out0", "out1"[, "seg"]}``."""

    def __init__(self, widths: dict, num_classes: int, num_anchors: int, seg_classes: int = 0,
                 device=None, dtype=None):
        super().__init__()
        kw = dict(device=device, dtype=dtype)
        head = num_anchors * (5 + num_classes)
        neck, (mid32, mid16) = widths["neck"], widths["head_mid"]
        self.backbone = Backbone(widths, **kw)
        c4 = self.backbone.c4_channels
        self.conv_for_S32 = ConvBNAct(widths["c5"], neck, 1, **kw)
        self.connect_for_S32 = Connect(neck, **kw)
        self.yolo_headS32 = HeadStack(neck, mid32, head, **kw)
        self.conv_for_S16 = DepthwiseConvolution(c4, neck, **kw)
        self.connect_for_S16 = Connect(neck, **kw)
        self.yolo_headS16 = HeadStack(neck, mid16, head, **kw)
        self.seg_classes = seg_classes
        if seg_classes:
            seg = widths["seg_neck"]
            self.seg_conv_for_S16 = DepthwiseConvolution(c4, seg, **kw)
            self.seg_connect_for_S16 = Connect(seg, **kw)
            self.seg_headS16 = HeadStack(seg, seg, seg_classes, **kw)

    def forward(self, x: torch.Tensor) -> dict[str, torch.Tensor]:
        c4, c5 = self.backbone(x)
        s32 = self.connect_for_S32(self.conv_for_S32(c5))
        s16 = self.connect_for_S16(self.conv_for_S16(c4))
        s16 = s16 + s32.repeat_interleave(2, dim=2).repeat_interleave(2, dim=3)
        out = {"out0": self.yolo_headS32(s32), "out1": self.yolo_headS16(s16)}
        if self.seg_classes:
            out["seg"] = self.seg_headS16(self.seg_connect_for_S16(self.seg_conv_for_S16(c4)))
        return out


def build(config: dict, device=None, dtype=None) -> MBv2YOLO:
    """The reference for a configuration file: its ``widths`` (MobileNetV2
    at ``width_mult`` 1.0, as published), ``yolo`` and optional ``seg``."""
    if float(config.get("width_mult", 1.0)) != 1.0:
        raise ValueError("the widths are MobileNetV2's at width 1.0")
    return MBv2YOLO(config["widths"], config["yolo"]["num_classes"],
                    config["yolo"]["num_anchors"], config.get("seg", {}).get("num_classes", 0),
                    device=device, dtype=dtype)


def init_kinds(model: MBv2YOLO) -> dict[str, tuple[str, float]]:
    """How each parameter is drawn: ``("normal", std)`` (a conv weight,
    truncated at two deviations: fan-out He init, or the heads' 0.01),
    ``("const", v)``."""
    kinds = {}
    for name, p in model.named_parameters():
        if name.endswith("out.weight"):
            kinds[name] = ("normal", 0.01)
        elif name.endswith("out.bias") or name.endswith("bn.bias"):
            kinds[name] = ("const", 0.0)
        elif name.endswith("bn.weight"):
            kinds[name] = ("const", 1.0)
        else:
            out_ch, _, kh, kw = p.shape
            # flax variance_scaling(2, fan_out, truncated_normal): the cut at
            # two deviations keeps 0.8796 of the variance
            kinds[name] = ("normal", math.sqrt(2.0 / (kh * kw * out_ch)) / 0.87962566103423978)
    return kinds


def set_calibrating(model: nn.Module, on: bool) -> None:
    for m in model.modules():
        if isinstance(m, BatchNorm):
            m.calibrating = on


@torch.no_grad()
def calibrate(model: MBv2YOLO, images: torch.Tensor) -> None:
    """BatchNorm statistics from one normalised NCHW batch."""
    set_calibrating(model, True)
    try:
        model(images)
    finally:
        set_calibrating(model, False)


def normalise(frames_u8: torch.Tensor, mean, std, dtype: torch.dtype) -> torch.Tensor:
    """(B, H, W, 3) uint8 -> (B, 3, H, W) ``(x / 255 - mean) / std``."""
    mean = torch.tensor(mean, dtype=dtype, device=frames_u8.device)
    std = torch.tensor(std, dtype=dtype, device=frames_u8.device)
    x = (frames_u8.to(dtype) / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()


def decode(head_nchw: torch.Tensor, anchors_px, img_w: int, img_h: int, num_anchors: int):
    """One head's raw logits -> boxes (B, N, 4) corners, conf (B, N),
    class probabilities (B, N, C), in the (H, W, anchor) order."""
    b, c, h, w = head_nchw.shape
    p = head_nchw.permute(0, 2, 3, 1).reshape(b, h, w, num_anchors, c // num_anchors)
    dt, dev = p.dtype, p.device
    gy, gx = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                            torch.arange(w, dtype=dt, device=dev), indexing="ij")
    grid = torch.stack([gx, gy], dim=-1)[:, :, None, :]
    anchors = torch.tensor(anchors_px, dtype=dt, device=dev) / torch.tensor(
        [img_w, img_h], dtype=dt, device=dev)
    centre = (torch.sigmoid(p[..., 0:2]) + grid) / torch.tensor([w, h], dtype=dt, device=dev)
    size = torch.exp(p[..., 2:4].clamp(-WH_CLIP, WH_CLIP)) * anchors
    lo = centre - size / 2
    boxes = torch.cat([lo, lo + size], dim=-1).reshape(b, -1, 4)
    probs = torch.sigmoid(p[..., 4:]).reshape(b, h * w * num_anchors, -1)
    return boxes, probs[..., 0], probs[..., 1:]


@torch.no_grad()
def candidates(model: MBv2YOLO, frames_u8: torch.Tensor, config: dict, dtype: torch.dtype):
    """Every candidate of each frame, before the gate, top-K and NMS:
    ``{"boxes", "conf", "probs"[, "seg"]}``; ``seg`` (B, H/16, W/16,
    classes) holds sigmoid maps."""
    norm = config.get("normalize", {"mean": [0.5] * 3, "std": [1.0] * 3})
    x = normalise(frames_u8, norm["mean"], norm["std"], dtype)
    out = model(x)
    yolo = config["yolo"]
    h, w = frames_u8.shape[1], frames_u8.shape[2]
    parts = [decode(out[key], [yolo["anchors"][i] for i in mask], w, h, yolo["num_anchors"])
             for key, mask in zip(("out0", "out1"), yolo["mask"])]
    res = {"boxes": torch.cat([p[0] for p in parts], 1), "conf": torch.cat([p[1] for p in parts], 1),
           "probs": torch.cat([p[2] for p in parts], 1)}
    if "seg" in out:
        res["seg"] = torch.sigmoid(out["seg"]).permute(0, 2, 3, 1)
    return res


def pairwise_iou(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(..., n, 4) x (..., m, 4) corner boxes -> (..., n, m): the
    intersection clamped at 0 over the union of the signed areas."""
    lower = torch.maximum(a[..., :, None, :2], b[..., None, :, :2])
    upper = torch.minimum(a[..., :, None, 2:], b[..., None, :, 2:])
    wh = (upper - lower).clamp(min=0.0)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[..., 2] - a[..., 0]) * (a[..., 3] - a[..., 1])
    area_b = (b[..., 2] - b[..., 0]) * (b[..., 3] - b[..., 1])
    union = area_a[..., :, None] + area_b[..., None, :] - inter
    return inter / union


def greedy_nms(boxes: torch.Tensor, classes: torch.Tensor, valid: torch.Tensor,
               iou_threshold: float) -> torch.Tensor:
    """Hard NMS over rows already in rank order: (B, K, 4), (B, K), (B, K)
    bool -> keep (B, K) bool. A row survives if it is valid and no earlier
    surviving row of its class overlaps it by more than the threshold."""
    b, k = valid.shape
    hit = (pairwise_iou(boxes, boxes) > iou_threshold) & (classes[:, :, None] == classes[:, None, :])
    keep = torch.zeros((b, k), dtype=torch.bool, device=boxes.device)
    suppressed = torch.zeros_like(keep)
    for i in range(k):
        alive = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = alive
        later = hit[:, i].clone()
        later[:, : i + 1] = False
        suppressed |= alive[:, None] & later
    return keep
