"""Post-training int8 quantization (PTQ) for deployment.

Port of ``mobilenet_yolo_tpu/quant.py``: fold BN (``models/bn_fold.py``),
quantize every conv kernel to per-output-channel symmetric int8, calibrate
per-layer activation ranges on real batches, then *simulate* the int8 graph
to measure the mAP cost before committing to an NPU toolchain (the
reference's Kneron KL720 port, reference README.md:54).

What is quantized (``quant.py:11-24``):

* **Weights** — every ``ConvBNAct`` conv (backbone, neck, heads' dw/pw
  stacks), per output channel, symmetric: ``s_c = max|k[c]| / 127``,
  ``q = round(k / s)``, computed in numpy as the JAX package does, so the
  tables are equal bit for bit. They are kept in JAX's HWIO layout, so an
  artifact reads the same in both packages.
* **Activations** — every ``ConvBNAct`` output, per tensor, symmetric,
  range = max|x| over the calibration set.
* **Not quantized** — the raw-logit ``HeadStack.out`` convs and the
  decode/NMS tail.

A site is named by its flax path joined by ``/`` (``backbone/block1/expand``);
the port's module names are the flax names, so both packages key the same
sites.

The simulation runs the BN-folded weights through the per-layer modules
(``per_layer_folded``): each ``ConvBNAct`` is its conv followed by the
identity BN that ``fold_batchnorm`` writes, which is what the JAX package's
folded variables run through in the flax graph. The fused kernels of the
folded MobileNetV2 backbone keep each block's expand and depthwise outputs
in shared memory and never return them, so an int8 snap of those sites
cannot happen there: this path does not run them. ``QuantSim`` snaps each
site's output with forward hooks, which it holds only while it runs.

CLI: ``python -m mobilenet_yolo_tpu_torch.tools.quantize``.
"""

from __future__ import annotations

from typing import Iterable, Iterator, Mapping

import numpy as np
import torch
from torch import nn

from mobilenet_yolo_tpu_torch.convert import state_dict_to_flax
from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm
from mobilenet_yolo_tpu_torch.models.layers import ConvBNAct
from mobilenet_yolo_tpu_torch.tools_io import _flatten, _unflatten


def iter_cba_sites(model: nn.Module) -> Iterator[tuple[str, ConvBNAct]]:
    """Yield ``(site, module)`` for every ``ConvBNAct`` of ``model``, the
    site being its module path joined by ``/``."""
    for name, module in model.named_modules():
        if isinstance(module, ConvBNAct):
            yield name.replace(".", "/"), module


def per_layer_folded(model: nn.Module) -> nn.Module:
    """A copy of ``model`` with its BatchNorms folded into the convs, run
    through the per-layer modules: each ``ConvBNAct`` is its conv and the
    identity BN (scale 1, bias b', mean 0, var 1 - eps), never a fused
    kernel (see the module docstring)."""
    folded = fold_batchnorm(model)
    for _, module in iter_cba_sites(folded):
        module.folded = False
    return folded


def quantize_weights(model: nn.Module) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Per-output-channel symmetric int8 of every ``ConvBNAct`` kernel.

    Returns ``(qkernels, wscales)`` keyed by site: ``qkernels[site]`` int8
    HWIO, ``wscales[site]`` (C,) float32, ``kernel ~ qkernels * wscales``.
    Zero channels get scale 1 (their quantized weights are zero anyway).
    """
    qkernels: dict[str, np.ndarray] = {}
    wscales: dict[str, np.ndarray] = {}
    for site, module in iter_cba_sites(model):
        k = module.conv.weight.detach().cpu().numpy().astype(np.float32).transpose(2, 3, 1, 0)
        absmax = np.max(np.abs(k), axis=(0, 1, 2))
        s = np.where(absmax > 0, absmax / 127.0, 1.0).astype(np.float32)
        qkernels[site] = np.clip(np.rint(k / s), -127, 127).astype(np.int8)
        wscales[site] = s
    return qkernels, wscales


def _dequantized(q: np.ndarray, s: np.ndarray) -> torch.Tensor:
    """The int8-grid kernel ``q * s`` (HWIO, float32) as an OIHW tensor."""
    return torch.from_numpy(np.ascontiguousarray((q.astype(np.float32) * s).transpose(3, 2, 0, 1)))


def fake_quant_state(state: Mapping[str, torch.Tensor], qkernels: Mapping[str, np.ndarray],
                     wscales: Mapping[str, np.ndarray]) -> dict[str, torch.Tensor]:
    """``state`` with every quantized conv weight replaced by its int8-grid
    value ``q * s`` (in the weight's type and on its device): what the
    simulated int8 forward runs on."""
    out = dict(state)
    for site, q in qkernels.items():
        key = site.replace("/", ".") + ".conv.weight"
        out[key] = _dequantized(q, wscales[site]).to(state[key].dtype).to(state[key].device)
    return out


class _SiteHooks:
    """Forward hooks on every site of ``model`` calling ``fn(site, output)``
    (whose return, if not None, replaces the output), removed on exit."""

    def __init__(self, model: nn.Module, fn):
        self.model, self.fn, self.handles = model, fn, []

    def __enter__(self):
        for site, module in iter_cba_sites(self.model):
            self.handles.append(module.register_forward_hook(
                lambda _m, _args, y, site=site: self.fn(site, y)))
        return self

    def __exit__(self, *exc):
        for handle in self.handles:
            handle.remove()
        self.handles.clear()


def calibrate_activations(model: nn.Module, batches: Iterable) -> dict[str, float]:
    """Per-site activation scales ``max|x| / 127`` over ``batches`` (NHWC
    images, numpy or torch, in the model's parameter type).

    Each forward takes every site's absmax in float32 on the device; a site
    a forward calls twice keeps the last call's, as the JAX calibration
    trace does (``quant.py:130``). Across batches the host takes the
    maximum (``quant.py:141-152``); a site whose absmax is 0 gets scale 1.
    """
    device = next(model.parameters()).device
    model.eval()
    absmax: dict[str, float] = {}
    for images in batches:
        ranges: dict[str, torch.Tensor] = {}

        def record(site, y):
            ranges[site] = y.detach().float().abs().amax()

        with torch.inference_mode(), _SiteHooks(model, record):
            model(torch.as_tensor(images).to(device).permute(0, 3, 1, 2))
        values = torch.stack(list(ranges.values())).cpu().tolist()
        for site, value in zip(ranges, values):
            absmax[site] = max(absmax.get(site, 0.0), float(value))
    return {site: (v / 127.0 if v > 0 else 1.0) for site, v in absmax.items()}


class QuantSim(nn.Module):
    """``model`` with every calibrated ``ConvBNAct`` output snapped to its
    int8 grid: ``clip(rint(y / s), -127, 127) * s``, computed in float32 as
    the JAX package does (``quant.py:173-181``), cast back to ``y``'s type
    (float64 for a float64 model). Sites without
    a scale pass through, so an empty table is the model itself, bit for
    bit. ``eval.make_predict_fn`` takes it as it takes a model.

    Pair with ``fake_quant_state`` so the weights are on their grid too:
    together this is an int8 engine that dequantizes to float accumulators
    (the KL720-class deployment model).
    """

    def __init__(self, model: nn.Module, act_scales: Mapping[str, float]):
        super().__init__()
        if any(module.folded for _, module in iter_cba_sites(model)):
            raise ValueError("QuantSim runs the per-layer graph: fold with per_layer_folded, "
                             "not fold_batchnorm (the fused kernels hide the block sites)")
        self.model = model
        self.act_scales = {k: float(v) for k, v in act_scales.items()}

    def _snap(self, site: str, y: torch.Tensor) -> torch.Tensor | None:
        s = self.act_scales.get(site)
        if s is None:
            return None
        # a true float32 division on every device: divided by a Python
        # float, a CUDA tensor is multiplied by its reciprocal instead
        scale = torch.full((), s, dtype=torch.float32, device=y.device)
        return (torch.clamp(torch.round(y.float() / scale), -127, 127) * s).to(y.dtype)

    def forward(self, *args, **kwargs):
        with _SiteHooks(self.model, self._snap):
            return self.model(*args, **kwargs)


def save_int8(path: str, state: Mapping[str, torch.Tensor], qkernels, wscales,
              act_scales: Mapping[str, float]) -> None:
    """Write the deployment artifact in the JAX package's key layout
    (``quant.py:186-214``): ``wq/<site>`` int8 HWIO, ``ws/<site>`` float32,
    ``act/<site>`` float64, and the float remainder of ``state`` (the folded
    model's state dict: biases, identity BN, head output convs) under
    ``f32/params/...`` and ``f32/batch_stats/...``."""
    variables = state_dict_to_flax(state)
    flat: dict[str, np.ndarray] = {}
    for site, q in qkernels.items():
        flat[f"wq/{site}"] = q
        flat[f"ws/{site}"] = wscales[site]
    for site, s in act_scales.items():
        # float64, so load_int8 gives back the very scales (Python floats)
        flat[f"act/{site}"] = np.float64(s)
    skip = {f"f32/params/{site}/conv/kernel" for site in qkernels}
    remainder = _flatten(variables["params"], "f32/params/")
    remainder.update(_flatten(variables["batch_stats"], "f32/batch_stats/"))
    for key, value in remainder.items():
        if key not in skip:
            flat[key] = value
    np.savez(path, **flat)


def load_int8(path: str) -> tuple[dict, dict[str, float]]:
    """Load ``save_int8``'s artifact, or the JAX package's. Returns
    ``(variables, act_scales)``: ``variables`` the JAX package's numpy trees
    with the dequantized (int8-grid) kernels, for
    ``convert.load_flax_variables``; feed the loaded model and the scales
    to ``QuantSim`` to reproduce the simulated int8 graph."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    act_scales = {k[len("act/"):]: float(v) for k, v in flat.items() if k.startswith("act/")}
    tree = _unflatten({k[len("f32/"):]: v for k, v in flat.items() if k.startswith("f32/")})
    variables = {"params": tree.get("params", {}), "batch_stats": tree.get("batch_stats", {})}
    for key, q in flat.items():
        if not key.startswith("wq/"):
            continue
        site = key[len("wq/"):]
        node = variables["params"]
        for part in site.split("/"):
            node = node.setdefault(part, {})
        node.setdefault("conv", {})["kernel"] = q.astype(np.float32) * flat[f"ws/{site}"]
    return variables, act_scales

