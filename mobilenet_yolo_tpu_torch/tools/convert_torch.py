"""Convert checkpoints between the upstream reference's PyTorch formats and
the JAX package's flat ``.npz``.

Port of the JAX package's ``tools/convert_torch.py``, with its mapping
tables, ``convert``, ``export_state_dict``, ``load_torch_state_dict``,
``save_reference_checkpoint`` and CLI; the MobileNetV3 stage tables are the
port's own (``models/mobilenetv3.py``).

**reference -> npz** handles both reference formats (train.py:425-433):
per-epoch dicts with a ``model`` state_dict, and the whole-pickled-module
``model_best.pth.tar`` (loaded via its state_dict, like
inference.py:127-148). Also converts bare ImageNet MobileNetV2 backbones
(mobilenetv2.py:160-185), including the ``features2.N -> features.14+N``
key remap. The ``.npz`` is the JAX package's format, which the port's
``cli/infer.py`` and ``--init-from`` read too.

**npz or port checkpoint -> reference** (``--reverse``) writes the
reference's per-epoch dict ``{epoch, model, acc, best_acc, conf}`` that
``train.py --resume`` and ``model.load_state_dict(ckpt["model"])``
consume, from a flat ``.npz`` or from a checkpoint directory of the port's
trainer (its served weights, ``train/checkpoints.py:served_state_dict``);
and, when the reference package is importable (``--wrap-module``), the
whole pickled module that ``inference.py:127-148`` loads as
``model_best.pth.tar``.

Layout mapping:

* conv weights: reference OIHW <-> flax HWIO (transpose 2,3,1,0);
  depthwise convs (groups == out_channels) map (C,1,kh,kw) <-> (kh,kw,1,C)
  under the same transpose, matching ``feature_group_count``
* BatchNorm: weight<->scale, bias<->bias, running_mean/var <-> batch_stats

Usage:
    python -m mobilenet_yolo_tpu_torch.tools.convert_torch --torch <ckpt.pth.tar> \
        --out <params.npz> [--what full|backbone]
    python -m mobilenet_yolo_tpu_torch.tools.convert_torch --reverse \
        --params <params.npz|ckptdir> --out <ckpt.pth.tar> [--what full|full_seg|mbv3] \
        [--wrap-module]
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

from mobilenet_yolo_tpu_torch.models.mobilenetv3 import LARGE_STAGE1, LARGE_STAGE2

# --- torch-key templates ---------------------------------------------------

_BN_SUFFIX = {"scale": "weight", "bias": "bias"}
_BN_STATS_SUFFIX = {"mean": "running_mean", "var": "running_var"}


def _conv(prefix):
    return {("params", "conv", "kernel"): f"{prefix}.weight"}


def _bn(prefix):
    d = {("params", "bn", k): f"{prefix}.{v}" for k, v in _BN_SUFFIX.items()}
    d.update({("batch_stats", "bn", k): f"{prefix}.{v}"
              for k, v in _BN_STATS_SUFFIX.items()})
    return d


def _conv_bn(flax_name, torch_conv, torch_bn):
    """ConvBNAct module -> {flax subpath: torch key}."""
    out = {}
    for (col, sub, leaf), tk in {**_conv(torch_conv), **_bn(torch_bn)}.items():
        out[(col, flax_name, sub, leaf)] = tk
    return out


def mbv2_backbone_mapping(prefix: str = "backbone.") -> dict:
    """MobileNetV2 (reference models/mobilenetv2.py:94-144)."""
    m = {}
    # stem: features.0 = Sequential(conv, bn, relu6)
    m.update(_conv_bn("stem", f"{prefix}features.0.0", f"{prefix}features.0.1"))
    # 17 inverted-residual blocks: features.1..13 + features2.0..3
    n_blocks_stage1 = 13
    for i in range(17):
        if i < n_blocks_stage1:
            tp = f"{prefix}features.{i + 1}.conv"
        else:
            tp = f"{prefix}features2.{i - n_blocks_stage1}.conv"
        if i == 0:
            # expand_ratio == 1: conv = [dw, bn, act, pw, bn]
            layers = {"depthwise": (0, 1), "project": (3, 4)}
        else:
            # conv = [pw, bn, act, dw, bn, act, pw, bn]
            layers = {"expand": (0, 1), "depthwise": (3, 4), "project": (6, 7)}
        for sub, (ci, bi) in layers.items():
            for (col, name, s2, leaf), tk in _conv_bn(
                    sub, f"{tp}.{ci}", f"{tp}.{bi}").items():
                m[(col, f"block{i}", name, s2, leaf)] = tk
    # final 1x1: backbone.conv = Sequential(conv, bn, relu6)
    m.update(_conv_bn("head_conv", f"{prefix}conv.0", f"{prefix}conv.1"))
    return m


def _basic_conv(flax_name, torch_prefix):
    """BasicConv (mbv2_yolo.py:16-44): .conv + .bn submodules."""
    return _conv_bn(flax_name, f"{torch_prefix}.conv", f"{torch_prefix}.bn")


def _connect(flax_name, torch_prefix):
    """Connect (mbv2_yolo.py:93-104): conv = Sequential(BasicConv dw, BasicConv pw)."""
    m = {}
    for sub, idx in (("dw", 0), ("pw", 1)):
        for (col, n, s2, leaf), tk in _basic_conv(
                sub, f"{torch_prefix}.conv.{idx}").items():
            m[(col, flax_name, n, s2, leaf)] = tk
    return m


def _dwconv3(flax_name, torch_prefix):
    """DepthwiseConvolution (mbv2_yolo.py:70-76): Sequential of 3 BasicConv."""
    m = {}
    for sub, idx in (("dw", 0), ("pw1", 1), ("pw2", 2)):
        for (col, n, s2, leaf), tk in _basic_conv(
                sub, f"{torch_prefix}.{idx}").items():
            m[(col, flax_name, n, s2, leaf)] = tk
    return m


def _head(flax_name, torch_prefix):
    """yolo_head/seg_head (mbv2_yolo.py:77-92): 3 BasicConv + biased 1x1."""
    m = {}
    for sub, idx in (("dw", 0), ("pw1", 1), ("pw2", 2)):
        for (col, n, s2, leaf), tk in _basic_conv(
                sub, f"{torch_prefix}.{idx}").items():
            m[(col, flax_name, n, s2, leaf)] = tk
    m[("params", flax_name, "out", "kernel")] = f"{torch_prefix}.3.weight"
    m[("params", flax_name, "out", "bias")] = f"{torch_prefix}.3.bias"
    return m


def mbv2_yolo_mapping(segmentation: bool = False) -> dict:
    """Full MBv2-YOLO detector (reference mbv2_yolo.py:105-135)."""
    m = {}
    for (col, *path), tk in mbv2_backbone_mapping("backbone.").items():
        m[(col, "backbone", *path)] = tk
    m.update(_basic_conv("conv_for_S32", "conv_for_S32"))
    m.update(_connect("connect_for_S32", "connect_for_S32"))
    m.update(_head("yolo_headS32", "yolo_headS32"))
    m.update(_dwconv3("conv_for_S16", "conv_for_S16"))
    m.update(_connect("connect_for_S16", "connect_for_S16"))
    m.update(_head("yolo_headS16", "yolo_headS16"))
    if segmentation:
        m.update(_dwconv3("seg_conv_for_S16", "seg_conv_for_S16"))
        m.update(_connect("seg_connect_for_S16", "seg_connect_for_S16"))
        m.update(_head("seg_headS16", "seg_headS16"))
    return m


def mbv3_backbone_mapping(prefix: str = "backbone.") -> dict:
    """MobileNetV3-Large (reference models/mobilenetv3.py:77-136).

    torch names: conv1/bn1 stem, bneck.{0..12} + bneck2.{0,1} Blocks with
    conv1/bn1 (expand), conv2/bn2 (depthwise), conv3/bn3 (project), optional
    se (SeModule.se Sequential: 0 conv, 1 bn, 3 conv, 4 bn) and a
    conv+bn ``shortcut`` Sequential when stride==1 and channels change.
    """
    m = {}
    m.update(_conv_bn("stem", f"{prefix}conv1", f"{prefix}bn1"))

    def block(flax_name, tp, spec, in_ch):
        _, _, out_ch, _, use_se, stride = spec
        sub = {}
        sub.update(_conv_bn("expand", f"{tp}.conv1", f"{tp}.bn1"))
        sub.update(_conv_bn("depthwise", f"{tp}.conv2", f"{tp}.bn2"))
        sub.update(_conv_bn("project", f"{tp}.conv3", f"{tp}.bn3"))
        if use_se:
            sub.update({(c, "se", n, s, l): tk for (c, n, s, l), tk in
                        {**_conv_bn("fc1", f"{tp}.se.se.0", f"{tp}.se.se.1"),
                         **_conv_bn("fc2", f"{tp}.se.se.3", f"{tp}.se.se.4")}.items()})
        if stride == 1 and in_ch != out_ch:
            sub.update(_conv_bn("shortcut", f"{tp}.shortcut.0", f"{tp}.shortcut.1"))
        for (c, *path), tk in sub.items():
            m[(c, flax_name, *path)] = tk
        return out_ch

    in_ch = 16
    for i, spec in enumerate(LARGE_STAGE1):
        in_ch = block(f"bneck{i}", f"{prefix}bneck.{i}", spec, in_ch)
    for i, spec in enumerate(LARGE_STAGE2):
        in_ch = block(f"bneck2_{i}", f"{prefix}bneck2.{i}", spec, in_ch)
    m.update(_conv_bn("head_conv", f"{prefix}conv2", f"{prefix}bn2"))
    return m


def mbv3_yolo_mapping() -> dict:
    """MBv3-YOLO detector (reference models/mbv3_yolo.py:97-121)."""
    m = {}
    for (col, *path), tk in mbv3_backbone_mapping("backbone.").items():
        m[(col, "backbone", *path)] = tk
    m.update(_dwconv3("conv_for_S32", "conv_for_S32"))
    m.update(_connect("connect_for_S32", "connect_for_S32"))
    m.update(_head("yolo_headS32", "yolo_headS32"))
    m.update(_connect("connect_for_S16", "connect_for_S16"))
    m.update(_head("yolo_headS16", "yolo_headS16"))
    return m


def convert(state_dict: dict, mapping: dict) -> tuple[dict, dict]:
    """torch state_dict -> (params, batch_stats) nested numpy dicts."""
    params: dict = {}
    batch_stats: dict = {}
    missing = []
    for (col, *path), torch_key in mapping.items():
        if torch_key not in state_dict:
            missing.append(torch_key)
            continue
        w = np.asarray(state_dict[torch_key])
        leaf = path[-1]
        if leaf == "kernel" and w.ndim == 4:
            w = w.transpose(2, 3, 1, 0)  # OIHW -> HWIO
        tree = params if col == "params" else batch_stats
        node = tree
        for p in path[:-1]:
            node = node.setdefault(p, {})
        node[leaf] = w
    if missing:
        print(f"warning: {len(missing)} torch keys missing, e.g. {missing[:5]}",
              file=sys.stderr)
    return params, batch_stats


def export_state_dict(params: dict, batch_stats: dict,
                      mapping: dict) -> dict:
    """flax (params, batch_stats) -> torch state_dict (numpy values).

    Exact inverse of :func:`convert` under the same mapping: 4-d kernels
    transpose HWIO -> OIHW; every mapping entry must resolve in the tree
    (a trained checkpoint covers the whole model, so a miss is a wiring
    error, not a warning)."""
    sd = {}
    missing = []
    for (col, *path), torch_key in mapping.items():
        node = params if col == "params" else batch_stats
        try:
            for p in path:
                node = node[p]
        except (KeyError, TypeError):
            missing.append("/".join((col, *path)))
            continue
        w = np.asarray(node)
        if path[-1] == "kernel" and w.ndim == 4:
            w = w.transpose(3, 2, 0, 1)  # HWIO -> OIHW
        sd[torch_key] = np.ascontiguousarray(w)
    if missing:
        raise KeyError(f"{len(missing)} flax paths missing from the tree, "
                       f"e.g. {missing[:5]}")
    return sd


def save_reference_checkpoint(path: str, state_dict: dict, *,
                              epoch: int = 0, acc: float = 0.0,
                              best_acc: float = 0.0,
                              val_conf: float = 0.1) -> None:
    """Write the reference's per-epoch checkpoint dict (train.py:175-182,
    425-428; resume keys at train.py:144-150): ``{epoch, model, acc,
    best_acc, conf}``. ``optimizer`` is intentionally absent — torch
    optimizer state cannot be fabricated without the torch module; the
    reference's inference/fine-tune loaders only read ``model``."""
    import torch
    torch.save({
        "epoch": int(epoch),
        "model": {k: torch.from_numpy(np.array(v))  # copy: torch rejects
                  for k, v in state_dict.items()},  # non-writable views
        "acc": float(acc),
        "best_acc": float(best_acc),
        "conf": float(val_conf),
    }, path)


def save_reference_module(path: str, state_dict: dict, config: dict,
                          val_conf: float = 0.1) -> None:
    """Wrap the exported weights in the ACTUAL reference module and pickle
    it whole — byte-compatible with ``model_best.pth.tar`` (train.py:431),
    the format ``inference.py:127-148`` loads. Requires the reference
    package (``models.mbv2_yolo``) on sys.path; raises ImportError
    otherwise."""
    import torch
    import models.mbv2_yolo as ref_mbv2_yolo
    net = ref_mbv2_yolo.yolo(config=config)
    # intersection update, exactly like the reference's own loader
    # (inference.py:137-146): the reference module instantiates its seg
    # trunk (seg_conv/connect_for_S16) even in detection-only configs, so
    # a detection-only export legitimately misses those keys — but an
    # EXPORTED key the module doesn't expect is a wiring error
    model_dict = net.state_dict()
    unexpected = [k for k in state_dict if k not in model_dict]
    if unexpected:
        raise KeyError(f"{len(unexpected)} exported keys not in the "
                       f"reference module, e.g. {unexpected[:5]}")
    model_dict.update({k: torch.from_numpy(np.array(v))  # copy: torch
                       for k, v in state_dict.items()})  # rejects r/o views
    net.load_state_dict(model_dict)
    net.eval()
    for head_loss in net.yolo_losses:
        head_loss.val_conf = float(val_conf)
    torch.save(net, path)


def load_torch_state_dict(path: str) -> dict:
    import torch
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if hasattr(obj, "state_dict"):
        obj = obj.state_dict()        # whole pickled module (model_best)
    elif isinstance(obj, dict) and "model" in obj:
        obj = obj["model"]            # per-epoch checkpoint dict
    elif isinstance(obj, dict) and "state_dict" in obj:
        obj = obj["state_dict"]
    # Canonicalize to the reference *module* naming (features2.N for the
    # stage-2 blocks), which all mappings here use. Detector checkpoints
    # (model.state_dict()) already carry features2.N; bare ImageNet
    # checkpoints use a single continuous features.{0..17} Sequential
    # (mobilenetv2.py:167-179 remaps in the other direction when loading),
    # so rename features.{14..17} back to features2.{0..3}.
    remapped = {}
    for k, v in obj.items():
        k = k.replace("module.", "")
        for i in range(4):
            k = k.replace(f"features.{14 + i}.", f"features2.{i}.")
        remapped[k] = v.detach().numpy() if hasattr(v, "detach") else np.asarray(v)
    return remapped


def _load_flax(path: str) -> tuple[dict, dict]:
    """(params, batch_stats) numpy trees from a flat ``.npz`` or from the
    served weights of a port checkpoint directory."""
    if os.path.isdir(path):
        from mobilenet_yolo_tpu_torch.convert import state_dict_to_flax
        from mobilenet_yolo_tpu_torch.train.checkpoints import (CheckpointManager,
                                                                served_state_dict)
        raw = CheckpointManager(path).restore_latest_raw()
        if raw is None:
            raise FileNotFoundError(f"no checkpoint found at {path}")
        variables = state_dict_to_flax(served_state_dict(raw))
        return variables["params"], variables["batch_stats"]
    from mobilenet_yolo_tpu_torch.tools_io import load_params_npz
    return load_params_npz(path)


def _mapping_for(what: str) -> dict:
    if what == "mbv3":
        return mbv3_yolo_mapping()
    return mbv2_yolo_mapping(segmentation=(what == "full_seg"))


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--torch", help="input .pth[.tar] (forward mode)")
    parser.add_argument("--out", required=True,
                        help="output .npz (forward) / .pth.tar (--reverse)")
    parser.add_argument("--what", default="full",
                        choices=["full", "full_seg", "backbone",
                                 "mbv3", "mbv3_backbone"])
    parser.add_argument("--reverse", action="store_true",
                        help="export flax -> reference torch checkpoint")
    parser.add_argument("--params",
                        help="for --reverse: input params .npz (tools_io format; "
                             "tools/export.py --what npz writes one), or a "
                             "checkpoint directory of the port's trainer")
    parser.add_argument("--val-conf", type=float, default=0.1,
                        help="val_conf persisted in the exported checkpoint"
                             " (reference train.py:149-150)")
    parser.add_argument("--epoch", type=int, default=0)
    parser.add_argument("--best-acc", type=float, default=0.0)
    parser.add_argument("--wrap-module", action="store_true",
                        help="ALSO write <out-stem>_model_best.pth.tar: the "
                             "whole pickled reference module "
                             "(inference.py:127-148 format); needs the "
                             "reference package importable")
    parser.add_argument("--model-config",
                        help="model config yaml for --wrap-module "
                             "(anchors/masks/thresholds)")
    args = parser.parse_args(argv)

    if args.reverse:
        if not args.params:
            parser.error("--reverse requires --params <npz>")
        if args.what.endswith("backbone"):
            parser.error("--reverse exports full detectors only")
        params, batch_stats = _load_flax(args.params)
        sd = export_state_dict(params, batch_stats, _mapping_for(args.what))
        save_reference_checkpoint(args.out, sd, epoch=args.epoch,
                                  acc=args.best_acc, best_acc=args.best_acc,
                                  val_conf=args.val_conf)
        print(f"wrote {args.out} ({len(sd)} tensors)")
        if args.wrap_module:
            if not args.model_config:
                parser.error("--wrap-module requires --model-config")
            import yaml
            with open(args.model_config) as f:
                config = yaml.safe_load(f)
            stem = args.out.rsplit(".pth", 1)[0]
            module_path = f"{stem}_model_best.pth.tar"
            save_reference_module(module_path, sd, config,
                                  val_conf=args.val_conf)
            print(f"wrote {module_path} (pickled reference module)")
        return

    if not args.torch:
        parser.error("forward mode requires --torch <ckpt>")
    sd = load_torch_state_dict(args.torch)
    if args.what in ("backbone", "mbv3_backbone"):
        # bare pretrained backbone (keys without the 'backbone.' prefix);
        # flax paths still live under the detector's 'backbone' module
        base = (mbv2_backbone_mapping("") if args.what == "backbone"
                else mbv3_backbone_mapping(""))
        mapping = {(k[0], "backbone", *k[1:]): v for k, v in base.items()}
        params, batch_stats = convert(sd, mapping)
    elif args.what == "mbv3":
        params, batch_stats = convert(sd, mbv3_yolo_mapping())
    else:
        params, batch_stats = convert(
            sd, mbv2_yolo_mapping(segmentation=(args.what == "full_seg")))

    from mobilenet_yolo_tpu_torch.tools_io import save_params_npz
    save_params_npz(args.out, params, batch_stats)
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
