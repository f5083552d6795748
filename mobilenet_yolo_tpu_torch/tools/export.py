"""Model export for serving.

Port of the JAX package's ``tools/export.py`` (the reference's deployment
path is its commented-out ONNX export, train.py:429-433):

* ``--what npz``   — flat .npz of params + batch stats (the JAX package's
  ``tools_io`` format, folded with ``--fold-bn``), read by ``cli/infer.py``
  and ``--init-from`` of either package
* ``--what aot``   — the detect pipeline (``make_predict_fn``) for one
  fixed input shape, traced by ``torch.export`` and written as a ``.pt2``
  program on the device it was exported for: loadable and callable without
  this package's model code (the serving artifact; JAX's ``jax.export``
  executable)
* ``--what graph`` — the printed graph of that exported program, where the
  NMS scan and (with ``--fold-bn``) the fused blocks appear as their
  registered ops ``myt::*`` (stands for JAX's ``--what stablehlo``)

Usage:
    python -m mobilenet_yolo_tpu_torch.tools.export --checkpoint <ckptdir|params.npz> \\
        --data-yaml <data.yaml> --what aot --out model.pt2 [--batch-size 8] [--fold-bn]

The program is served by ``import mobilenet_yolo_tpu_torch.kernels`` (which
registers the ops) and ``torch.export.load(path).module()(images,
val_conf)``: images (B, S, S, 3) float32 normalized NHWC on the device,
val_conf a 0-d float32 tensor there; it returns ``(dets, keep)``. The model
runs on ``--device`` (default ``cuda``, which raises without a card).
"""

from __future__ import annotations

import argparse

from mobilenet_yolo_tpu_torch.config import default_data_yaml


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--checkpoint", default="checkpoint")
    parser.add_argument("--data-yaml", dest="data_yaml", default=default_data_yaml())
    parser.add_argument("--backbone", default="mbv2", choices=["mbv2", "mbv3", "mbv3_macc"])
    parser.add_argument("--what", default="graph", choices=["npz", "aot", "graph"],
                        help="graph stands for the JAX tool's stablehlo: the exported "
                             "program's printed graph")
    parser.add_argument("--out", required=True)
    parser.add_argument("--batch-size", default=1, type=int)
    parser.add_argument("--img-size", default=None, type=int)
    parser.add_argument("--val-conf", default=0.3, type=float)
    parser.add_argument("--random-weights", action="store_true")
    parser.add_argument("--fold-bn", action="store_true",
                        help="fold BatchNorms into conv weights first")
    parser.add_argument("--device", default="cuda",
                        help="cuda (the default; raises without a card) or cpu")
    args = parser.parse_args(argv)

    import torch

    from mobilenet_yolo_tpu_torch.cli.infer import load_variables
    from mobilenet_yolo_tpu_torch.config import load_config
    from mobilenet_yolo_tpu_torch.models import build_model
    from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm
    from mobilenet_yolo_tpu_torch.tools import tool_device

    device = tool_device(args.device)
    cfg = load_config(args.data_yaml)
    model = build_model(cfg.model, args.backbone, device=device,
                        generator=torch.Generator().manual_seed(0))
    model = load_variables(model, args.checkpoint, random_ok=args.random_weights)
    if args.fold_bn:
        model = fold_batchnorm(model)

    if args.what == "npz":
        from mobilenet_yolo_tpu_torch.convert import state_dict_to_flax
        from mobilenet_yolo_tpu_torch.tools_io import save_params_npz

        variables = state_dict_to_flax(model.state_dict())
        save_params_npz(args.out, variables["params"], variables["batch_stats"])
        print(f"wrote {args.out}")
        return

    size = args.img_size or int(cfg.model["img_w"])
    images = torch.zeros((args.batch_size, size, size, 3), device=device)
    val_conf = torch.tensor(args.val_conf, device=device)
    program = export_predict(model, cfg.model, images, val_conf)
    if args.what == "graph":
        with open(args.out, "w") as f:
            f.write(str(program))
    else:  # aot
        torch.export.save(program, args.out)
    print(f"wrote {args.out} (call via import mobilenet_yolo_tpu_torch.kernels; "
          "torch.export.load(path).module()(images, val_conf))")


def export_predict(model, config: dict, images, val_conf):
    """``torch.export`` of ``make_predict_fn(model, config)`` at the shape
    and device of ``images`` (and the 0-d ``val_conf``): an
    ``ExportedProgram`` whose ``forward(images, val_conf)`` returns ``(dets,
    keep[, seg])``. It holds a frozen copy of the weights (no gradient), so
    its outputs carry no autograd graph; ``model`` is left as it was."""
    import copy

    import torch

    from mobilenet_yolo_tpu_torch.eval import make_predict_fn

    served = copy.deepcopy(model).requires_grad_(False)

    class Serve(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.model = served  # its weights become the program's parameters
            self.predict = make_predict_fn(served, config)

        def forward(self, images, val_conf):
            return self.predict(images, val_conf)

    return torch.export.export(Serve(), (images, val_conf))


if __name__ == "__main__":
    main()
