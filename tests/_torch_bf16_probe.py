"""bf16 against float32 heads on trained weights, the port beside the JAX
package, on the CPU.

    JAX_PLATFORMS=cpu python tests/_torch_bf16_probe.py \
        --weights build/chip_smoke_fit/served_weights.pt --data-yaml <data.yaml>

``--weights`` is a served state dict of the port (``chip_smoke.py``'s fit
phase writes one beside its checkpoints); the JAX model gets the same
weights through the inverse of ``convert.py``'s mapping. On the first
``--images`` test images (352x352, the test loader's normalization) it
prints one JSON line: each package's bf16 heads against its own float32
heads, and the two float32 forwards against each other, as max |diff|
over the largest |logit| per head. The port runs bf16 under CPU autocast,
JAX as a ``dtype=bfloat16`` model.
"""

from __future__ import annotations

import argparse
import json
from pathlib import Path
import sys

import jax
import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from mobilenet_yolo_tpu.models import build_model as jax_build_model  # noqa: E402
from mobilenet_yolo_tpu_torch.config import load_config, load_yaml  # noqa: E402
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict  # noqa: E402
from mobilenet_yolo_tpu_torch.data.pipeline import DetectionDataset, Loader  # noqa: E402
from mobilenet_yolo_tpu_torch.data.records import RecordReader  # noqa: E402
from mobilenet_yolo_tpu_torch.models import build_model  # noqa: E402


def flax_variables(state_dict: dict, jax_model) -> dict:
    """The port's state dict as the JAX model's ``{"params", "batch_stats"}``
    numpy trees: each flax leaf takes the tensor ``convert`` maps it to
    (OIHW -> HWIO for 4-d kernels)."""
    shapes = jax.eval_shape(lambda x: jax_model.init(jax.random.PRNGKey(0), x, train=False),
                            jax.ShapeDtypeStruct((1, 64, 64, 3), jnp.float32))

    def leaf(collection, path, shape):
        tree = np.zeros(shape.shape, np.float32)
        for p in reversed(path):
            tree = {p.key: tree}
        (key, _), = flax_to_state_dict({collection: tree}).items()
        value = state_dict[key].float().numpy()
        if path[-1].key == "kernel" and value.ndim == 4:
            value = value.transpose(2, 3, 1, 0)
        return value.reshape(shape.shape)

    return {c: jax.tree_util.tree_map_with_path(lambda p, s, c=c: leaf(c, p, s), dict(shapes)[c])
            for c in ("params", "batch_stats")}


def rel_err(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--weights", required=True)
    ap.add_argument("--data-yaml", required=True)
    ap.add_argument("--images", type=int, default=32)
    args = ap.parse_args(argv)

    cfg = load_config(args.data_yaml)
    mc, data = cfg.model, load_yaml(args.data_yaml)
    norm = mc["normalize"]
    test = Loader(DetectionDataset(RecordReader(data["test_dataset_path"]["lmdb"]), phase="test"),
                  args.images, [[mc["img_w"], mc["img_h"]]], norm["mean"], norm["std"],
                  shuffle=False, pad_final=False, prefetch=0)
    x = next(iter(test))["images"]
    weights = torch.load(args.weights, map_location="cpu", weights_only=True)

    model = build_model(mc, device="cpu")
    model.load_state_dict(weights)
    model.eval()
    port = {}
    for name, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        with torch.inference_mode(), torch.autocast("cpu", dtype=torch.bfloat16,
                                                    enabled=dtype is not None):
            out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
        port[name] = {k: v.float().permute(0, 2, 3, 1).numpy() for k, v in out.items()}

    variables = flax_variables(weights, jax_build_model(mc, "mbv2"))
    ref = {}
    for name, dtype in (("f32", None), ("bf16", jnp.bfloat16)):
        jm = jax_build_model(mc, "mbv2", dtype=dtype)
        out = jax.jit(lambda v, a, jm=jm: jm.apply(v, a, train=False))(variables, x)
        ref[name] = {k: np.asarray(v, np.float32) for k, v in out.items()}

    heads = ("out0", "out1")
    print(json.dumps({
        "images": int(x.shape[0]),
        "port_bf16_vs_f32": {k: rel_err(port["bf16"][k], port["f32"][k]) for k in heads},
        "jax_bf16_vs_f32": {k: rel_err(ref["bf16"][k], ref["f32"][k]) for k in heads},
        "port_f32_vs_jax_f32": {k: rel_err(port["f32"][k], ref["f32"][k]) for k in heads},
    }))


if __name__ == "__main__":
    main()
