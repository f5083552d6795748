"""The port's serving export (``mobilenet_yolo_tpu_torch/tools/export.py``)
and the registered ops of kernels 1-4, on the CPU.

The model is the small full-width MBv2-YOLO at 96x96 of
``tests/test_export.py``'s yaml, with JAX's own init perturbed and its
``out`` convs redrawn at std 0.5, so the scores spread and the top-K order
is not decided by rounding noise; the tool reads those weights from an
``.npz``.

* ``--what aot``, unfolded and ``--fold-bn``: the ``.pt2`` program, loaded
  in this process and in a fresh one that imports only the kernels
  package, gives ``dets`` and ``keep`` bit-equal to ``make_predict_fn``
  (on the CPU both run the same aten ops and the ops' twins), and its graph
  holds the NMS op once and, folded, the fused blocks' ops 1 + 4 + 12 times.
* ``--what graph`` names the registered ops.
* ``--what npz`` reads back through ``cli/infer.py``'s ``load_variables``
  and through JAX's ``load_params_npz`` into JAX's forward, within the
  heads' parity tolerance of ``tests/test_torch_fused.py`` (1e-4).
* ``torch.library.opcheck`` on the four ops with CPU tensors.
"""

import json
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from mobilenet_yolo_tpu.config import load_config as jax_load_config
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.tools_io import load_params_npz as jax_load_params_npz
from mobilenet_yolo_tpu_torch.cli.infer import load_variables
from mobilenet_yolo_tpu_torch.config import load_config
from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress_reference
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm
from mobilenet_yolo_tpu_torch.tools import export as export_tool
from mobilenet_yolo_tpu_torch.tools_io import save_params_npz

from _torch_parity import REPO, jax_init, perturb

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning",
                                        "ignore::UserWarning")

HEAD_TOL = dict(atol=1e-4, rtol=1e-4)
VAL_CONF = 0.05
# registered op -> its call sites in a folded MobileNetV2 predict
FOLDED_OPS = {"myt.nms_suppress.default": 1, "myt.fused_stem_block0.default": 1,
              "myt.fused_inverted_residual_s2.default": 4,
              "myt.fused_inverted_residual.default": 12}


def _small_yaml(tmp_path):
    """tests/test_export.py:_write_small_yaml."""
    model_yaml = tmp_path / "model.yaml"
    model_yaml.write_text(
        "img_w: 96\nimg_h: 96\nclasses: 4\niou_weighting: 0.02\n"
        "train_img_size: [[96, 96]]\nbatch_size: 2\n"
        "yolo:\n  num_classes: 4\n  num_anchors: 3\n"
        "  ignore_thresh: [0.6, 0.55]\n  iou_thresh: 0.55\n"
        "  anchors: [[20, 24], [30, 30], [44, 40], [6, 8], [10, 14], "
        "[14, 10]]\n"
        "  mask: [[0, 1, 2], [3, 4, 5]]\n")
    data_yaml = tmp_path / "data.yaml"
    data_yaml.write_text(
        "train_root: .\ntest_root: .\n"
        f"model_config_path: {model_yaml}\n"
        "classes:\n  map: [bg, a, b, c]\n")
    return str(data_yaml)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    work = tmp_path_factory.mktemp("export")
    data_yaml = _small_yaml(work)
    jcfg = jax_load_config(data_yaml)
    jmodel = jax_build_model(jcfg.model)
    x = np.random.default_rng(0).normal(0, 0.8, (2, 96, 96, 3)).astype(np.float32)
    variables = perturb(jax_init(jmodel, x), seed=1, out_std=0.5)
    npz = str(work / "params.npz")
    save_params_npz(npz, variables["params"], variables["batch_stats"])
    apply = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))
    return dict(work=work, data_yaml=data_yaml, cfg=load_config(data_yaml), npz=npz, x=x,
                jmodel=jmodel, apply=apply)


def _eager(setup, fold: bool):
    model = load_variables(build_model(setup["cfg"].model, device="cpu"), setup["npz"])
    model = fold_batchnorm(model) if fold else model
    predict = make_predict_fn(model, setup["cfg"].model)
    return predict(torch.from_numpy(setup["x"]), torch.tensor(VAL_CONF))


def _run_tool(setup, what: str, fold: bool, name: str) -> str:
    out = str(setup["work"] / name)
    export_tool.main(["--checkpoint", setup["npz"], "--data-yaml", setup["data_yaml"],
                      "--what", what, "--out", out, "--batch-size", "2", "--device", "cpu",
                      "--val-conf", "0.3", *(["--fold-bn"] if fold else [])])
    return out


def _op_sites(program) -> dict:
    """Call sites of each ``myt`` op in the program's graphs, nested ones
    (the autocast region of ``make_predict_fn``) included."""
    counts: dict = {}
    for module in program.graph_module.modules():
        if isinstance(module, torch.fx.GraphModule):
            for node in module.graph.nodes:
                if node.op == "call_function" and str(node.target).startswith("myt."):
                    counts[str(node.target)] = counts.get(str(node.target), 0) + 1
    return counts


@pytest.mark.parametrize("fold", [False, True])
def test_export_aot_matches_predict(setup, fold, capsys):
    path = _run_tool(setup, "aot", fold, f"model_{fold}.pt2")
    assert "torch.export.load(path).module()(images, val_conf)" in capsys.readouterr().out
    program = torch.export.load(path)
    assert _op_sites(program) == (FOLDED_OPS if fold else {"myt.nms_suppress.default": 1})
    dets, keep = program.module()(torch.from_numpy(setup["x"]), torch.tensor(VAL_CONF))
    want_dets, want_keep = _eager(setup, fold)
    assert 0 < int(keep.sum()) < keep.numel()
    np.testing.assert_array_equal(keep.numpy(), want_keep.numpy())
    np.testing.assert_array_equal(dets.numpy(), want_dets.numpy())

    # a fresh process with the kernels package alone (no model code)
    inputs = setup["work"] / f"inputs_{fold}.npz"
    np.savez(inputs, x=setup["x"])
    script = ("import json, sys, numpy as np, torch\n"
              "import mobilenet_yolo_tpu_torch.kernels\n"
              "x = torch.from_numpy(np.load(sys.argv[2])['x'])\n"
              "dets, keep = torch.export.load(sys.argv[1]).module()(x, torch.tensor(%r))\n"
              "print(json.dumps({'dets': dets.tolist(), 'keep': keep.tolist()}))\n" % VAL_CONF)
    proc = subprocess.run([sys.executable, "-c", script, path, str(inputs)], cwd=REPO,
                          capture_output=True, text=True, timeout=300, check=False)
    assert proc.returncode == 0, proc.stderr[-3000:]
    fresh = json.loads(proc.stdout.strip().splitlines()[-1])
    np.testing.assert_array_equal(np.asarray(fresh["keep"]), want_keep.numpy())
    np.testing.assert_array_equal(np.asarray(fresh["dets"], np.float32), want_dets.numpy())


@pytest.mark.parametrize("fold", [False, True])
def test_export_graph_names_the_ops(setup, fold):
    text = open(_run_tool(setup, "graph", fold, f"graph_{fold}.txt")).read()
    assert "torch.ops.myt.nms_suppress.default" in text
    for op in ("fused_stem_block0", "fused_inverted_residual_s2", "fused_inverted_residual"):
        assert (f"torch.ops.myt.{op}.default" in text) == fold, op
    assert "aten.convolution" in text or "aten.conv2d" in text


@pytest.mark.parametrize("fold", [False, True])
def test_export_npz_reads_back_in_both_packages(setup, fold):
    path = _run_tool(setup, "npz", fold, f"params_{fold}.npz")
    model = load_variables(build_model(setup["cfg"].model, device="cpu"), path).eval()
    source = load_variables(build_model(setup["cfg"].model, device="cpu"), setup["npz"])
    source = fold_batchnorm(source) if fold else source
    for key, value in source.state_dict().items():
        torch.testing.assert_close(model.state_dict()[key], value, rtol=0, atol=0, msg=key)
    if not fold:  # the same weights serve the same detections
        predict = make_predict_fn(model, setup["cfg"].model)
        dets, keep = predict(torch.from_numpy(setup["x"]), torch.tensor(VAL_CONF))
        want_dets, want_keep = _eager(setup, fold)
        np.testing.assert_array_equal(keep.numpy(), want_keep.numpy())
        np.testing.assert_array_equal(dets.numpy(), want_dets.numpy())

    params, batch_stats = jax_load_params_npz(path)
    want = setup["apply"]({"params": params, "batch_stats": batch_stats}, setup["x"])
    with torch.inference_mode():
        got = model(torch.from_numpy(setup["x"]).permute(0, 3, 1, 2))
    for key in ("out0", "out1"):
        np.testing.assert_allclose(got[key].permute(0, 2, 3, 1).numpy(), np.asarray(want[key]),
                                   **HEAD_TOL)


def _op_args(name: str) -> tuple:
    g = torch.Generator().manual_seed(0)

    def r(*shape):
        return torch.randn(*shape, generator=g)

    if name == "nms_suppress":
        over = (torch.rand(2, 40, 40, generator=g) < 0.3).float().triu(1)
        return over, (torch.rand(2, 40, generator=g) < 0.8).float()
    if name == "fused_stem_block0":
        return (r(2, 8, 10, 3), r(3, 3, 3, 16), r(16), r(3, 3, 16), r(16), r(16, 8), r(8))
    block = (r(2, 8, 10, 8), r(8, 24), r(24), r(3, 3, 24), r(24), r(24, 8), r(8))
    return (*block, True) if name == "fused_inverted_residual" else block


@pytest.mark.parametrize("name", ["nms_suppress", "fused_inverted_residual",
                                  "fused_inverted_residual_s2", "fused_stem_block0"])
def test_opcheck_on_cpu_tensors(name):
    """The op's schema, fake implementation, autograd registration and
    dispatch pass ``torch.library.opcheck``, and it computes the twin."""
    args = _op_args(name)
    op = getattr(torch.ops.myt, name).default
    torch.library.opcheck(op, args)
    twins = {"nms_suppress": suppress_reference,
             "fused_inverted_residual": lambda *a: fb.inverted_residual_reference(*a, 1),
             "fused_inverted_residual_s2": lambda *a: fb.inverted_residual_reference(
                 *a, False, 2),
             "fused_stem_block0": fb.stem_block0_reference}
    torch.testing.assert_close(op(*args), twins[name](*args), rtol=0, atol=0)
