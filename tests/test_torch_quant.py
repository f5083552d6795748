"""The port's int8 PTQ (``mobilenet_yolo_tpu_torch/quant.py``, its
``tools/quantize.py``) against the JAX package's ``quant.py``, on the CPU.

The model is the small full-width MBv2-YOLO at 96x96 of
``tests/test_quant.py``'s yaml, with JAX's own init perturbed
(``_torch_parity.perturb``) and folded by JAX's ``fold_batchnorm``; the
same folded weights go into both packages, the port's through its
per-layer modules (``quant.per_layer_folded``'s graph). One module fixture
holds JAX's tables and heads, so its jitted forwards run once.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as jnn

from mobilenet_yolo_tpu import quant as jquant
from mobilenet_yolo_tpu.config import load_config as jax_load_config
from mobilenet_yolo_tpu.models import build_model as jax_build_model
from mobilenet_yolo_tpu.models.bn_fold import fold_batchnorm as jax_fold_batchnorm
from mobilenet_yolo_tpu.models.layers import ConvBNAct as JaxConvBNAct
from mobilenet_yolo_tpu_torch import quant
from mobilenet_yolo_tpu_torch.convert import load_flax_variables
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.layers import ConvBNAct
from mobilenet_yolo_tpu_torch.tools_io import _flatten

from _torch_parity import jax_init, perturb

pytestmark = pytest.mark.filterwarnings("ignore::DeprecationWarning")

# Calibration and simulation are compared in float64 on both sides
# (``jax.enable_x64``, a float64 port model): both take each site's absmax
# and snap it in float32 (``quant.py:130, 176``), so float32 rounding of a
# float64 output is where the two could part, and two float64 values a few
# ulp apart round to the same float32 but with a chance of ~1e-8.
# Activation scales, port vs JAX: one float32 spacing, relative.
ACT_SCALE_RTOL = 2.0 ** -23
# QuantSim heads, port vs JAX with JAX's own scales, relative to the
# largest logit: float64 summation order alone (measured 5.6e-16) while no
# site's grid value flips. A flip (a value on the two sides of a grid
# boundary) moves it one step (under 1% of the site's range) and the rest
# of the network carries that on: at 96x96 the int8 simulation itself
# moves the heads only ~1.8% from the float model, and in float32 the two
# frameworks' flips cascade to 1.7e-2 (measured), so only float64 makes a
# comparison that sees the snapping. In float64 none of the ~2.4 M grid
# values flips on this input (measured), so none may, and the heads are
# held to SIM_HEAD_REL_TOL.
SIM_HEAD_REL_TOL = 1e-9


def _small_yaml(tmp_path):
    """tests/test_quant.py:_small_yaml."""
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


def _heads(out) -> dict:
    return {k: np.asarray(out[k]) for k in ("out0", "out1")}


def _port_heads(model, x: np.ndarray) -> dict:
    with torch.inference_mode():
        out = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    return {k: out[k].permute(0, 2, 3, 1).numpy() for k in ("out0", "out1")}


def _float64(tree):
    return jax.tree_util.tree_map(lambda v: np.asarray(v, np.float64), tree)


def _snap(y, s):
    """``quant.py:176-179`` in numpy: the grid index of ``y`` at scale ``s``."""
    return np.clip(np.rint(np.asarray(y, np.float32) / np.float32(s)), -127, 127)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    data_yaml = _small_yaml(tmp_path_factory.mktemp("quantcfg"))
    cfg = jax_load_config(data_yaml)
    jmodel = jax_build_model(cfg.model)
    x = np.random.default_rng(0).normal(0, 0.25, size=(2, 96, 96, 3)).astype(np.float32)
    raw = perturb(jax_init(jmodel, x), seed=1)
    folded = jax_fold_batchnorm(raw)
    qk, ws = jquant.quantize_weights(folded["params"])
    fq = jquant.fake_quant_variables(folded, qk, ws)
    heads = jax.jit(lambda v, x: jmodel.apply(v, x, train=False))(folded, x)
    with jax.enable_x64(True):
        jm64 = jax_build_model(cfg.model, dtype=jnp.float64)
        fq64, x64 = _float64(fq), x.astype(np.float64)
        scales = jquant.calibrate_activations(jm64, fq64, [x64])

        def sim_capture(v, x):
            """JAX's QuantSim with every site's output kept before its snap."""
            seen = {}

            def grab(next_fun, args, kwargs, context):
                y = next_fun(*args, **kwargs)
                if isinstance(context.module, JaxConvBNAct) \
                        and context.method_name == "__call__":
                    site = "/".join(context.module.path)
                    seen[site] = y
                    q = jnp.clip(jnp.rint(y.astype(jnp.float32) / scales[site]), -127, 127)
                    y = (q * scales[site]).astype(y.dtype)
                return y

            with jnn.intercept_methods(grab):
                out = jm64.apply(v, x, train=False)
            return out, seen

        sim_heads, site_y = jax.jit(sim_capture)(fq64, x64)
        real_sim = jax.jit(lambda v, x: jquant.QuantSim(jm64, scales).apply(
            v, x, train=False))(fq64, x64)
        sim_heads, real_sim = _float64(_heads(sim_heads)), _float64(_heads(real_sim))
        site_y = _float64(site_y)
    for key in sim_heads:  # the capture is JAX's QuantSim
        np.testing.assert_array_equal(sim_heads[key], real_sim[key])
    return dict(cfg=cfg, data_yaml=data_yaml, jmodel=jmodel, x=x, raw=raw, folded=folded,
                qk=qk, ws=ws, fq=fq, fq64=fq64, scales=scales, heads=_heads(heads),
                sim_heads=sim_heads, site_y=site_y)


def _port(setup, variables, dtype=None) -> torch.nn.Module:
    model = build_model(setup["cfg"].model, dtype=dtype, device="cpu")
    return load_flax_variables(model, variables).eval()


def test_weight_tables_match_jax(setup):
    model = _port(setup, setup["folded"])
    qk, ws = quant.quantize_weights(model)
    assert set(qk) == set(setup["qk"]) == {site for site, _ in quant.iter_cba_sites(model)}
    assert len(qk) > 20 and not any(site.endswith("/out") for site in qk)
    for site, q in qk.items():
        assert q.dtype == np.int8 and q.shape == setup["qk"][site].shape
        np.testing.assert_array_equal(q, setup["qk"][site], err_msg=site)
        assert ws[site].dtype == np.float32
        np.testing.assert_array_max_ulp(ws[site], setup["ws"][site], maxulp=1)


def test_fake_quant_state_matches_jax(setup):
    model = _port(setup, setup["folded"])
    qk, ws = quant.quantize_weights(model)
    fq = quant.fake_quant_state(model.state_dict(), qk, ws)
    want = _port(setup, setup["fq"]).state_dict()
    assert fq.keys() == want.keys()
    for key in fq:
        torch.testing.assert_close(fq[key], want[key], rtol=0, atol=0, msg=key)


def test_per_layer_folded_runs_the_folded_weights_per_layer(setup):
    """``per_layer_folded`` holds the folded weights of ``fold_batchnorm``
    with every site's ``folded`` flag off, and its heads are the unfolded
    model's within the parity tests' float32 tolerance (1e-4)."""
    unfolded = _port(setup, setup["raw"])
    model = quant.per_layer_folded(unfolded)
    assert not any(m.folded for _, m in quant.iter_cba_sites(model))
    jax_folded = _port(setup, setup["folded"]).state_dict()
    for key, value in model.state_dict().items():
        if not key.endswith("num_batches_tracked"):
            torch.testing.assert_close(value, jax_folded[key], rtol=2e-6, atol=1e-7, msg=key)
    got, want = _port_heads(model, setup["x"]), _port_heads(unfolded, setup["x"])
    for key in got:
        np.testing.assert_allclose(got[key], want[key], rtol=1e-4, atol=1e-4)
    # the JAX folded heads through the flax graph
    for key in got:
        np.testing.assert_allclose(got[key], setup["heads"][key], rtol=1e-4, atol=1e-4)


def test_activation_scales_match_jax(setup):
    model = _port(setup, setup["fq64"], torch.float64)
    scales = quant.calibrate_activations(model, [setup["x"].astype(np.float64)])
    assert set(scales) == set(setup["scales"])
    for site, s in scales.items():
        assert isinstance(s, float) and s > 0
        assert s == pytest.approx(setup["scales"][site], rel=ACT_SCALE_RTOL), site


def test_quantsim_heads_match_jax(setup):
    """With JAX's own scales, every site's grid values equal JAX's, and the
    heads agree to float64 summation order."""
    model = _port(setup, setup["fq64"], torch.float64)
    seen, hooks = {}, []
    for site, module in quant.iter_cba_sites(model):
        def grab(_module, _args, y, site=site):
            seen[site] = y.permute(0, 2, 3, 1).numpy().copy()  # before QuantSim's snap
        hooks.append(module.register_forward_hook(grab))
    got = _port_heads(quant.QuantSim(model, setup["scales"]), setup["x"].astype(np.float64))
    for hook in hooks:
        hook.remove()
    assert seen.keys() == setup["site_y"].keys() == setup["scales"].keys()
    flips = {site: int((_snap(y, setup["scales"][site])
                        != _snap(setup["site_y"][site], setup["scales"][site])).sum())
             for site, y in seen.items()}
    assert not any(flips.values()), {k: v for k, v in flips.items() if v}
    for key, want in setup["sim_heads"].items():
        assert got[key].dtype == np.float64 and np.isfinite(got[key]).all()
        err = float(np.abs(got[key] - want).max() / np.abs(want).max())
        assert err <= SIM_HEAD_REL_TOL, (key, err)


def test_empty_table_is_the_model(setup):
    model = _port(setup, setup["folded"])
    got = _port_heads(quant.QuantSim(model, {}), setup["x"])
    want = _port_heads(model, setup["x"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])


def test_quantsim_refuses_the_fused_graph(setup):
    from mobilenet_yolo_tpu_torch.models.bn_fold import fold_batchnorm

    with pytest.raises(ValueError, match="per_layer_folded"):
        quant.QuantSim(fold_batchnorm(_port(setup, setup["raw"])), {})


def test_int8_artifact_loads_in_both_packages(setup, tmp_path):
    """Both packages write the same artifact from the same tables, each
    loads the other's, and the loaded graphs give the saver's heads."""
    model = _port(setup, setup["folded"])
    qk, ws = quant.quantize_weights(model)
    ours, theirs = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    quant.save_int8(ours, model.state_dict(), qk, ws, setup["scales"])
    jquant.save_int8(theirs, setup["folded"], setup["qk"], setup["ws"], setup["scales"])
    with np.load(ours) as a, np.load(theirs) as b:
        assert set(a.files) == set(b.files)
        for key in a.files:
            assert a[key].dtype == b[key].dtype, key
            np.testing.assert_array_equal(a[key], b[key], err_msg=key)

    want = _port_heads(quant.QuantSim(_port(setup, setup["fq"]), setup["scales"]), setup["x"])
    variables, scales = quant.load_int8(theirs)
    assert scales == setup["scales"]
    got = _port_heads(quant.QuantSim(_port(setup, variables), scales), setup["x"])
    for key in want:
        np.testing.assert_array_equal(got[key], want[key])

    jvars, jscales = jquant.load_int8(ours)
    assert jscales == setup["scales"]
    jsim = jax.jit(lambda v, x: jquant.QuantSim(setup["jmodel"], setup["scales"]).apply(
        v, x, train=False))
    jwant = _heads(jsim(setup["fq"], setup["x"]))
    for key, value in _heads(jsim(jvars, setup["x"])).items():
        np.testing.assert_array_equal(value, jwant[key])


class _JaxTwice(jnn.Module):
    """One ConvBNAct site applied twice in a forward, as
    ``connect_for_S16`` is in MBv3-YOLO."""

    @jnn.compact
    def __call__(self, x, train: bool = False):
        site = JaxConvBNAct(4, kernel=3, act="leaky", name="site")
        return site(site(x, train), train)


class _Twice(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.site = ConvBNAct(4, 4, 3, act="leaky")

    def forward(self, x):
        return self.site(self.site(x))


def test_a_site_called_twice_keeps_its_last_call():
    x = np.random.default_rng(3).normal(0, 1, (2, 8, 8, 4))
    jmodel = _JaxTwice()
    variables = _float64(perturb(jax_init(jmodel, x.astype(np.float32)), seed=4))
    with jax.enable_x64(True):
        want = jquant.calibrate_activations(jmodel, variables, [x])
    model = load_flax_variables(_Twice().double(), variables).eval()
    got = quant.calibrate_activations(model, [x])
    with torch.inference_mode():
        t = torch.from_numpy(x).permute(0, 3, 1, 2)
        first = model.site(t)
        last = model.site(first)
    assert set(got) == set(want) == {"site"}
    assert got["site"] == float(last.abs().max().float()) / 127.0
    assert got["site"] == pytest.approx(want["site"], rel=ACT_SCALE_RTOL)
    # the first call's range differs, so the rule is seen
    assert abs(float(first.abs().max()) - float(last.abs().max())) > 1e-3


def test_quantize_cli_random_weights(setup, tmp_path):
    from mobilenet_yolo_tpu_torch.tools import quantize as quantize_cli

    out = str(tmp_path / "cli_int8.npz")
    report = quantize_cli.main(["--checkpoint", "none", "--random-weights", "--data-yaml",
                                setup["data_yaml"], "--out", out, "--batch-size", "2",
                                "--calib-batches", "2", "--device", "cpu"])
    assert report["sites"] == len(setup["qk"])
    assert report["int8_weights"] == sum(int(q.size) for q in setup["qk"].values())
    assert report["total_params"] == sum(
        int(np.asarray(p).size) for p in jax.tree_util.tree_leaves(setup["folded"]["params"]))
    assert 0.5 < report["int8_fraction"] <= 1.0 and report["out"] == out
    variables, scales = quant.load_int8(out)
    assert len(scales) == report["sites"]
    _port(setup, variables)  # a strict load
    jvars, jscales = jquant.load_int8(out)
    assert jscales == scales
    assert _flatten(jvars["params"], "").keys() == _flatten(setup["folded"]["params"], "").keys()
