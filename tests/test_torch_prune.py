"""The port's Network Slimming against the JAX package's, on the CPU.

``prune.py``: the plan index for index, the sliced state dict and the
``prune:`` block, dead-channel pruning, the L1 penalty; the train steps in
``slim_mode`` loss and prox (plain and geometry, two steps each, float64 on
both sides); ``tools/prune.py``'s artifacts against the JAX CLI's on the
same weights, and the train CLI's ``--init-from`` reading them.

The plan tests need only variable trees: the port's full-width models give
them (``convert.state_dict_to_flax``), with |gamma| drawn coarse so that
ties and zeros exercise the stable sort; no JAX graph is compiled there.
"""

import importlib.util
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mobilenet_yolo_tpu import prune as j_prune
from mobilenet_yolo_tpu.tools_io import load_params_npz as jax_load_params_npz
from mobilenet_yolo_tpu.train import state as j_state
from mobilenet_yolo_tpu.train import step as j_step
from mobilenet_yolo_tpu_torch import prune
from mobilenet_yolo_tpu_torch.cli import train as cli_train
from mobilenet_yolo_tpu_torch.convert import flax_to_state_dict, state_dict_to_flax
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.models.mbv2_yolo import MBv2YOLO
from mobilenet_yolo_tpu_torch.tools import prune as tools_prune
from mobilenet_yolo_tpu_torch.tools_io import load_params_npz, save_params_npz
from mobilenet_yolo_tpu_torch.train import (GEOMETRY_BATCH_KEYS, create_train_state,
                                            make_geometry_train_step, make_train_step)
from mobilenet_yolo_tpu_torch.train.checkpoints import CheckpointManager

from _torch_parity import (REPO, SMALL_YOLO_CONFIG, float64_pair, geometry_batch,
                           jax_train_state, nhwc_input, padded_gt, perturb, state_dict_of,
                           to_nchw)
from test_cli_eval import _write_configs, _write_shard  # its 3-class 64x64 shard and yamls

CFG = {"yolo": {"num_classes": 3, "num_anchors": 3}}
BACKBONES = ("mbv2", "mbv3", "mbv3_macc")


def _coarse_gammas(model: torch.nn.Module, seed: int) -> dict:
    """The model's state dict with every prunable gamma redrawn on a 0.02
    grid in [-1, 1]: many ties, some zeros, both signs."""
    rng = np.random.default_rng(seed)
    state = {k: v.clone() for k, v in model.state_dict().items()}
    for key in state:
        if key.endswith(".bn.weight"):
            n = state[key].numel()
            state[key] = torch.from_numpy(np.round(rng.uniform(-1, 1, n) * 50) / 50).float()
    return state


@pytest.fixture(scope="module")
def states():
    return {bb: _coarse_gammas(build_model(CFG, bb, device="cpu",
                                           generator=torch.Generator().manual_seed(1)), seed=2)
            for bb in BACKBONES}


def test_prunable_sites_are_found_structurally(states):
    """Every block with an expand conv, in order; the head only where its
    consumer is a plain 1x1 conv (MBv2, MACC-lite), whatever the names."""
    for bb, state in states.items():
        want = j_prune.prunable_gammas(state_dict_to_flax(state)["params"])
        got = prune.prunable_gammas(state)
        assert list(got) == list(want), bb
        for site in want:
            np.testing.assert_array_equal(got[site], want[site])
    assert "head_conv" not in prune.prunable_gammas(states["mbv3"])
    assert "head_conv" in prune.prunable_gammas(states["mbv3_macc"])
    assert list(prune.prunable_gammas(states["mbv2"]))[:2] == ["block1", "block2"]
    assert list(prune.prunable_gammas(states["mbv3"]))[-2:] == ["bneck2_0", "bneck2_1"]


@pytest.mark.parametrize("ratio,min_keep,round_to,include_head", [
    (0.3, 8, 8, True), (0.5, 8, 8, False), (0.0, 8, 8, True), (0.7, 1, 1, True),
    (0.9, 16, 4, True), (0.45, 3, 5, False),
])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_plan_matches_jax(states, backbone, ratio, min_keep, round_to, include_head):
    """The plan equals JAX's index for index: the same sites in the same
    order, the same kept channels (ties broken by index)."""
    state = states[backbone]
    params = state_dict_to_flax(state)["params"]
    want = j_prune.plan_prune(params, ratio, min_keep=min_keep, round_to=round_to,
                              include_head=include_head)
    got = prune.plan_prune(state, ratio, min_keep=min_keep, round_to=round_to,
                           include_head=include_head)
    assert list(got) == list(want)
    for site in want:
        np.testing.assert_array_equal(got[site], want[site], err_msg=site)
    with pytest.raises(ValueError, match=r"\[0, 1\)"):
        prune.plan_prune(state, 1.0)


@pytest.mark.parametrize("round_to", [8, 1])
@pytest.mark.parametrize("backbone", BACKBONES)
def test_apply_prune_matches_jax(states, backbone, round_to):
    """The sliced state dict is ``flax_to_state_dict`` of JAX's sliced tree,
    the ``prune:`` block is JAX's, and the model rebuilt from it loads the
    slice ``strict=True`` (odd widths too, with ``round_to`` 1)."""
    state = states[backbone]
    flax = state_dict_to_flax(state)
    before = {k: v.clone() for k, v in state.items()}
    keep = prune.plan_prune(state, 0.4, round_to=round_to)
    j_params, j_stats, j_cfg = j_prune.apply_prune(flax["params"], flax["batch_stats"], keep)
    new_state, cfg = prune.apply_prune(state, keep)
    assert cfg == j_cfg
    want = flax_to_state_dict({"params": j_params, "batch_stats": j_stats})
    got = {k: v for k, v in new_state.items() if not k.endswith("num_batches_tracked")}
    assert set(got) == set(want)
    for key in want:
        assert torch.equal(got[key], want[key]), key
    model = build_model(dict(CFG, prune=cfg), backbone, device="cpu")
    model.load_state_dict(new_state, strict=True)
    assert prune.param_count(model) == j_prune.param_count(j_params)
    assert all(torch.equal(state[k], before[k]) for k in before)  # the input is untouched
    if round_to == 1:
        assert any(w % 2 for w in cfg["backbone_hidden"] if w)
    if backbone == "mbv3":
        with pytest.raises(ValueError, match="not prunable"):
            prune.apply_prune(state, {"head_conv": np.arange(4)})


@pytest.mark.parametrize("backbone", ["mbv2", "mbv3"])
def test_dead_channel_prune_is_exact(backbone):
    """Channels whose expand and depthwise BN scale and bias are 0 (and, on
    MBv2, head channels whose BN is 0) contribute nothing: the slim model's
    heads equal the parent's to float32 rounding (1e-5)."""
    model = build_model(CFG, backbone, device="cpu",
                        generator=torch.Generator().manual_seed(3)).eval()
    state = {k: v.clone() for k, v in model.state_dict().items()}
    gammas = prune.prunable_gammas(state)
    rng = np.random.default_rng(4)
    keep = {}
    sites = ["block4", "block9", "block15", "head_conv"] if backbone == "mbv2" else \
        ["bneck3", "bneck7", "bneck2_0"]
    for site in sites:
        n = gammas[site].size
        victims = rng.choice(n, size=n // 4, replace=False)
        keep[site] = np.setdiff1d(np.arange(n), victims)
        parts = ["backbone.head_conv.bn"] if site == "head_conv" else \
            [f"backbone.{site}.{p}.bn" for p in ("expand", "depthwise")]
        for p in parts:
            for leaf in ("weight", "bias"):
                state[f"{p}.{leaf}"][victims] = 0.0
    model.load_state_dict(state)
    x = to_nchw(nhwc_input(5))
    with torch.no_grad():
        ref = model(x)
    new_state, cfg = prune.apply_prune(state, keep)
    slim = build_model(dict(CFG, prune=cfg), backbone, device="cpu").eval()
    slim.load_state_dict(new_state, strict=True)
    with torch.no_grad():
        out = slim(x)
    for key in ref:
        np.testing.assert_allclose(out[key].numpy(), ref[key].numpy(), rtol=1e-5, atol=1e-5)
    assert prune.param_count(slim) < prune.param_count(model)


@pytest.mark.parametrize("backbone", BACKBONES)
def test_slim_penalty_matches_jax(backbone):
    """The L1 sum over the prunable gammas, float32 on both sides (rtol
    1e-6: the sums run in other orders), and it carries a gradient: sign
    of each prunable gamma, 0 elsewhere."""
    model = build_model(CFG, backbone, device="cpu", generator=torch.Generator().manual_seed(6))
    model.load_state_dict(_coarse_gammas(model, seed=7))
    params = state_dict_to_flax(model.state_dict())["params"]
    want = float(j_prune.slim_penalty(jax.tree_util.tree_map(jnp.asarray, params)))
    got = prune.slim_penalty(model)
    np.testing.assert_allclose(float(got.detach()), want, rtol=1e-6)
    got.backward()
    gamma = model.backbone.head_conv.bn.weight
    if backbone == "mbv3":
        assert gamma.grad is None
    else:
        assert torch.equal(gamma.grad, gamma.detach().sign())
    assert model.backbone.stem.bn.weight.grad is None


# ---------------------------------------------------- the steps in float64

SLIM_LAM = 1e-2


@pytest.fixture(scope="module")
def slim_variables64() -> dict:
    """The width-0.35 MBv2-YOLO's weights (the port's seeded init written as
    a flax tree, perturbed as ``_torch_parity.perturb`` does) in float64,
    with a third of the prunable gammas in [1e-6, 1e-3]: small enough that
    the prox step zeroes some of them within two steps and not others."""
    port = MBv2YOLO(num_classes=3, num_anchors=3, width_mult=0.35,
                    generator=torch.Generator().manual_seed(17))
    variables = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float64),
                                       perturb(state_dict_to_flax(port.state_dict()), seed=1))
    rng = np.random.default_rng(8)
    backbone = variables["params"]["backbone"]
    for site in j_prune.prunable_gammas(variables["params"]):
        bn = (backbone[site] if site == "head_conv" else backbone[site]["expand"])["bn"]
        small = rng.random(bn["scale"].size) < 1 / 3
        bn["scale"][small] = rng.uniform(1e-6, 1e-3, int(small.sum())) * rng.choice([-1, 1])
    return variables


def _gamma_keys(model) -> list[str]:
    return [prune._gamma_key(site) for site in prune.prunable_gammas(model.state_dict())]


@pytest.mark.parametrize("kind", ["plain", "geometry"])
@pytest.mark.parametrize("mode", ["loss", "prox"])
def test_slim_steps_match_jax(slim_variables64, mode, kind):
    """Two train steps with ``slim_l1`` in ``mode``, float64 on both sides
    (AdamW; the prox runs also keep an EMA, which must see the shrunk
    parameters). The first step's loss agrees to float32 rounding (rtol
    1e-6: the YOLO loss is float32 in both packages; in loss mode it carries
    the penalty), the second's to 1e-4, since it is taken on parameters that
    Adam's first update moved (see below: 2e-5 seen); after two, the ones JAX zeroed are exactly 0 in the port
    and no other is, and every prunable gamma and its EMA agree within 1e-4:
    the float32 loss seeds the gradients, so a gradient small against the
    network's largest carries a larger relative error, and Adam's update
    lr * m_hat / sqrt(v_hat), a ratio of such gradients, moves by a share
    of lr = 7e-4 (up to 2.3e-5 on one gamma of ~1400 seen in the geometry
    step; most agree to 1e-8).
    ``test_prox_update_reads_adam_state`` holds the threshold itself to
    1e-12. The geometry batch takes out the float32 stages whose
    order of summation differs between the packages
    (``tests/test_torch_train.py:test_geometry_step_matches_jax``)."""
    variables = jax.tree_util.tree_map(np.copy, slim_variables64)
    cfg = dict(SMALL_YOLO_CONFIG, slim_l1=SLIM_LAM, slim_mode=mode)
    ema = dict(ema_decay=0.9, ema_ramp=2.0) if mode == "prox" else {}
    rng = np.random.default_rng(9)
    if kind == "plain":
        x = rng.normal(0, 1, (4, 32, 32, 3))
        gt, n_gt = padded_gt(rng, [2, 0, 3, 6], 6)
        j_args, t_args, kw = (x, gt, n_gt), tuple(map(torch.from_numpy, (x, gt, n_gt))), {}
    else:
        batch = geometry_batch(rng, 4, 32)
        batch["jitter_op"][np.isin(batch["jitter_op"], (1, 3))] = -1
        batch["fill_from_mean"][:] = False
        keys = (*GEOMETRY_BATCH_KEYS, "gt", "n_gt")
        j_args = (*(jnp.asarray(batch[k]) for k in keys), jax.random.PRNGKey(3))
        t_args = (*(torch.from_numpy(np.asarray(batch[k])) for k in keys), 3)
        kw = {"out_hw": (32, 32)}
    with jax.enable_x64(True):
        jm, model = float64_pair(variables)
        tx = j_state.make_optimizer(7e-4, 4e-4)
        if kind == "plain":
            step = j_step.make_train_step(jm, cfg, tx, donate=False, **ema)
        else:
            step = j_step.make_geometry_train_step(jm, cfg, tx, fused_aug=False, **ema)
        state = jax_train_state(variables, tx)
        if ema:
            state = state.replace(ema_params=jax.tree_util.tree_map(jnp.asarray,
                                                                   variables["params"]))
        want_losses = []
        for _ in range(2):
            state, m = step(state, *j_args, **kw)
            want_losses.append(float(m["loss"]))
        want_params = state_dict_of("params", state.params)
        want_ema = state_dict_of("params", state.ema_params) if ema else None

    port_state = create_train_state(model, ema=bool(ema))
    if kind == "plain":
        port_step = make_train_step(model, cfg, **ema)
    else:
        port_step = make_geometry_train_step(model, cfg, fused_aug=False, dtype=torch.float64,
                                             **ema)
    for rtol, want_loss in zip((1e-6, 1e-4), want_losses):
        port_state, metrics = port_step(port_state, *t_args, **kw)
        np.testing.assert_allclose(float(metrics["loss"]), want_loss, rtol=rtol)
    params = dict(model.named_parameters())
    zeros = 0
    for key in _gamma_keys(model):
        got, want = params[key].detach().numpy(), want_params[key]
        np.testing.assert_array_equal(got == 0, want == 0, err_msg=key)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-4, err_msg=key)
        zeros += int((want == 0).sum())
        if want_ema is not None:
            np.testing.assert_allclose(port_state.ema[key].numpy(), want_ema[key], atol=1e-4,
                                       err_msg=key)
    if mode == "prox":
        assert 0 < zeros < sum(params[k].numel() for k in _gamma_keys(model))


def test_prox_update_reads_adam_state():
    """``slim_prox_update`` is the JAX soft threshold with AdamW's own second
    moment, step count, rate and beta2: on one parameter state it equals the
    JAX function on the same numbers (float64, 1e-12), and before the
    first optimizer step it raises."""
    model = build_model(CFG, "mbv3_macc", device="cpu", dtype=torch.float64,
                        generator=torch.Generator().manual_seed(10))
    model.load_state_dict(_coarse_gammas(model, seed=12))
    state = create_train_state(model, learning_rate=3e-3)
    with pytest.raises(RuntimeError, match="after optimizer.step"):
        prune.slim_prox_update(model, state.optimizer, 0.1)
    rng = np.random.default_rng(11)
    for p in model.parameters():
        p.grad = torch.from_numpy(rng.normal(0, 1e-2, p.shape))
    for _ in range(3):
        state.optimizer.step()
    # the whole state dict, so that each BN weight maps to a flax scale
    before = state_dict_to_flax({k: v.clone() for k, v in model.state_dict().items()})
    nu = state_dict_to_flax({**model.state_dict(),
                             **{n: state.optimizer.state[p]["exp_avg_sq"]
                                for n, p in model.named_parameters()}})
    prune.slim_prox_update(model, state.optimizer, 0.1)
    with jax.enable_x64(True):
        want = j_prune.slim_prox_update(before["params"], nu["params"], jnp.int32(3),
                                        jnp.float64(3e-3), 0.1)
        want = state_dict_of("params", want)
    got = dict(model.named_parameters())
    for key in _gamma_keys(model):
        np.testing.assert_allclose(got[key].detach().numpy(), want[key], rtol=0, atol=1e-12,
                                   err_msg=key)
    assert any(float((got[k] == 0).sum()) > 0 for k in _gamma_keys(model))


# ------------------------------------------------------------- the CLI


@pytest.fixture(scope="module")
def pruned_dirs(tmp_path_factory):
    """The JAX CLI and the port's, each at ratio 0.3 on the same weights:
    a 3-class MBv2 at 64x64 whose gammas are coarse, as an ``.npz``."""
    spec = importlib.util.spec_from_file_location("jax_tools_prune", REPO / "tools" / "prune.py")
    jax_tools_prune = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jax_tools_prune)

    tmp = tmp_path_factory.mktemp("prune")
    shard = tmp / "shard"
    _write_shard(shard, np.random.default_rng(12))
    data_yaml = _write_configs(tmp, shard)
    model = build_model(yaml.safe_load((tmp / "model.yaml").read_text()), device="cpu",
                        generator=torch.Generator().manual_seed(13))
    model.load_state_dict(_coarse_gammas(model, seed=14))
    flax = state_dict_to_flax(model.state_dict())
    save_params_npz(str(tmp / "params.npz"), flax["params"], flax["batch_stats"])
    args = ["-y", data_yaml, "-c", str(tmp / "params.npz"), "--ratio", "0.3"]
    jax_tools_prune.main([*args, "--out", str(tmp / "jax")])
    tools_prune.main([*args, "--out", str(tmp / "port"), "--device", "cpu"])
    return tmp, args


def test_prune_cli_writes_what_the_jax_cli_writes(pruned_dirs):
    """``params.npz`` arrays equal, ``model.yaml`` equal to the byte,
    ``data.yaml`` equal but for the path it points at, ``summary.json``
    equal within 1e-6 (float32 |gamma| sums in numpy on both sides)."""
    tmp, _ = pruned_dirs
    jax_dir, port_dir = tmp / "jax", tmp / "port"
    with np.load(jax_dir / "params.npz") as want, np.load(port_dir / "params.npz") as got:
        assert set(got.files) == set(want.files)
        for key in want.files:
            assert got[key].dtype == want[key].dtype
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert (port_dir / "model.yaml").read_text() == (jax_dir / "model.yaml").read_text()
    assert yaml.safe_load((port_dir / "model.yaml").read_text())["prune"]["backbone_head"] > 0
    want_data = yaml.safe_load((jax_dir / "data.yaml").read_text())
    got_data = yaml.safe_load((port_dir / "data.yaml").read_text())
    assert got_data.pop("model_config_path") == str(port_dir / "model.yaml")
    want_data.pop("model_config_path")
    assert got_data == want_data
    want = json.loads((jax_dir / "summary.json").read_text())
    got = json.loads((port_dir / "summary.json").read_text())
    assert got["sites"] == want["sites"] and got["ratio"] == want["ratio"]
    assert (got["params_before"], got["params_after"]) == (want["params_before"],
                                                           want["params_after"])
    for key, value in want["gamma_stats"].items():
        np.testing.assert_allclose(got["gamma_stats"][key], value, rtol=1e-6, err_msg=key)


def test_prune_cli_output_feeds_both_packages(pruned_dirs, tmp_path, monkeypatch, capsys):
    """The port's ``params.npz`` is the JAX flat format (JAX's
    ``load_params_npz`` reads it), the port's train CLI ``--init-from``
    loads it into the model its ``data.yaml`` describes and evaluates it,
    ``--dry-run`` writes nothing, and a pruned config is refused."""
    tmp, args = pruned_dirs
    port_dir = tmp / "port"
    params, stats = jax_load_params_npz(str(port_dir / "params.npz"))
    assert params["backbone"]["block3"]["expand"]["conv"]["kernel"].shape[-1] % 8 == 0
    assert load_params_npz(str(port_dir / "params.npz"))[0].keys() == params.keys()
    monkeypatch.chdir(tmp_path)
    mAP = cli_train.main(cli_train.get_params([
        "-y", str(port_dir / "data.yaml"), "--init-from", str(port_dir / "params.npz"),
        "-c", str(tmp_path / "ck"), "--device", "cpu", "-e"]))
    assert 0.0 <= mAP <= 1.0
    tools_prune.main([*args, "--out", str(tmp_path / "dry"), "--device", "cpu", "--dry-run"])
    out = capsys.readouterr().out
    assert "gamma concentration: bottom 30%" in out and "dry run: nothing written" in out
    assert not (tmp_path / "dry").exists()
    with pytest.raises(SystemExit, match="already carries a 'prune:' block"):
        tools_prune.main(["-y", str(port_dir / "data.yaml"), "-c", str(port_dir / "params.npz"),
                          "--out", str(tmp_path / "again"), "--device", "cpu"])


def test_prune_cli_reads_the_served_weights_of_a_checkpoint(tmp_path, monkeypatch):
    """A checkpoint directory of the port's trainer is pruned through its
    served weights: the average where the run kept one, as the eval and
    infer CLIs serve it. The plan follows the EMA's gammas, not the live
    ones; and without a card the default device raises."""
    cfg = dict(CFG, img_w=64)
    (tmp_path / "model.yaml").write_text(yaml.safe_dump(cfg))
    model = build_model(cfg, device="cpu", generator=torch.Generator().manual_seed(15))
    state = create_train_state(model, ema=True)
    coarse = _coarse_gammas(model, seed=16)
    for name in state.ema:
        if name in coarse:
            state.ema[name] = coarse[name].clone()
    CheckpointManager(str(tmp_path / "ck")).save(1, state)
    tools_prune.main(["--model-yaml", str(tmp_path / "model.yaml"), "-c", str(tmp_path / "ck"),
                      "--ratio", "0.5", "--out", str(tmp_path / "out"), "--device", "cpu"])
    summary = json.loads((tmp_path / "out" / "summary.json").read_text())
    want = prune.plan_prune(coarse, 0.5)  # the EMA's gammas, the live BN statistics
    assert [(r["site"], r["kept"]) for r in summary["sites"]] == \
        [(s, int(k.size)) for s, k in want.items()]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        tools_prune.main(["--model-yaml", str(tmp_path / "model.yaml"), "-c",
                          str(tmp_path / "ck"), "--out", str(tmp_path / "x")])
