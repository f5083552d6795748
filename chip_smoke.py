"""Drive the PyTorch port's serving path once on one NVIDIA GPU and check it.

    python3 chip_smoke.py            # from the repository root; needs one card

Phases, one output line each (any failure raises and exits non-zero):

1. device   — refuses to run without CUDA; prints the card's name and power
              limit as ``nvidia-smi`` reports them.
2. build    — compiles ``mobilenet_yolo_tpu_torch/csrc/*.cu`` with nvcc.
3. kernel   — the NMS suppression kernel against its plain twin on the card,
              bit-equal: random (B=128, K=256), K=60 (64x64 input), chain.
4. serve    — the full-width VOC MBv2-YOLO (random weights from a seeded
              ``torch.Generator``) served through ``make_predict_fn``: batch 1
              and batch 128 at 352x352 in float32, uint8 with on-device
              normalize, and bf16. Checks that every request launched the
              kernel, that the kernel's keep equals the twin's on the
              ``over`` matrix of each request, card-vs-CPU float32 logits and
              bf16-vs-float32 logits (init weights), and the whole slice
              card-vs-CPU in float64 (served weights).
5. timing   — CUDA-event throughput at batch 128 (f32, bf16, u8), batch-1
              latency, and the kernel's time beside its twin's.

The line before the last is the per-kernel JSON record; the last line is
``{"ok": true, "device": {...}}``. Imports nothing of JAX, yaml or PIL.
"""

from __future__ import annotations

import copy
import json
import statistics
import subprocess
import time

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.eval import make_predict_fn
from mobilenet_yolo_tpu_torch.kernels import _build
from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.ops.nms import _suppression_matrix

# the VOC model contract of mobilenet_yolo_tpu/configs/voc/config.yaml
VOC_CONFIG = {
    "img_h": 352,
    "img_w": 352,
    "normalize": {"mean": [0.485, 0.456, 0.406], "std": [0.229, 0.224, 0.225]},
    "yolo": {
        "num_classes": 20,
        "num_anchors": 3,
        "anchors": [[143, 265], [153, 121], [280, 279], [20, 37], [49, 94], [73, 201]],
        "mask": [[0, 1, 2], [3, 4, 5]],
    },
}
SEED = 0
BATCH = 128
SIZE = 352
VAL_CONF = 0.3
IOU = 0.45
# float32 logits, card (TF32 off) vs CPU, relative to the largest logit:
# only summation order differs
F32_REL_TOL = 1e-4
# bf16 logits vs float32, relative to the largest logit: an 8-bit mantissa
# (2^-8 = 3.9e-3) rounds every layer
BF16_REL_TOL = 5e-2
# kept detections (boxes and scores in [0, 1]) of the float64 slice,
# card vs CPU, after the heads' cast to float32 for decode
DETS_TOL = 1e-6
SUPPRESS_SOURCE = "mobilenet_yolo_tpu_torch/csrc/nms_suppress.cu"
SUPPRESS_REPLACES = "mobilenet_yolo_tpu/kernels/pallas_nms.py:59"


def report(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()), flush=True)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"check failed: {what}")


def rel_err(got: torch.Tensor, want: torch.Tensor) -> float:
    """max |got - want| over max |want|."""
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def cuda_ms(fn, iters: int, warmup: int = 2) -> float:
    """Mean device time per call, CUDA events around ``iters`` calls."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def phase_device() -> tuple[torch.device, str]:
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: chip_smoke.py drives the port on an NVIDIA GPU")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True, timeout=60).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    report("device", kind=torch.cuda.get_device_name(0), count=torch.cuda.device_count(),
           torch=torch.__version__, cuda=torch.version.cuda)
    return torch.device("cuda", 0), smi


def phase_build() -> None:
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load()
    seconds = time.perf_counter() - t0
    ptxas = [line.strip() for line in lib.with_suffix(".log").read_text().splitlines()
             if "registers" in line or "spill" in line]
    report("build", seconds=f"{seconds:.2f}", library=lib.name, ptxas=" | ".join(ptxas))


def random_over(gen: torch.Generator, b: int, k: int, density: float, device):
    over = (torch.rand((b, k, k), generator=gen, device=device) < density).float()
    over = over.triu(1).contiguous()  # strictly-later, as batched_nms builds it
    valid = (torch.rand((b, k), generator=gen, device=device) < 0.8).float()
    return over, valid


def phase_kernel(device) -> int:
    gen = torch.Generator(device=device).manual_seed(SEED)
    chain = torch.zeros((1, 128, 128), device=device)
    chain[0, 0, 1] = chain[0, 1, 2] = 1.0
    chain_valid = torch.zeros((1, 128), device=device)
    chain_valid[0, :3] = 1.0
    cases = {"b128_k256": random_over(gen, BATCH, 256, 0.05, device),
             "b128_k60": random_over(gen, BATCH, 60, 0.2, device),
             "chain": (chain, chain_valid)}
    worst = 0
    for name, (over, valid) in cases.items():
        keep = suppress(over, valid)
        want = suppress_reference(over, valid)
        torch.cuda.synchronize()
        err = int((keep.int() - want.int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"kernel keep == reference keep ({name})")
        if name == "chain":
            keep = keep.cpu()
            check(keep[0, :3].tolist() == [True, False, True] and not keep[0, 3:].any(),
                  "chain case: a kept, b cut, c kept")
        report("kernel", case=name, kept=int(keep.sum()), max_abs_err=err)
    return worst


def head_logits(model, images_nhwc: torch.Tensor, dtype=None) -> dict[str, torch.Tensor]:
    with torch.inference_mode(), torch.autocast(images_nhwc.device.type, dtype=dtype,
                                                enabled=dtype is not None):
        return {k: v.float() for k, v in model(images_nhwc.permute(0, 3, 1, 2)).items()}


def calibrate_bn(model: torch.nn.Module, images_nhwc: torch.Tensor) -> None:
    """Set every BatchNorm's running statistics to the batch statistics of
    ``images`` (one train-mode pass, cumulative average).

    Straight from the init, the (0, 1) statistics let eval-mode activations
    shrink ~C-fold at every depthwise conv (fan-out init over 9 inputs):
    the heads give logits of ~1e-10, every score ties at 0.25 and NMS sees
    one class. Calibrated, activations keep unit scale and scores spread.
    """
    bns = [m for m in model.modules() if isinstance(m, torch.nn.BatchNorm2d)]
    for bn in bns:
        bn.reset_running_stats()
        bn.momentum = None
    model.train()
    with torch.no_grad():
        model(images_nhwc.permute(0, 3, 1, 2))
    for bn in bns:
        bn.momentum = 0.1
    model.eval()


def check_logits(init_model: torch.nn.Module, images: torch.Tensor, device) -> None:
    """Card vs CPU float32 logits and card bf16 vs float32 logits, on the
    weights exactly as the seeded init built them. There the network
    contracts, so each comparison sees the rounding of a few layers; with
    calibrated statistics a random network amplifies rounding ~450-fold
    (float32 against float64 on the CPU: 2.7e-5), which would leave bf16
    nothing to be held to."""
    cpu_logits = head_logits(init_model.eval(), images)
    card_model = copy.deepcopy(init_model).to(device).to(memory_format=torch.channels_last)
    f32_logits = head_logits(card_model, images.to(device))
    bf16_logits = head_logits(card_model, images.to(device), torch.bfloat16)
    for key in ("out0", "out1"):
        err32 = rel_err(f32_logits[key], cpu_logits[key])
        err16 = rel_err(bf16_logits[key], f32_logits[key])
        check(err32 <= F32_REL_TOL, f"{key} card vs CPU f32 rel err {err32:.3g} <= {F32_REL_TOL}")
        check(err16 <= BF16_REL_TOL, f"{key} bf16 vs f32 rel err {err16:.3g} <= {BF16_REL_TOL}")
        report("logits", head=key, shape=tuple(f32_logits[key].shape),
               max_abs=f"{float(cpu_logits[key].abs().max()):.4g}",
               card_vs_cpu_f32_rel=f"{err32:.3g}", bf16_vs_f32_rel=f"{err16:.3g}",
               tf32=False)


def phase_serve(device) -> tuple[int, dict]:
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(SEED)
    model = build_model(VOC_CONFIG, generator=torch.Generator().manual_seed(SEED))
    check_logits(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (2, SIZE, SIZE, 3)).astype(np.float32)), device)
    calibrate_bn(model, torch.from_numpy(
        rng.normal(0.0, 1.0, (4, SIZE, SIZE, 3)).astype(np.float32)))
    cpu_model = copy.deepcopy(model)
    model.to(device)
    predict = {"f32": make_predict_fn(model, VOC_CONFIG),
               "u8": make_predict_fn(model, VOC_CONFIG, normalize=True),
               "bf16": make_predict_fn(model, VOC_CONFIG, dtype=torch.bfloat16)}

    gen = torch.Generator(device=device).manual_seed(SEED)
    x128 = torch.randn((BATCH, SIZE, SIZE, 3), generator=gen, device=device)
    x1 = x128[:1].clone()
    u8 = torch.randint(0, 256, (BATCH, SIZE, SIZE, 3), generator=gen, device=device,
                       dtype=torch.uint8)
    val_conf = torch.tensor(VAL_CONF, device=device)
    requests = [("f32_b1", "f32", x1), ("f32_b128", "f32", x128),
                ("u8_b128", "u8", u8), ("bf16_b128", "bf16", x128)]

    # the main path: every request through make_predict_fn, launch count read around it
    suppress.launches = 0
    results = {name: predict[mode](images, val_conf) for name, mode, images in requests}
    torch.cuda.synchronize()
    launches = suppress.launches
    check(launches == len(requests), f"suppress kernel launched once per request ({launches})")
    report("serve", requests=len(requests), suppress_launches=launches)

    n_cand = ((SIZE // 32) ** 2 + (SIZE // 16) ** 2) * 3
    for name, mode, images in requests:
        dets, keep = results[name]
        b = images.shape[0]
        check(dets.shape == (b, min(256, n_cand), 7) and keep.shape == (b, min(256, n_cand)),
              f"{name} output shapes")
        check(bool(torch.isfinite(dets).all()), f"{name} detections finite")
        # rebuild the request's `over` from the candidates it returned
        over = _suppression_matrix(dets[..., :4], dets[..., 6].to(torch.int32), IOU)
        valid = (dets[..., 4] > val_conf).float()
        kernel_keep = suppress(over, valid)
        ref_keep = suppress_reference(over, valid)
        check(torch.equal(kernel_keep, ref_keep), f"{name}: kernel keep == reference keep")
        check(torch.equal(keep, ref_keep), f"{name}: served keep == reference keep")
        check(0 < int(keep.sum()) < int(valid.sum()), f"{name}: NMS kept some and cut some")
        report("serve", request=name, kept=int(keep.sum()), valid=int(valid.sum()),
               over_pairs=int(over.sum()), kernel_equals_reference=True)

    # the whole slice, card vs CPU, on the served weights in float64: the
    # calibrated network's amplified float32 rounding could reorder
    # near-equal scores, float64's cannot
    small = x128[:2].double()
    ref_card = copy.deepcopy(cpu_model).double().to(device)
    want_dets, want_keep = make_predict_fn(cpu_model.double(), VOC_CONFIG)(
        small.cpu(), val_conf.cpu())
    dets, keep = (t.cpu() for t in make_predict_fn(ref_card, VOC_CONFIG)(small, val_conf))
    check(torch.equal(keep, want_keep), "float64 slice keep, card == CPU")
    dets_err = float((dets[keep] - want_dets[keep]).abs().max())
    check(dets_err <= DETS_TOL, f"float64 slice kept detections, card vs CPU {dets_err:.3g}")
    report("reference", shape=tuple(small.shape), dtype="float64", kept=int(keep.sum()),
           keep_equal=True, dets_max_abs_err=f"{dets_err:.3g}")
    return launches, {"model": model, "predict": predict, "x128": x128, "x1": x1,
                      "u8": u8, "val_conf": val_conf}


def phase_timing(device, smi: str, state: dict) -> dict:
    predict, val_conf = state["predict"], state["val_conf"]
    model, x128 = state["model"], state["x128"]
    for mode, images in (("f32", x128), ("bf16", x128), ("u8", state["u8"])):
        ms = cuda_ms(lambda: predict[mode](images, val_conf), iters=20)
        report("timing", what=f"predict_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               img_per_s=f"{BATCH * 1000.0 / ms:.1f}", card=f"'{smi}'")
    torch.backends.cudnn.allow_tf32 = True  # cuDNN's default for float32 convs
    ms = cuda_ms(lambda: predict["f32"](x128, val_conf), iters=20)
    torch.backends.cudnn.allow_tf32 = False
    report("timing", what=f"predict_b{BATCH}_f32_tf32", ms_per_batch=f"{ms:.3f}",
           img_per_s=f"{BATCH * 1000.0 / ms:.1f}", card=f"'{smi}'")
    for mode, dtype in (("f32", None), ("bf16", torch.bfloat16)):
        ms = cuda_ms(lambda: head_logits(model, x128, dtype), iters=20)
        report("timing", what=f"forward_only_b{BATCH}_{mode}", ms_per_batch=f"{ms:.3f}",
               card=f"'{smi}'")

    lat = []
    for i in range(60):
        t0 = time.perf_counter()
        predict["f32"](state["x1"], val_conf)
        torch.cuda.synchronize()
        if i >= 10:
            lat.append((time.perf_counter() - t0) * 1000.0)
    lat.sort()
    report("timing", what="predict_b1_f32_latency", median_ms=f"{statistics.median(lat):.3f}",
           p90_ms=f"{lat[int(0.9 * len(lat))]:.3f}", samples=len(lat), card=f"'{smi}'")

    gen = torch.Generator(device=device).manual_seed(SEED + 2)
    over, valid = random_over(gen, BATCH, 256, 0.05, device)
    kernel_ms = cuda_ms(lambda: suppress(over, valid), iters=100, warmup=5)
    plain_ms = cuda_ms(lambda: suppress_reference(over, valid), iters=5)
    report("timing", what="suppress_b128_k256", kernel_ms=f"{kernel_ms:.4f}",
           plain_ms=f"{plain_ms:.4f}", card=f"'{smi}'")
    return {"ms": kernel_ms, "plain_ms": plain_ms}


def main() -> None:
    device, smi = phase_device()
    phase_build()
    max_err = phase_kernel(device)
    launches, state = phase_serve(device)
    times = phase_timing(device, smi, state)
    print(json.dumps({"kernels": [{
        "name": "nms_suppress", "route": "cuda", "source": SUPPRESS_SOURCE,
        "replaces": SUPPRESS_REPLACES, "launches": launches, "max_abs_err": max_err,
        "ms": times["ms"], "plain_ms": times["plain_ms"]}]}))
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
