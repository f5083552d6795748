"""A fused-block kernel under its candidate launch plans, on the card.

For each distinct block shape of the folded VOC backbone that runs the
stride-1 or stride-2 block kernel (batch 128, 352x352 by default), times
the ``--dtype`` block kernel (bf16: ``csrc/fused_block_bf16.cu``, float32:
``csrc/fused_block.cu``) under the plan that ``kernels/fused_block.py``
picks (``plan_bf16``, ``plan_f32``) and under the next best plans of its
cost model with another tile, warp tiling or occupancy (``--top`` of each
occupancy), beside the cuDNN twin (TF32 off), and checks each against the
twin within ``BF16_REL_TOL`` or ``F32_REL_TOL``. Times are CUDA events around the calls (``ms``)
and the kernels' own device time from ``torch.profiler`` (``kernel_ms``).
Each plan's modelled cycles stand beside its time: the measurements that
the model's constants are held to.

    python -m mobilenet_yolo_tpu_torch.tools.probe_fused_tiles [--dtype bf16|f32] \\
        [--batch 128] [--size 352] [--top 3] [--iters 10] [--device cuda|cpu] [--json]

``--stem`` times the stem kernel (``csrc/fused_stem.cu``) the same way at
the stem's shape: ``plan_stem``'s plan and the next ``--top`` plans of its
model with other tiles.

On ``--device cpu`` the wrapper runs its twin (CPU tensors never reach a
kernel), so a CPU run checks the tool's plumbing, not the kernel.

``--fit SWEEP.json ...`` (no device) fits the dtype's cost-model constants
(``fused_block.COST_CONSTANTS``) to sweeps saved with ``--json``: least
squares of the measured cycles on the model's terms, each relative to its
measurement, the constants kept non-negative; it prints them with the
fit's mean relative error and how often the fitted model picks the
measured best plan of a shape.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from mobilenet_yolo_tpu_torch.config import VOC_CONFIG
from mobilenet_yolo_tpu_torch.kernels import fused_block as fb
from mobilenet_yolo_tpu_torch.models import build_model
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.utils.profiling import device_ms, kernel_ms_by_name


def block_shapes(backbone, batch: int, size: int) -> list[tuple]:
    """(blocks, kernel, x shape, hidden, cout, residual) of every fused
    launch of the folded ``backbone`` at ``size``, one entry per distinct
    shape; the first is the stem kernel's."""
    b0 = backbone.block0
    out = {("fused_stem_block0", (batch, size, size, 3), backbone.stem.conv.out_channels,
            b0.project.conv.out_channels, False): ["stem+0"]}
    h, c = size // 2, b0.project.conv.out_channels
    for idx in range(1, backbone.num_blocks):
        blk = getattr(backbone, f"block{idx}")
        stride = blk.depthwise.conv.stride[0]
        kernel = "fused_inverted_residual_s2" if stride == 2 else "fused_inverted_residual"
        key = (kernel, (batch, h, h, c), blk.expand.conv.out_channels,
               blk.project.conv.out_channels, blk.identity)
        out.setdefault(key, []).append(f"block{idx}")
        h, c = h // stride, blk.project.conv.out_channels
    return [("/".join(names), *key) for key, names in out.items()]


def block_args(gen: torch.Generator, x_shape: tuple, ch: int, cout: int, dtype,
               device) -> list[torch.Tensor]:
    """Seeded block inputs, weights scaled so activations keep unit size;
    float32 biases."""
    cin = x_shape[3]

    def randn(*shape, scale=1.0):
        return scale * torch.randn(shape, generator=gen, device=device)

    args = [randn(*x_shape), randn(cin, ch, scale=cin ** -0.5), randn(ch, scale=0.1),
            randn(3, 3, ch, scale=1 / 3), randn(ch, scale=0.1), randn(ch, cout, scale=ch ** -0.5),
            randn(cout, scale=0.1)]
    return [a.to(dtype) if a.dim() > 1 else a for a in args]


def candidates(dtype: str, stride: int, batch: int, ho: int, wo: int, cin: int, ch: int,
               cout: int, top: int) -> list[tuple[float, fb.Plan]]:
    """The model's best plan first, then, for one and for two blocks per SM,
    the next best of each other (tiles per image, warp tiling): up to
    ``top`` plans of each occupancy."""
    seen, out, per_occupancy = set(), [], {}
    for cost, plan in fb.block_plans(dtype, stride, batch, ho, wo, cin, ch, cout):
        per_sm = fb.blocks_per_sm(plan.mw, plan.nw, plan.warps, plan.smem)
        key = (per_sm, -(-ho // plan.th) * -(-wo // plan.tw), plan.mw, plan.nw, plan.warps)
        if key not in seen and per_occupancy.get(per_sm, 0) < top:
            seen.add(key)
            per_occupancy[per_sm] = per_occupancy.get(per_sm, 0) + 1
            out.append((cost, plan))
    return out


def kernel_ms(fn, iters: int) -> float | None:
    """Device time per call of ``fn``: the CUDA kernels that torch.profiler
    records over ``iters`` calls, without the host's gaps between them;
    None if the profiler recorded no kernel."""
    by_name = kernel_ms_by_name(fn, iters)
    return sum(by_name.values()) if by_name else None


DTYPES = {"bf16": (torch.bfloat16, fb.BF16_REL_TOL), "f32": (torch.float32, fb.F32_REL_TOL)}


def _timed_plan(what: str, plan: fb.Plan, cost: float, tiles: int, run_plan, want, tol: float,
                device, iters: int) -> dict:
    """One plan's record: its error against the twin's ``want`` (raises past
    ``tol``), event and profiler times, beside its modelled cycles."""
    got = run_plan()
    err = float((got.float() - want.float()).abs().max()) / float(want.float().abs().max())
    if not err <= tol:
        raise RuntimeError(f"{what} plan {plan}: rel err {err} > {tol}")
    return {"plan": plan._asdict(), "tiles": tiles, "model_cycles": cost, "rel_err": err,
            "ms": device_ms(run_plan, device=device, iters=iters),
            "kernel_ms": kernel_ms(run_plan, iters) if device.type == "cuda" else None}


def run(batch: int = 128, size: int = 352, top: int = 3, iters: int = 10,
        device="cuda", dtype: str = "bf16") -> dict:
    device = tool_device(device)
    torch_dtype, tol = DTYPES[dtype]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    backbone = build_model(VOC_CONFIG, device=device,
                           generator=torch.Generator().manual_seed(0)).backbone
    gen = torch.Generator(device=device).manual_seed(5)
    shapes = []
    for blocks, kernel, x_shape, ch, cout, residual in block_shapes(backbone, batch, size)[1:]:
        stride = 2 if kernel.endswith("_s2") else 1
        args = block_args(gen, x_shape, ch, cout, torch_dtype, device)
        twin = lambda: fb.inverted_residual_reference(*args, residual=residual, stride=stride)
        want = twin()
        ho, wo = x_shape[1] // stride, x_shape[2] // stride
        plans = []
        for cost, plan in candidates(dtype, stride, batch, ho, wo, x_shape[3], ch, cout, top):
            if device.type == "cuda":
                run_plan = lambda: fb._launch_block(*args, residual, stride, plan=plan)
            else:
                run_plan = twin
            plans.append(_timed_plan(f"{blocks} {dtype}", plan, cost,
                                     -(-ho // plan.th) * -(-wo // plan.tw), run_plan, want, tol,
                                     device, iters))
        shapes.append({"blocks": blocks, "stride": stride, "x": list(x_shape), "hidden": ch,
                       "cout": cout, "twin_ms": device_ms(twin, device=device, iters=iters),
                       "twin_kernel_ms": kernel_ms(twin, iters) if device.type == "cuda" else None,
                       "plans": plans})
        del args, want
    return {"device": device_name(device), "dtype": dtype, "batch": batch, "size": size,
            "shapes": shapes}


def run_stem(batch: int = 128, size: int = 352, top: int = 3, iters: int = 10,
             device="cuda", dtype: str = "bf16") -> dict:
    """The stem kernel under ``plan_stem``'s plan and the model's next
    ``top`` plans (each another tile), in ``run``'s format."""
    device = tool_device(device)
    torch_dtype, tol = DTYPES[dtype]
    if device.type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    backbone = build_model(VOC_CONFIG, device=device,
                           generator=torch.Generator().manual_seed(0)).backbone
    blocks, _, x_shape, ch, cout, _ = block_shapes(backbone, batch, size)[0]
    gen = torch.Generator(device=device).manual_seed(5)
    args = block_args(gen, x_shape, ch, cout, torch_dtype, device)
    args[1] = torch.randn((3, 3, 3, ch), generator=gen, device=device).to(torch_dtype) / 27 ** 0.5
    twin = lambda: fb.stem_block0_reference(*args)
    want = twin()
    ho, wo = x_shape[1] // 2, x_shape[2] // 2
    plans, tiles = [], set()
    for cost, plan in fb.stem_plans(dtype, batch, ho, wo, ch, cout):
        if (plan.th, plan.tw) in tiles or len(plans) > top:
            continue
        tiles.add((plan.th, plan.tw))
        run_plan = (lambda: fb._launch_stem(*args, plan=plan)) if device.type == "cuda" else twin
        plans.append(_timed_plan(f"stem {dtype}", plan, cost,
                                 -(-ho // plan.th) * -(-wo // plan.tw), run_plan, want, tol,
                                 device, iters))
    shape = {"blocks": blocks, "stride": 2, "x": list(x_shape), "hidden": ch, "cout": cout,
             "twin_ms": device_ms(twin, device=device, iters=iters),
             "twin_kernel_ms": kernel_ms(twin, iters) if device.type == "cuda" else None,
             "plans": plans}
    return {"device": device_name(device), "dtype": dtype, "batch": batch, "size": size,
            "shapes": [shape]}


SM_CLOCK_HZ = 1.98e9  # the H100 SXM boost clock: the cost model's cycle


def fit(sweeps: list[dict]) -> dict:
    """The constants of one dtype's cost model fitted to ``sweeps`` (each
    a ``run`` result; sweeps saved before ``--dtype`` existed are bf16):
    the kernel's profiler time where there is one, else its event time."""
    from scipy.optimize import nnls

    dtypes = {sweep.get("dtype", "bf16") for sweep in sweeps}
    if len(dtypes) != 1:
        raise ValueError(f"fit one dtype at a time, got {sorted(dtypes)}")
    route = fb._ROUTES[dtypes.pop()]
    readings = []  # (shape key, plan terms, L2 floor, measured cycles)
    for sweep in sweeps:
        for shape in sweep["shapes"]:
            stride, x = shape["stride"], shape["x"]
            dims = (stride, sweep["batch"], x[1] // stride, x[2] // stride, x[3], shape["hidden"],
                    shape["cout"])
            for p in shape["plans"]:
                q = p["plan"]
                terms, floor = fb._cost_terms(route, *dims, q["th"], q["tw"], q["mw"], q["nw"],
                                              q["warps"], q["smem"])
                cycles = (p["kernel_ms"] or p["ms"]) * 1e-3 * SM_CLOCK_HZ
                readings.append(((id(sweep), shape["blocks"]), terms, floor, cycles))
    coef, _ = nnls(np.array([[t / y for t in terms] for _, terms, _, y in readings]),
                   np.ones(len(readings)))
    model = [max(float(np.dot(coef, terms)), floor) for _, terms, floor, _ in readings]
    errors = [abs(m - y) / y for m, (_, _, _, y) in zip(model, readings)]
    by_shape = {}
    for m, (key, _, _, y) in zip(model, readings):
        by_shape.setdefault(key, []).append((m, y))
    picks = sum(min(v)[1] == min(y for _, y in v) for v in by_shape.values())
    return {"constants": dict(zip(fb.COST_CONSTANTS, (round(float(c), 3) for c in coef))),
            "readings": len(readings), "mean_rel_err": float(np.mean(errors)),
            "max_rel_err": float(np.max(errors)),
            "picks_measured_best": f"{picks} of {len(by_shape)}"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--dtype", choices=sorted(DTYPES), default="bf16")
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--size", type=int, default=352)
    ap.add_argument("--top", type=int, default=3)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", action="store_true", help="print one JSON object")
    ap.add_argument("--stem", action="store_true", help="the stem kernel's plans instead")
    ap.add_argument("--fit", nargs="+", metavar="SWEEP_JSON",
                    help="fit the cost model to saved sweeps instead (no device)")
    args = ap.parse_args(argv)
    if args.fit:
        sweeps = []
        for path in args.fit:
            with open(path) as f:
                sweeps.append(json.load(f))
        result = fit(sweeps)
        print(json.dumps(result))
        return result
    result = (run_stem if args.stem else run)(args.batch, args.size, args.top, args.iters,
                                              args.device, args.dtype)
    if args.json:
        print(json.dumps(result))
    else:
        kind = "stem" if args.stem else "block"
        print(f"{result['device']}: {result['dtype']} {kind} kernel plans, b{result['batch']} "
              f"{result['size']}x{result['size']}")
        for s in result["shapes"]:
            print(f"{s['blocks']} s{s['stride']} x{tuple(s['x'])} ch{s['hidden']} "
                  f"cout{s['cout']}: twin {s['twin_ms']:.4f} ms (kernels {s['twin_kernel_ms']})")
            for p in s["plans"]:
                q = p["plan"]
                print(f"    {q['th']}x{q['tw']} ({q['mw']},{q['nw']},{q['warps']}) "
                      f"tiles {p['tiles']} smem {q['smem']} model {p['model_cycles']:.0f} "
                      f"ms {p['ms']:.4f} (kernel {p['kernel_ms']}) rel_err {p['rel_err']:.3g}")
    return result


if __name__ == "__main__":
    main()
