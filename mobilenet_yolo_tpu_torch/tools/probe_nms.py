"""The NMS suppression scan's time on the card, as one JSON line.

It times the kernel (``kernels/nms_suppress.py:suppress``) on a seeded,
strictly upper-triangular ``over`` as ``batched_nms`` builds it: CUDA
events per call of the wrapper (which the host's Python sets at small
sizes), the kernel's own device time per call from ``torch.profiler``
on one ``over`` (``kernel_ms``: its strict triangle, 16.7 MB at B=128,
K=256, fits in the H100's 50 MB L2) and rotating through a pool of
``over`` matrices larger than the L2 (``cold_kernel_ms``: every call
reads from HBM), the twin's time, and the bounds: the strict upper
triangle's bytes (all the scan needs) and the whole matrix's.

    python -m mobilenet_yolo_tpu_torch.tools.probe_nms [--batch 128] [--k 256] \\
        [--density 0.05] [--iters 100]
"""

from __future__ import annotations

import argparse
import itertools
import json

import torch

from mobilenet_yolo_tpu_torch.kernels.nms_suppress import suppress, suppress_reference
from mobilenet_yolo_tpu_torch.tools import device_name, tool_device
from mobilenet_yolo_tpu_torch.utils.profiling import bound_ms, device_ms, kernel_ms_by_name

SEED = 0
POOL_BYTES = 256 << 20  # the cold pool: five times the H100's L2


def random_over(batch: int, k: int, density: float, device, full: bool = False,
                seed: int = SEED) -> tuple[torch.Tensor, torch.Tensor]:
    """Seeded ``over`` (B, K, K) in {0, 1}, strictly upper-triangular unless
    ``full`` (then the diagonal and lower triangle are set too, which the
    scan must ignore), and ``valid`` (B, K) with 80% of candidates valid."""
    gen = torch.Generator(device=device).manual_seed(seed)
    over = (torch.rand((batch, k, k), generator=gen, device=device) < density).float()
    if not full:
        over = over.triu(1)
    return (over.contiguous(),
            (torch.rand((batch, k), generator=gen, device=device) < 0.8).float())


def bench(batch: int = 128, k: int = 256, density: float = 0.05, iters: int = 100) -> dict:
    device = tool_device("cuda")
    over, valid = random_over(batch, k, density, device)
    call = lambda: suppress(over, valid)  # noqa: E731
    kernels = kernel_ms_by_name(call, iters)
    n_pool = max(2, -(-POOL_BYTES // over.nbytes))
    pool = random_over(n_pool * batch, k, density, device, seed=SEED + 1)[0]
    pool = itertools.cycle(pool.view(n_pool, batch, k, k).unbind(0))
    cold = kernel_ms_by_name(lambda: suppress(next(pool), valid), iters)
    # over's strict upper triangle and valid in, keep out; the whole
    # matrix's bytes beside it
    need = 4 * batch * k * (k - 1) // 2 + 4 * valid.numel() + batch * k
    bound, bound_by = bound_ms(0, need)
    return {"device": device_name(device), "batch": batch, "k": k,
            "events_ms": device_ms(call, device=device, iters=iters, warmup=5),
            "kernel_ms": kernels.get("nms_suppress_kernel"), "kernels_ms": kernels,
            "cold_kernel_ms": cold.get("nms_suppress_kernel"), "pool": n_pool,
            "plain_ms": device_ms(lambda: suppress_reference(over, valid), device=device,
                                  iters=3),
            "bound_ms": bound, "bound_by": bound_by,
            "whole_matrix_bound_ms": bound_ms(0, need + 4 * batch * k * (k + 1) // 2)[0]}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--k", type=int, default=256)
    ap.add_argument("--density", type=float, default=0.05)
    ap.add_argument("--iters", type=int, default=100)
    result = bench(**vars(ap.parse_args(argv)))
    print(json.dumps(result), flush=True)
    return result


if __name__ == "__main__":
    main()
