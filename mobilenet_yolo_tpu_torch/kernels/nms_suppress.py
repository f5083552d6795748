"""The NMS suppression scan: a CUDA kernel and its plain-torch twin.

``suppress`` replaces ``mobilenet_yolo_tpu/kernels/pallas_nms.py:46``
(``pallas_suppress``) with the kernel in ``csrc/nms_suppress.cu``. It keeps
the Pallas kernel's contract and drops its TPU layout (the ``(B, 8, K)``
padding and one-hot scalar extraction of ``pallas_nms.py:27-42``).

``suppress_reference`` is the batched plain-torch twin of
``mobilenet_yolo_tpu/ops/nms.py:38-51`` (``_suppress_scan``). It serves CPU
tensors and is the oracle the kernel is held against on the card; it is
never a fallback for a CUDA tensor.

``suppress`` reaches both through the registered op ``myt::nms_suppress``
(``torch.library``; CUDA: the kernel; CPU: the twin; fake: the output's
shape), so ``torch.export`` records the scan as one op of the graph: a
traced tensor has no ``data_ptr`` for the launch, and tracing the twin
would unroll its loop over K. A program loaded from a ``.pt2`` launches
through the same op and counts in ``suppress.launches``. The op is defined
with ``Library.define`` and ``Library.impl``, not ``custom_op``, whose
kernels run under ``torch._disable_dynamo``: that imports
``torch._dynamo`` (seconds of start-up) in every process at its first
launch and adds host time to each one. It registers no autograd kernel:
the scan is inference only.
"""

from __future__ import annotations

import torch

from mobilenet_yolo_tpu_torch.kernels import _build

MAX_K = 1024  # an image's K x K bitmasks (128 KB) in one block's shared memory


def suppress_reference(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy scan in plain torch: (B, K, K), (B, K) -> bool keep (B, K)."""
    b, k = valid.shape
    valid = valid > 0.5
    hit = over > 0
    suppressed = torch.zeros((b, k), dtype=torch.bool, device=over.device)
    keep = torch.zeros((b, k), dtype=torch.bool, device=over.device)
    for i in range(k):
        alive = valid[:, i] & ~suppressed[:, i]
        keep[:, i] = alive
        suppressed |= alive[:, None] & hit[:, i]
    return keep


def _check(over: torch.Tensor, valid: torch.Tensor) -> None:
    if over.dtype != torch.float32 or valid.dtype != torch.float32:
        raise TypeError(f"suppress takes float32 over/valid, got {over.dtype}/{valid.dtype}")
    if over.dim() != 3 or over.shape[1] != over.shape[2] or valid.shape != over.shape[:2]:
        raise ValueError(f"suppress takes over (B, K, K) and valid (B, K), got "
                         f"{tuple(over.shape)} and {tuple(valid.shape)}")
    b, k = valid.shape
    if not 1 <= k <= MAX_K or b < 1:
        raise ValueError(f"suppress takes 1 <= K <= {MAX_K} and B >= 1, got B={b}, K={k}")
    if over.device != valid.device:
        raise ValueError(f"over on {over.device} but valid on {valid.device}")
    if not (over.is_contiguous() and valid.is_contiguous()):
        raise ValueError("suppress takes contiguous over and valid")


def suppress(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Greedy hard-NMS suppression scan.

    over:  (B, K, K) float32 {0, 1}; ``over[b, i, j] = 1`` if candidate i
           suppresses candidate j when i survives, already masked to j > i.
    valid: (B, K) float32 {0, 1} candidate validity.
    Returns keep: (B, K) bool.

    A CUDA tensor launches the kernel on the current stream, without
    synchronising, and adds one to ``suppress.launches``; a CPU tensor runs
    ``suppress_reference``. Any other input raises.
    """
    _check(over, valid)
    if over.device.type not in ("cpu", "cuda"):
        raise ValueError(f"suppress runs on CPU or CUDA tensors, not {over.device}")
    return torch.ops.myt.nms_suppress(over, valid)


def _nms_suppress_cuda(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    lib = _build.load()
    b, k = valid.shape
    keep = torch.empty((b, k), dtype=torch.bool, device=over.device)
    with torch.cuda.device(over.device):
        stream = torch.cuda.current_stream(over.device).cuda_stream
        # 16-byte loads where every row starts on a 16-byte boundary
        vec = k % 4 == 0 and over.data_ptr() % 16 == 0
        err = lib.myt_nms_suppress(over.data_ptr(), valid.data_ptr(),
                                   keep.data_ptr(), b, k, int(vec), stream)
    if err != 0:
        raise RuntimeError(f"nms_suppress kernel launch failed: CUDA error {err}")
    suppress.launches += 1
    return keep


_LIB = torch.library.Library("myt", "FRAGMENT")
_LIB.define("nms_suppress(Tensor over, Tensor valid) -> Tensor")
_LIB.impl("nms_suppress", _nms_suppress_cuda, "CUDA")
_LIB.impl("nms_suppress", suppress_reference, "CPU")


@torch.library.register_fake("myt::nms_suppress", lib=_LIB)
def _nms_suppress_fake(over: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    return valid.new_empty(valid.shape, dtype=torch.bool)


suppress.launches = 0
