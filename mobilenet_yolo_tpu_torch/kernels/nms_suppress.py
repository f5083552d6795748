"""The NMS suppression scan: a CUDA kernel and its plain-torch twin.

``suppress`` replaces ``mobilenet_yolo_tpu/kernels/pallas_nms.py:46``
(``pallas_suppress``) with the kernel in ``csrc/nms_suppress.cu``. It keeps
the Pallas kernel's contract and drops its TPU layout (the ``(B, 8, K)``
padding and one-hot scalar extraction of ``pallas_nms.py:27-42``).

``suppress_reference`` is the batched plain-torch twin of
``mobilenet_yolo_tpu/ops/nms.py:38-51`` (``_suppress_scan``). It serves CPU
tensors and is the oracle the kernel is held against on the card; it is
never a fallback for a CUDA tensor.
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
    if over.device.type == "cpu":
        return suppress_reference(over, valid)
    if over.device.type != "cuda":
        raise ValueError(f"suppress runs on CPU or CUDA tensors, not {over.device}")
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


suppress.launches = 0
