"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``*.cu`` file in ``mobilenet_yolo_tpu_torch/csrc/`` is compiled for
Hopper (``sm_90a``), one ``nvcc`` per source, all started together, and
the objects are linked into one shared library with a plain C interface,
at first use, under ``build/torch_kernels/`` at the repository root. The
file name carries a hash of the sources (``*.cu`` and the ``*.cuh`` they
include) and flags, so an edited source builds anew and an unchanged one
loads the library already built. No source includes PyTorch's headers,
which keeps the build to seconds.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

PACKAGE_DIR = Path(__file__).resolve().parent.parent
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR.parent / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    raise RuntimeError("nvcc not found on PATH or under CUDA_HOME; the port's "
                       "CUDA kernels are built from source at first use")


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    sources = sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")])
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libmyt_torch_kernels_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/*.cu`` unless the library for these sources exists.

    ``nvcc``'s output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``<name>.log``.
    """
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    # compile into a private directory, then rename the library: a
    # concurrent build never loads a half-written one
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        procs = []
        for src in sorted(CSRC_DIR.glob("*.cu")):
            obj = Path(tmp) / f"{src.stem}.o"
            procs.append((src.name, obj, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        logs, failed = [], []
        for name, _, proc in procs:
            text, _ = proc.communicate()
            logs.append(f"== {name}\n{text}")
            if proc.returncode != 0:
                failed.append(name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(logs))
        lib = Path(tmp) / out.name
        link = subprocess.run([nvcc, "-shared", "-o", str(lib),
                               *(str(obj) for _, obj, _ in procs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}{link.stderr}")
        out.with_suffix(".log").write_text("\n".join(logs))
        os.replace(lib, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures (a pointer or stream is ``c_void_p``; an undeclared
    one would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    # over, valid, keep, B, K, vec, stream
    lib.myt_nms_suppress.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.myt_nms_suppress.restype = ctypes.c_int
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    # slots, N, S, seed, gate, scale, pc, ops, facs, bits, stats, partial,
    # work, out, out_bf16, vec, stream
    lib.myt_slot_aug.argtypes = [ptr, i32, i32, i32, ptr, ptr, ptr, ptr, ptr, ptr,
                                 ptr, ptr, ptr, ptr, i32, i32, ptr]
    lib.myt_slot_aug.restype = ctypes.c_int
    # the card tests' hook in slot_aug.cu: out, stream
    lib.myt_aug_trig_table.argtypes = [ptr, ptr]
    lib.myt_aug_trig_table.restype = ctypes.c_int
    # slots, B, T, S, seed, gate, scale, pc, ops, facs, bits, src_rect,
    # dst_rect, fill_rect, fill_color, fill_from_mean, flip, active, stats,
    # partial, work, out_h, out_w, out, stream
    lib.myt_aug_compose.argtypes = [ptr, i32, i32, i32, i32, ptr, ptr, ptr, ptr, ptr,
                                    ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr, ptr,
                                    i32, i32, ptr, ptr]
    lib.myt_aug_compose.restype = ctypes.c_int
    # x, w1, b1, wdw, bdw, w2, b2, out, batch, h, w, cin, ch, cout, stride,
    # residual, th, tw, mw, nw, warps, vec, stream: float32 (3xTF32) and
    # bf16 block kernels on the tensor cores
    for name in ("myt_fused_block", "myt_fused_block_bf16"):
        getattr(lib, name).argtypes = [ptr] * 8 + [i32] * 14 + [ptr]
        getattr(lib, name).restype = ctypes.c_int
    # x, k_stem, b_stem, wdw, bdw, w2, b2, out, batch, h, w, ch, cout, th,
    # tw, mw, nw, warps, vec, bf16, stream
    lib.myt_fused_stem.argtypes = [ptr] * 8 + [i32] * 12 + [ptr]
    lib.myt_fused_stem.restype = ctypes.c_int
    # x, w, bias, out, batch, s, stage, stream
    lib.myt_stem_probe.argtypes = [ptr] * 4 + [i32] * 3 + [ptr]
    lib.myt_stem_probe.restype = ctypes.c_int
    return lib
