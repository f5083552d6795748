"""Build the port's CUDA kernels with ``nvcc`` and load them with ``ctypes``.

Every ``*.cu`` file in ``mobilenet_yolo_tpu_torch/csrc/`` is compiled for
Hopper (``sm_90a``) into one shared library with a plain C interface, at
first use, under ``build/torch_kernels/`` at the repository root. The file
name carries a hash of the sources and flags, so an edited source builds
anew and an unchanged one loads the library already built. No source
includes PyTorch's headers, which keeps the build to seconds.
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
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


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
    sources = sorted(CSRC_DIR.glob("*.cu"))
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
    sources = [str(s) for s in sorted(CSRC_DIR.glob("*.cu"))]
    # compile to a private name, then rename: a concurrent build never
    # loads a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                          capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)
    return out


@functools.cache
def load() -> ctypes.CDLL:
    """Build if needed, load once per process, and declare the C entry
    points' signatures (a pointer or stream is ``c_void_p``; an undeclared
    one would be cut to 32 bits)."""
    lib = ctypes.CDLL(str(build()))
    lib.myt_nms_suppress.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                     ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_int, ctypes.c_void_p]
    lib.myt_nms_suppress.restype = ctypes.c_int
    return lib
