"""Build and load the port's CUDA kernels.

Each kernel source is one ``csrc/*.cu`` file with a plain C interface
(the bf16 tensor-core sources share ``csrc/mma_sm90.cuh``).  It is compiled
for ``sm_90a`` with ``nvcc`` at first use (never at import) into
``build/repro_torch/``, keyed by a hash of the source, the headers and the
flags, and loaded with ``ctypes``.  There is no fast math: the kernels keep
IEEE rounding.  Every C entry point returns ``cudaGetLastError()`` after its
launch, and :func:`check` turns a non-zero code into an exception.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Dict

import torch

from repro_torch.core.spans import span

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_libs: Dict[Path, ctypes.CDLL] = {}
# libraries this process compiled, and found built already
counts = {"compiled": 0, "cached": 0}
_count_lock = threading.Lock()


def build(source: Path) -> Path:
    """Compile ``source`` unless this source and these flags were built
    already; return the shared library's path.  The ``nvcc`` run is the
    span ``kernels.build`` (``core.spans``)."""
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    key = hashlib.sha256(source.read_bytes() + headers
                         + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    lib = BUILD_DIR / f"{source.stem}-{key}.so"
    if lib.exists():
        _count("cached")
        return lib
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    with span("kernels.build"):
        subprocess.run([nvcc, *NVCC_FLAGS, "-o", str(tmp), str(source)],
                       check=True)
    os.replace(tmp, lib)
    _count("compiled")
    return lib


def _count(key: str) -> None:
    with _count_lock:           # chip_smoke.py builds in parallel threads
        counts[key] += 1


def load(source: Path, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded library of ``source``, built if needed; ``bind`` sets the
    ``argtypes`` and ``restype`` of its entry points once."""
    lib = _libs.get(source)
    if lib is None:
        lib = ctypes.CDLL(str(build(source)))
        lib.cuda_error_string.argtypes = [ctypes.c_int]
        lib.cuda_error_string.restype = ctypes.c_char_p
        bind(lib)
        _libs[source] = lib
    return lib


def require_card(device: torch.device) -> None:
    """Raise unless ``device`` is a CUDA device this build can run on."""
    if device.type != "cuda":
        raise ValueError(f"the CUDA kernel needs CUDA tensors, got {device}")
    if not torch.cuda.is_available():
        raise RuntimeError("a CUDA tensor was given but no CUDA device is "
                           "available")
    if torch.cuda.get_device_capability(device) != (9, 0):
        raise RuntimeError(f"the kernel is built for sm_90a; "
                           f"{torch.cuda.get_device_name(device)} is not")


def check(lib: ctypes.CDLL, err: int, name: str) -> None:
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err} "
                           f"({lib.cuda_error_string(err).decode()})")


__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "counts", "build", "load",
           "require_card", "check"]
