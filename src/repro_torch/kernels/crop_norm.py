"""Fused crop + mirror + normalize (+HWC->CHW) on Hopper — the on-device half
of DALI's ``crop_mirror_normalize`` stage (paper Listings 2/3).

Replaces the Pallas TPU kernel ``repro/kernels/crop_norm.py``
(``crop_mirror_normalize`` -> ``_crop_kernel``).  The kernel is CUDA C++ in
``csrc/crop_norm.cu``, built for ``sm_90a`` with ``nvcc`` at first use into
``build/repro_torch/`` (keyed by a hash of the source and flags) and loaded
with ``ctypes`` through its plain C entry point.

Bound: bytes.  At least ``B*oh*ow*C`` bytes are read and ``B*C*oh*ow*4``
(f32) or ``*2`` (bf16) written, against 2 flops per output element; at the
main path's B=512, 256x256x3 -> 224x224 that is 77.1 MB + 308.3 MB.  The
design reads each byte of the crop window once and writes every output
plane with coalesced stores (one thread per output pixel; see the ``.cu``
note), so the writes, 80% of the bytes, are coalesced.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

SOURCE = _build.CSRC / "crop_norm.cu"
SOURCES = (SOURCE,)
MAX_BATCH = 65535               # the kernel puts the batch on grid.y

# Launches of the CUDA kernel in this process; plain-version calls do not
# count.  A run sets it to 0 and reads it to show which path it took.
launches = 0


def check_args(img, oy, ox, mirror, mean, std, out_h: int, out_w: int,
               dtype) -> None:
    """Raise on anything the kernel (and so its plain version) does not
    take: the one place the inputs are checked, once per call."""
    tensors = dict(img=img, oy=oy, ox=ox, mirror=mirror, mean=mean, std=std)
    for name, t in tensors.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != img.device:
            raise ValueError(f"{name} is on {t.device}, img on {img.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if img.dtype != torch.uint8 or img.dim() != 4:
        raise ValueError(f"img must be (B,H,W,C) uint8, got "
                         f"{tuple(img.shape)} {img.dtype}")
    B, H, W, C = img.shape
    for name in ("oy", "ox", "mirror"):
        t = tensors[name]
        if t.dtype != torch.int32 or tuple(t.shape) != (B,):
            raise ValueError(f"{name} must be ({B},) int32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    for name in ("mean", "std"):
        t = tensors[name]
        if t.dtype != torch.float32 or tuple(t.shape) != (C,):
            raise ValueError(f"{name} must be ({C},) float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    if not (1 <= out_h <= H and 1 <= out_w <= W):
        raise ValueError(f"crop {out_h}x{out_w} does not fit in {H}x{W}")
    if not 1 <= B <= MAX_BATCH or C < 1:
        raise ValueError(f"need 1 <= B <= {MAX_BATCH} and C >= 1, got "
                         f"B={B} C={C}")


def _bind(lib) -> None:
    fn = lib.crop_mirror_normalize_u8
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 7 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int


def crop_mirror_normalize(img: torch.Tensor, oy: torch.Tensor,
                          ox: torch.Tensor, mirror: torch.Tensor,
                          mean: torch.Tensor, std: torch.Tensor,
                          out_h: int, out_w: int,
                          dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The kernel's wrapper: CUDA tensors in, (B,C,out_h,out_w) out.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs and on a failed
    launch; it never falls back to the plain version.
    """
    global launches
    check_args(img, oy, ox, mirror, mean, std, out_h, out_w, dtype)
    _build.require_card(img.device)
    lib = _build.load(SOURCE, _bind)
    B, H, W, C = img.shape
    out = torch.empty((B, C, out_h, out_w), dtype=dtype, device=img.device)
    with torch.cuda.device(img.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.crop_mirror_normalize_u8(
            img.data_ptr(), oy.data_ptr(), ox.data_ptr(), mirror.data_ptr(),
            mean.data_ptr(), std.data_ptr(), out.data_ptr(),
            B, H, W, C, out_h, out_w, int(dtype == torch.bfloat16), stream)
    _build.check(lib, err, "crop_mirror_normalize")
    launches += 1
    return out


__all__ = ["crop_mirror_normalize", "check_args"]
