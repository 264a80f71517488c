"""Public entry points of the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); any
other tensor goes to the kernel's wrapper, which launches the CUDA kernel or
raises.  There is no fallback from a failed build or launch to the plain
version.
"""

from __future__ import annotations

import torch

from . import crop_norm, decode_attention
from . import flash_attention as _flash_attention
from . import grouped_matmul as _grouped_matmul
from .ref import (crop_mirror_normalize_reference, decode_reference,
                  gmm_reference, mha_reference)


def crop_mirror_normalize(img, oy, ox, mirror, mean, std, *, out_h: int,
                          out_w: int, dtype: torch.dtype = torch.float32):
    """img (B,H,W,C) uint8 -> (B,C,out_h,out_w) normalized; see
    ``crop_norm.crop_mirror_normalize``."""
    if img.device.type == "cpu":
        crop_norm.check_args(img, oy, ox, mirror, mean, std, out_h, out_w,
                             dtype)
        return crop_mirror_normalize_reference(img, oy, ox, mirror, mean, std,
                                               out_h, out_w, dtype)
    return crop_norm.crop_mirror_normalize(img, oy, ox, mirror, mean, std,
                                           out_h, out_w, dtype)


def flash_attention(q, k, v, *, causal: bool = True, window: int = 0):
    """q (B,H,S,D), k/v (B,K,T,D) -> (B,H,S,D); see
    ``flash_attention.flash_attention``."""
    if isinstance(q, torch.Tensor) and q.device.type == "cpu":
        _flash_attention.check_args(q, k, v, causal, window)
        return mha_reference(q, k, v, causal=causal, window=window)
    return _flash_attention.flash_attention(q, k, v, causal=causal,
                                            window=window)


def flash_decode(q, k, v, lengths):
    """q (B,K,G,D), k/v (B,K,T,D), lengths (B,) -> (B,K,G,D); see
    ``decode_attention.flash_decode``."""
    if isinstance(q, torch.Tensor) and q.device.type == "cpu":
        decode_attention.check_args(q, k, v, lengths)
        B, K, G, D = q.shape
        return decode_reference(q.reshape(B, K * G, D), k, v,
                                lengths).reshape(B, K, G, D)
    return decode_attention.flash_decode(q, k, v, lengths)


def grouped_matmul(x, w):
    """x (E,C,d) @ w (E,d,f) -> (E,C,f) in x's dtype; see
    ``grouped_matmul.grouped_matmul``."""
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        _grouped_matmul.check_args(x, w)
        return gmm_reference(x, w)
    return _grouped_matmul.grouped_matmul(x, w)


__all__ = ["crop_mirror_normalize", "flash_attention", "flash_decode",
           "grouped_matmul"]
