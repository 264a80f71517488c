"""Public entry points of the port's kernels.

A CPU tensor goes to the kernel's plain PyTorch version (``ref.py``); a
``meta`` tensor (the dry run, ``launch.dryrun_lib``) gets an output of the
right shape and dtype, and the active counter (``cost.charging``) is
charged one call with the kernel's work by its ``cost`` formula; any other
tensor goes to the kernel's wrapper, which launches the CUDA kernel or
raises.  There is no fallback from a failed build or launch to the plain
version, and the meta branch computes nothing.

The meta branch takes plain tensors: on a mesh, the models call it on
each device's shards (``models.attention.on_shards``,
``models.moe``), so its charge is one device's work.
"""

from __future__ import annotations

import torch

from . import cost, crop_norm, decode_attention
from . import flash_attention as _flash_attention
from . import grouped_matmul as _grouped_matmul
from .ref import (crop_mirror_normalize_reference, decode_reference,
                  gmm_reference, mha_reference)


def crop_mirror_normalize(img, oy, ox, mirror, mean, std, *, out_h: int,
                          out_w: int, dtype: torch.dtype = torch.float32):
    """img (B,H,W,C) uint8 -> (B,C,out_h,out_w) normalized; see
    ``crop_norm.crop_mirror_normalize``."""
    if img.device.type == "meta":
        flops, nbytes = cost.crop_work(img.shape[0], img.shape[3], out_h,
                                       out_w, torch.empty((), dtype=dtype)
                                       .element_size())
        cost.charge("crop_mirror_normalize", flops, nbytes,
                    (img, oy, ox, mirror, mean, std))
        return torch.empty((img.shape[0], img.shape[3], out_h, out_w),
                           dtype=dtype, device="meta")
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
    if isinstance(q, torch.Tensor) and q.device.type == "meta":
        return _meta_attention(q, k, v, causal, window)
    if isinstance(q, torch.Tensor) and q.device.type == "cpu":
        _flash_attention.check_args(q, k, v, causal, window)
        return mha_reference(q, k, v, causal=causal, window=window)
    return _flash_attention.flash_attention(q, k, v, causal=causal,
                                            window=window)


def flash_decode(q, k, v, lengths):
    """q (B,K,G,D), k/v (B,K,T,D), lengths (B,) -> (B,K,G,D); see
    ``decode_attention.flash_decode``."""
    if isinstance(q, torch.Tensor) and q.device.type == "meta":
        return _meta_decode(q, k, v, lengths)
    if isinstance(q, torch.Tensor) and q.device.type == "cpu":
        decode_attention.check_args(q, k, v, lengths)
        B, K, G, D = q.shape
        return decode_reference(q.reshape(B, K * G, D), k, v,
                                lengths).reshape(B, K, G, D)
    return decode_attention.flash_decode(q, k, v, lengths)


def grouped_matmul(x, w):
    """x (E,C,d) @ w (E,d,f) -> (E,C,f) in x's dtype; see
    ``grouped_matmul.grouped_matmul``."""
    if isinstance(x, torch.Tensor) and x.device.type == "meta":
        return _meta_gmm(x, w)
    if isinstance(x, torch.Tensor) and x.device.type == "cpu":
        _grouped_matmul.check_args(x, w)
        return gmm_reference(x, w)
    return _grouped_matmul.grouped_matmul(x, w)


# ---------------------------------------------------------------------------
# The meta branch (the dry run): shapes and work, no computation
# ---------------------------------------------------------------------------

def _empty(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_attention(q, k, v, causal: bool, window: int) -> torch.Tensor:
    B, H, S, D = q.shape
    flops, nbytes = cost.attention_work(B, H, k.shape[1], S, k.shape[2], D,
                                        q.element_size(), causal, window)
    cost.charge("flash_attention", flops, nbytes, (q, k, v))
    return _empty(q.shape, q.dtype)


def _meta_decode(q, k, v, lengths) -> torch.Tensor:
    """``lengths`` is a host tensor here: the work depends on its values."""
    B, K, G, D = q.shape
    flops, nbytes = cost.decode_work(lengths.tolist(), K, G, D,
                                     q.element_size())
    cost.charge("flash_decode", flops, nbytes, (q, k, v))
    return _empty(q.shape, q.dtype)


def _meta_gmm(x, w) -> torch.Tensor:
    E, C, d = x.shape
    flops, nbytes = cost.gmm_work(E, C, d, w.shape[-1], x.element_size())
    cost.charge("grouped_matmul", flops, nbytes, (x, w))
    return _empty((E, C, w.shape[-1]), x.dtype)


__all__ = ["crop_mirror_normalize", "flash_attention", "flash_decode",
           "grouped_matmul"]
