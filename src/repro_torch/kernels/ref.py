"""Plain versions of the port's kernels — the ground truth in tests and in
``chip_smoke.py`` — plus a copy of the reference's NumPy
``crop_mirror_normalize_np``, the host-side transform of
``data.pipeline.ImageFeed``'s materialize path.

``mha_reference``, ``decode_reference`` and ``gmm_reference`` are the torch
twins of ``repro.kernels.ref``'s oracles of the same names, in the same
layouts.
"""

from __future__ import annotations

import numpy as np
import torch

NEG_INF = -1e30


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int = 0) -> torch.Tensor:
    """q (B,H,S,D); k,v (B,K,T,D) -> (B,H,S,D) in q's dtype.  GQA by head
    folding (head h reads kv head h // G), f32 scores scaled by D**-0.5,
    masked with the finite -1e30."""
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, S, D)
    s = torch.einsum("bkgsd,bktd->bkgst", qg.float(), k.float()) * (D ** -0.5)
    qpos = torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(T, device=q.device)[None, :]
    ok = torch.ones((S, T), dtype=torch.bool, device=q.device)
    if causal:
        ok &= qpos >= kpos
    if window > 0:
        ok &= (qpos - kpos) < window
    s = torch.where(ok, s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgst,bktd->bkgsd", w, v.float())
    return o.reshape(B, H, S, D).to(q.dtype)


def decode_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     lengths: torch.Tensor) -> torch.Tensor:
    """Single-token decode. q (B,H,D); k,v (B,K,T,D); lengths (B,) valid
    prefix lengths, each >= 1 (0 is undefined, as in the reference).
    -> (B,H,D) in q's dtype."""
    B, H, D = q.shape
    K, T = k.shape[1], k.shape[2]
    G = H // K
    qg = q.reshape(B, K, G, D)
    s = torch.einsum("bkgd,bktd->bkgt", qg.float(), k.float()) * (D ** -0.5)
    valid = torch.arange(T, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    w = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgt,bktd->bkgd", w, v.float())
    return o.reshape(B, H, D).to(q.dtype)


def crop_mirror_normalize_reference(img: torch.Tensor, oy: torch.Tensor,
                                    ox: torch.Tensor, mirror: torch.Tensor,
                                    mean: torch.Tensor, std: torch.Tensor,
                                    out_h: int, out_w: int,
                                    dtype: torch.dtype = torch.float32
                                    ) -> torch.Tensor:
    """img (B,H,W,C) uint8 -> (B,C,out_h,out_w), DALI crop_mirror_normalize.

    oy/ox (B,) crop offsets, clamped into ``[0, H-out_h]`` and
    ``[0, W-out_w]``; mirror (B,) flips W where it is > 0; mean/std (C,) in
    0..255 scale.  The output is ``(float(x) - mean) / std`` in ``dtype``.
    """
    B, H, W, _ = img.shape
    dev = img.device
    y0 = oy.long().clamp(0, H - out_h)
    x0 = ox.long().clamp(0, W - out_w)
    xs = torch.arange(out_w, device=dev)
    cols = torch.where((mirror > 0)[:, None], out_w - 1 - xs, xs)
    rows = y0[:, None] + torch.arange(out_h, device=dev)          # (B, oh)
    cols = x0[:, None] + cols                                      # (B, ow)
    b = torch.arange(B, device=dev)[:, None, None]
    crop = img[b, rows[:, :, None], cols[:, None, :]]              # (B,oh,ow,C)
    x = (crop.float() - mean.float()) / std.float()
    return x.permute(0, 3, 1, 2).to(dtype).contiguous()


def crop_mirror_normalize_np(img: np.ndarray, oy, ox, mirror,
                             mean: np.ndarray, std: np.ndarray,
                             out_h: int, out_w: int,
                             dtype=np.float32) -> np.ndarray:
    """NumPy twin of the Pallas kernel: (B,H,W,C) uint8 -> (B,C,oh,ow).

    Same clamping semantics as the kernel entry point (offsets clip to the
    valid window).  Also serves as ``ImageFeed``'s materialize-path host
    transform — the four-pass CPU pipeline the fused kernel replaces.
    """
    B, H, W, C = img.shape
    oy = np.clip(np.asarray(oy, dtype=np.int64), 0, H - out_h)
    ox = np.clip(np.asarray(ox, dtype=np.int64), 0, W - out_w)
    mean = np.asarray(mean, dtype=np.float32)
    std = np.asarray(std, dtype=np.float32)
    out = np.empty((B, C, out_h, out_w), dtype=dtype)
    for i in range(B):
        crop = img[i, oy[i]:oy[i] + out_h, ox[i]:ox[i] + out_w, :]
        if mirror[i]:
            crop = crop[:, ::-1, :]
        x = (crop.astype(np.float32) - mean) / std
        out[i] = x.transpose(2, 0, 1).astype(dtype)
    return out


def gmm_reference(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Grouped (per-expert) matmul: x (E,C,d) @ w (E,d,f) -> (E,C,f),
    computed in f32 and returned in x's dtype."""
    return torch.einsum("ecd,edf->ecf", x.float(), w.float()).to(x.dtype)


__all__ = ["mha_reference", "decode_reference",
           "crop_mirror_normalize_reference", "crop_mirror_normalize_np",
           "gmm_reference"]
