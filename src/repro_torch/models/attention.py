"""GQA attention for the dense decoder: projections, the plain attention
path, and the one-token decode step against a KV cache.

The port of the dense family's part of ``repro.models.attention``, in its
layouts: q (B,S,H,Dh) with H = K*G, k and v (B,T,K,Dh), and a KV cache of
(B,T,K,Dh).  On a CUDA tensor, decode attention runs the hand-written
flash-decode kernel (``kernels.ops.flash_decode``), which reads the cache
in place through strides; on the CPU it runs the kernel's plain version.
``chunked_attention`` and its recompute backward come with the trainer.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import ops

from .layers import apply_rope
from .params import P

NEG_INF = -1e30


def gqa_spec(d: int, n_heads: int, n_kv: int, head_dim: int,
             qk_norm: bool = False) -> Dict:
    spec = {
        "wq": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim")),
        "wk": P((d, n_kv, head_dim), ("d_model", "kv_heads", "head_dim")),
        "wv": P((d, n_kv, head_dim), ("d_model", "kv_heads", "head_dim")),
        "wo": P((n_heads, head_dim, d), ("heads", "head_dim", "d_model")),
    }
    if qk_norm:  # Qwen3-style per-head RMSNorm on q and k
        spec["q_norm"] = P((head_dim,), ("head_dim",), init="ones")
        spec["k_norm"] = P((head_dim,), ("head_dim",), init="ones")
    return spec


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def _project(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, heads, Dh) -> (..., heads, Dh)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


def project_qkv(params: Dict, x: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,H,Dh), k (B,S,K,Dh), v (B,S,K,Dh)."""
    q = _project(x, params["wq"])
    k = _project(x, params["wk"])
    v = _project(x, params["wv"])
    if "q_norm" in params:
        q = _head_rmsnorm(q, params["q_norm"])
        k = _head_rmsnorm(k, params["k_norm"])
    return q, k, v


def project_out(params: Dict, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,Dh) -> (B,S,d)."""
    wo = params["wo"]
    return o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])


def _mask_bias(q_pos: torch.Tensor, kv_pos: torch.Tensor, causal: bool,
               window: int,
               kv_valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """(…, Sq, Tk) additive bias from causality / sliding window / validity."""
    d = q_pos[..., :, None] - kv_pos[..., None, :]
    ok = torch.ones(d.shape, dtype=torch.bool, device=d.device)
    if causal:
        ok &= d >= 0
    if window > 0:
        ok &= d < window
    if kv_valid is not None:
        ok = ok & kv_valid[..., None, :]
    return torch.where(ok, 0.0, NEG_INF).float()


def expand_kv(k: torch.Tensor, n_heads: int) -> torch.Tensor:
    """(B,T,K,D) -> (B,T,H,D) by repeating each kv head G=H/K times.  (In
    the reference a TPU sharding workaround; here only the plain path's
    ``expand_heads`` branch uses it.)"""
    G = n_heads // k.shape[2]
    if G == 1:
        return k
    return torch.repeat_interleave(k, G, dim=2)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    q_pos: torch.Tensor, kv_pos: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    kv_valid: Optional[torch.Tensor] = None,
                    expand_heads: bool = True) -> torch.Tensor:
    """The plain path: q (B,S,H,Dh), k/v (B,T,K,Dh) -> (B,S,H,Dh)."""
    B, S, H, Dh = q.shape
    scale = Dh ** -0.5
    bias = _mask_bias(q_pos, kv_pos, causal, window, kv_valid)
    if expand_heads:
        k = expand_kv(k, H)
        v = expand_kv(v, H)
        scores = torch.einsum("bshd,bthd->bhst", q, k).float() * scale
        scores = scores + (bias[..., None, :, :] if bias.dim() == 3
                           else bias)
        w = torch.softmax(scores, dim=-1).to(v.dtype)
        return torch.einsum("bhst,bthd->bshd", w, v)
    K = k.shape[2]
    G = H // K
    qg = q.reshape(B, S, K, G, Dh)
    scores = torch.einsum("bskgd,btkd->bkgst", qg, k).float() * scale
    scores = scores + (bias[..., None, None, :, :] if bias.dim() == 3
                       else bias)
    w = torch.softmax(scores, dim=-1).to(v.dtype)
    o = torch.einsum("bkgst,btkd->bskgd", w, v)
    return o.reshape(B, S, H, Dh)


# ---------------------------------------------------------------------------
# KV caches (decode)
# ---------------------------------------------------------------------------

def init_kv_cache(batch: int, max_len: int, n_kv: int, head_dim: int,
                  dtype: torch.dtype = torch.bfloat16,
                  device="cuda") -> Dict:
    """k and v (B,T,K,D) on ``device``; ``pos``, the tokens written so far,
    is a host int shared by every slot, as the reference's scalar is."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": 0}


def cache_slot(pos: int, T: int, window: int) -> int:
    """Where token ``pos`` is written: a ring for sliding-window caches;
    on a linear cache the index is clamped to T-1, as the reference's
    ``dynamic_update_slice`` clamps a write past the end."""
    return pos % T if window > 0 else min(pos, T - 1)


def decode_attention(params: Dict, cache: Dict, x: torch.Tensor, *,
                     window: int = 0, rope_theta: float = 10_000.0
                     ) -> Tuple[torch.Tensor, Dict]:
    """One-token step: x (B,1,d) -> (out (B,1,d), cache with pos + 1).

    Writes the token's k and v into ``cache`` in place (the reference
    returns new arrays and donates the old).  Every slot attends to the
    ``min(pos+1, T)`` valid positions, which is the reference's mask for a
    linear cache (``kv_idx <= pos``) and for a ring (``age < min(pos+1,
    T)``); decode has no causal mask, so ring order does not matter.
    """
    B = x.shape[0]
    q, k_new, v_new = project_qkv(params, x)
    pos = cache["pos"]
    posv = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
    q = apply_rope(q, posv, rope_theta)
    k_new = apply_rope(k_new, posv, rope_theta)
    k, v = cache["k"], cache["v"]
    T, K, D = k.shape[1], k.shape[2], k.shape[3]
    slot = cache_slot(pos, T, window)
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    lengths = torch.full((B,), min(pos + 1, T), dtype=torch.int32,
                         device=x.device)
    H = q.shape[2]
    o = ops.flash_decode(q.reshape(B, K, H // K, D), k.transpose(1, 2),
                         v.transpose(1, 2), lengths)
    out = project_out(params, o.reshape(B, 1, H, D))
    return out, {"k": k, "v": v, "pos": pos + 1}


__all__ = ["gqa_spec", "project_qkv", "project_out", "expand_kv",
           "dense_attention", "init_kv_cache", "cache_slot",
           "decode_attention", "NEG_INF"]
