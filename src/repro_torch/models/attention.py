"""GQA attention: projections (with Whisper's biases and cross-attention),
the plain attention path, the memory-efficient (chunked) attention that
trains long sequences, the full-sequence dispatch between those and the
flash-attention kernel, and the one-token decode step against a KV cache
or an encoder's keys.

The port of ``repro.models.attention``, in its layouts: q (B,S,H,Dh) with
H = K*G, k and v (B,T,K,Dh), and a KV cache of (B,T,K,Dh).  On a CUDA
tensor, prefill attention runs the hand-written flash-attention kernel
(``kernels.ops.flash_attention``) and decode attention the flash-decode
kernel (``kernels.ops.flash_decode``), both reading the model's tensors in
place through strides; on the CPU each runs its plain version.
``dense_attention`` and ``chunked_attention`` are plain torch with
autograd: they are what training runs, as the reference trains with XLA
ops (no kernel has a backward).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import apply_rope, project_heads
from .params import P

NEG_INF = -1e30
DENSE_ATTN_MAX_SEQ = 2048   # above this, train with chunked attention


def gqa_spec(d: int, n_heads: int, n_kv: int, head_dim: int,
             qk_norm: bool = False, bias: bool = False) -> Dict:
    spec = {
        "wq": P((d, n_heads, head_dim), ("d_model", "heads", "head_dim")),
        "wk": P((d, n_kv, head_dim), ("d_model", "kv_heads", "head_dim")),
        "wv": P((d, n_kv, head_dim), ("d_model", "kv_heads", "head_dim")),
        "wo": P((n_heads, head_dim, d), ("heads", "head_dim", "d_model")),
    }
    if qk_norm:  # Qwen3-style per-head RMSNorm on q and k
        spec["q_norm"] = P((head_dim,), ("head_dim",), init="ones")
        spec["k_norm"] = P((head_dim,), ("head_dim",), init="ones")
    if bias:     # whisper-style projection biases (no bias on k)
        spec["bq"] = P((n_heads, head_dim), ("heads", "head_dim"),
                       init="zeros")
        spec["bv"] = P((n_kv, head_dim), ("kv_heads", "head_dim"),
                       init="zeros")
        spec["bo"] = P((d,), ("d_model",), init="zeros")
    return spec


def _head_rmsnorm(x: torch.Tensor, scale: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def project_q(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """x (B,S,d) -> q (B,S,H,Dh), with its bias where the spec has one."""
    q = project_heads(x, params["wq"])
    if "bq" in params:
        q = q + params["bq"].to(q.dtype)
    return q


def project_qkv(params: Dict, x: torch.Tensor,
                x_kv: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """x (B,S,d) -> q (B,S,H,Dh); k and v (B,T,K,Dh) from ``x_kv``
    (B,T,d), by default ``x`` (cross-attention gives the encoder's
    output)."""
    x_kv = x if x_kv is None else x_kv
    q = project_q(params, x)
    k = project_heads(x_kv, params["wk"])
    v = project_heads(x_kv, params["wv"])
    if "bv" in params:
        v = v + params["bv"].to(v.dtype)
    if "q_norm" in params:
        q = _head_rmsnorm(q, params["q_norm"])
        k = _head_rmsnorm(k, params["k_norm"])
    return q, k, v


def project_out(params: Dict, o: torch.Tensor) -> torch.Tensor:
    """o (B,S,H,Dh) -> (B,S,d)."""
    wo = params["wo"]
    out = o.flatten(-2) @ wo.reshape(-1, wo.shape[-1])
    if "bo" in params:
        out = out + params["bo"].to(out.dtype)
    return out


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
    the reference a TPU sharding workaround; the port keeps it where the
    reference calls it, in the plain and chunked attention, so that both
    compute the same sums.)"""
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
# Chunked (memory-efficient) attention with a recompute backward
# ---------------------------------------------------------------------------

def _block_live(qs: slice, ks: slice, causal: bool, window: int) -> bool:
    """Whether the (query, key) block keeps at least one pair under the
    causal and window masks.  A block the masks remove whole adds exactly
    nothing in the reference (its softmax weights are exp(-1e30 - m) = 0,
    and a weight it gives a row with no key yet is reset to 0 by the next
    block's correction), so skipping it changes no bit of the result."""
    if causal and ks.start > qs.stop - 1:
        return False
    return not (window > 0 and qs.start - (ks.stop - 1) >= window)


def _grouped(x: torch.Tensor, K: int) -> torch.Tensor:
    """(B,S,H,Dh) -> (B,K,G,S,Dh), a view where the strides allow."""
    B, S, H, Dh = x.shape
    return x.reshape(B, S, K, H // K, Dh).permute(0, 2, 3, 1, 4)


def _mea_forward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, window: int, q_chunk: int, kv_chunk: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Online-softmax forward, the reference's ``_mea_forward``: q
    (B,S,H,Dh), k and v (B,T,K,Dh), S and T multiples of their chunks,
    positions arange.  Returns out (B,S,H,Dh) in q's dtype and the
    log-sum-exp lse (B,K,G,S) in f32."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = Dh ** -0.5
    dev = q.device
    qg = _grouped(q, K)                                  # (B,K,G,S,Dh)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)   # (B,K,T,Dh)
    out = torch.empty((B, K, G, S, Dh), dtype=q.dtype, device=dev)
    lse = torch.empty((B, K, G, S), dtype=torch.float32, device=dev)
    for iq in range(S // q_chunk):
        qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
        qc = qg[:, :, :, qs]
        qpos = torch.arange(qs.start, qs.stop, device=dev)
        m = torch.full((B, K, G, q_chunk), NEG_INF, device=dev)
        l = torch.zeros((B, K, G, q_chunk), device=dev)
        acc = torch.zeros((B, K, G, q_chunk, Dh), device=dev)
        for j in range(T // kv_chunk):
            ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
            if not _block_live(qs, ks, causal, window):
                continue
            kb, vb = kt[:, :, ks], vt[:, :, ks]
            kpos = torch.arange(ks.start, ks.stop, device=dev)
            s = torch.einsum("bkgqd,bktd->bkgqt", qc, kb).float()
            s = s * scale + _mask_bias(qpos, kpos, causal, window)
            m_new = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - m_new)
            p = torch.exp(s - m_new[..., None])
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkgqt,bktd->bkgqd", p.to(vb.dtype), vb)
            acc = acc * corr[..., None] + pv
            m = m_new
        out[:, :, :, qs] = (acc / l.clamp_min(1e-30)[..., None]).to(q.dtype)
        lse[..., qs] = m + torch.log(l.clamp_min(1e-30))
    return out.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh), lse


def _mea_backward(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, lse: torch.Tensor, dout: torch.Tensor,
                  causal: bool, window: int, q_chunk: int, kv_chunk: int
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Flash-style backward, the reference's ``_mea_bwd``: the scores are
    recomputed blockwise from ``lse`` and never saved, ``delta = sum(dO *
    O)``, dq accumulates in f32 over the kv chunks, and each kv chunk's dk
    and dv sum (in f32) over the q chunks.  Live memory is one block's
    scores plus the dq accumulator."""
    B, S, H, Dh = q.shape
    T, K = k.shape[1], k.shape[2]
    G = H // K
    scale = Dh ** -0.5
    dev = q.device
    qg, dog = _grouped(q, K), _grouped(dout, K)
    kt, vt = k.permute(0, 2, 1, 3), v.permute(0, 2, 1, 3)
    delta = (dout.float() * out.float()).sum(dim=-1)          # (B,S,H)
    delta = delta.reshape(B, S, K, G).permute(0, 2, 3, 1)     # (B,K,G,S)
    dq = torch.zeros((B, K, G, S, Dh), device=dev)
    dk = torch.empty((B, K, T, Dh), dtype=k.dtype, device=dev)
    dv = torch.empty((B, K, T, Dh), dtype=v.dtype, device=dev)
    for j in range(T // kv_chunk):
        ks = slice(j * kv_chunk, (j + 1) * kv_chunk)
        kb, vb = kt[:, :, ks], vt[:, :, ks]
        kb32, vb32 = kb.float(), vb.float()
        kpos = torch.arange(ks.start, ks.stop, device=dev)
        dk_j = torch.zeros((B, K, kv_chunk, Dh), device=dev)
        dv_j = torch.zeros((B, K, kv_chunk, Dh), device=dev)
        for iq in range(S // q_chunk):
            qs = slice(iq * q_chunk, (iq + 1) * q_chunk)
            if not _block_live(qs, ks, causal, window):
                continue
            qc, doc = qg[:, :, :, qs], dog[:, :, :, qs].float()
            qpos = torch.arange(qs.start, qs.stop, device=dev)
            s = torch.einsum("bkgqd,bktd->bkgqt", qc, kb).float()
            s = s * scale + _mask_bias(qpos, kpos, causal, window)
            p = torch.exp(s - lse[..., qs, None])
            dv_j += torch.einsum("bkgqt,bkgqd->bktd", p, doc)
            dp = torch.einsum("bkgqd,bktd->bkgqt", doc, vb32)
            ds = p * (dp - delta[..., qs, None]) * scale
            dq[:, :, :, qs] += torch.einsum("bkgqt,bktd->bkgqd", ds, kb32)
            dk_j += torch.einsum("bkgqt,bkgqd->bktd", ds, qc.float())
        dk[:, :, ks] = dk_j.to(k.dtype)
        dv[:, :, ks] = dv_j.to(v.dtype)
    dq = dq.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)
    return dq, dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


class _ChunkedAttention(torch.autograd.Function):
    """The reference's ``custom_vjp`` ``_mea_attention``: the forward saves
    q, k, v, out and lse; the backward recomputes the scores."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_chunk, kv_chunk):
        out, lse = _mea_forward(q, k, v, causal, window, q_chunk, kv_chunk)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.masks = (causal, window, q_chunk, kv_chunk)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _mea_backward(q, k, v, out, lse, dout, *ctx.masks)
        return dq, dk, dv, None, None, None, None


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      q_pos: Optional[torch.Tensor] = None,
                      kv_pos: Optional[torch.Tensor] = None, *,
                      causal: bool = True, window: int = 0,
                      q_chunk: int = 1024, kv_chunk: int = 1024
                      ) -> torch.Tensor:
    """Memory-efficient attention with a recompute backward: q
    (B,S,H,Dh), k/v (B,T,K,Dh) -> (B,S,H,Dh), equal to
    ``dense_attention`` forward and gradient.

    Positions are implicit arange (``q_pos``/``kv_pos`` are accepted for
    parity with ``dense_attention`` and ignored, as in the reference).  k
    and v are expanded to the H query heads first, and S and T padded to
    multiples of their chunks (padded keys lie after every real query, so
    a causal mask removes them; non-causal callers must pass exact
    multiples, as in the reference)."""
    B, S, H, Dh = q.shape
    k = expand_kv(k, H)
    v = expand_kv(v, H)
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    S_p = -(-S // q_chunk) * q_chunk
    T_p = -(-T // kv_chunk) * kv_chunk
    if S_p != S:
        q = F.pad(q, (0, 0, 0, 0, 0, S_p - S))
    if T_p != T:
        k = F.pad(k, (0, 0, 0, 0, 0, T_p - T))
        v = F.pad(v, (0, 0, 0, 0, 0, T_p - T))
    out = _ChunkedAttention.apply(q, k, v, causal, window, q_chunk,
                                  kv_chunk)
    return out[:, :S]


def sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, causal: bool = True, window: int = 0,
                       train: bool = False) -> torch.Tensor:
    """Full-sequence attention, q (B,S,H,Dh) against k/v (B,T,K,Dh) with
    positions arange(S) and arange(T) -> (B,S,H,Dh).

    ``train=False`` (prefill) runs the flash-attention kernel over the
    unexpanded k and v (it folds head h onto kv head h // G), through
    (B,H,S,D) views that it reads in place; its output comes back in q's
    layout, so the transpose back is free.  ``train=True`` follows the
    reference's rule: ``chunked_attention`` for causal attention over more
    than ``DENSE_ATTN_MAX_SEQ`` tokens, ``dense_attention`` otherwise."""
    if not train:
        return ops.flash_attention(
            q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2),
            causal=causal, window=window).transpose(1, 2)
    if causal and q.shape[1] > DENSE_ATTN_MAX_SEQ:
        return chunked_attention(q, k, v, causal=True, window=window)
    q_pos = torch.arange(q.shape[1], device=q.device)
    kv_pos = torch.arange(k.shape[1], device=q.device)
    return dense_attention(q, k, v, q_pos, kv_pos, causal=causal,
                           window=window)


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


def cache_specs(batch: int, max_len: int, n_kv: int, head_dim: int,
                dtype: torch.dtype = torch.bfloat16) -> Dict:
    """The reference's cache spec as ``meta`` tensors: k and v (B,T,K,D)
    and ``pos`` an int32 scalar (the port keeps it as a host int)."""
    shape = (batch, max_len, n_kv, head_dim)
    return {"k": torch.empty(shape, dtype=dtype, device="meta"),
            "v": torch.empty(shape, dtype=dtype, device="meta"),
            "pos": torch.empty((), dtype=torch.int32, device="meta")}


def stack_specs(tree: Dict, n: int) -> Dict:
    """Each ``meta`` leaf of ``tree`` with a leading axis of ``n``."""
    return {k: stack_specs(v, n) if isinstance(v, dict) else
            torch.empty((n,) + tuple(v.shape), dtype=v.dtype, device="meta")
            for k, v in tree.items()}


def token_spec(batch: int, seq: int) -> torch.Tensor:
    """An int32 (batch, seq) ``meta`` tensor: the tokens' spec."""
    return torch.empty((batch, seq), dtype=torch.int32, device="meta")


KV_CACHE_AXES = {"k": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                 "v": ("layers", "batch", "kv_seq", "kv_heads", "head_dim"),
                 "pos": ("layers",)}


def cache_slot(pos: int, T: int, window: int) -> int:
    """Where token ``pos`` is written: a ring for sliding-window caches;
    on a linear cache the index is clamped to T-1, as the reference's
    ``dynamic_update_slice`` clamps a write past the end."""
    return pos % T if window > 0 else min(pos, T - 1)


def decode_attention(params: Dict, cache: Dict, x: torch.Tensor, *,
                     window: int = 0, rope_theta: float = 10_000.0,
                     use_rope: bool = True) -> Tuple[torch.Tensor, Dict]:
    """One-token step: x (B,1,d) -> (out (B,1,d), cache with pos + 1).

    Writes the token's k and v into ``cache`` in place (the reference
    returns new arrays and donates the old).  Every slot attends to the
    ``min(pos+1, T)`` valid positions, which is the reference's mask for a
    linear cache (``kv_idx <= pos``) and for a ring (``age < min(pos+1,
    T)``); decode has no causal mask, so ring order does not matter.
    ``use_rope=False`` (Whisper) leaves q and k unrotated.
    """
    q, k_new, v_new = project_qkv(params, x)
    pos = cache["pos"]
    if use_rope:
        posv = torch.full((1, 1), pos, dtype=torch.int32, device=x.device)
        q = apply_rope(q, posv, rope_theta)
        k_new = apply_rope(k_new, posv, rope_theta)
    k, v = cache["k"], cache["v"]
    T = k.shape[1]
    slot = cache_slot(pos, T, window)
    k[:, slot] = k_new[:, 0]
    v[:, slot] = v_new[:, 0]
    out = cache_attention(params, q, k, v, min(pos + 1, T))
    return out, {"k": k, "v": v, "pos": pos + 1}


def cache_attention(params: Dict, q: torch.Tensor, k: torch.Tensor,
                    v: torch.Tensor, length: int) -> torch.Tensor:
    """q (B,1,H,D) against the first ``length`` rows of every slot's k and
    v (B,T,K,D), through the flash-decode kernel (which reads the cache
    as a (B,K,T,D) view in place), then the out projection: (B,1,d).
    Decode self-attention passes ``min(pos + 1, T)``; Whisper's decode
    cross-attention passes every encoder frame, which is the reference's
    non-causal ``dense_attention`` over them."""
    return project_out(params, _decode(q, k, v, length))


def _decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            length: int) -> torch.Tensor:
    """``cache_attention``'s kernel call: q (B,1,H,D) against the first
    ``length`` rows of k and v (B,T,K,D) -> (B,1,H,D)."""
    B, _, H, D = q.shape
    K = k.shape[2]
    # on ``meta`` (the dry run) the kernel's work is read from the lengths
    dev = "cpu" if q.device.type == "meta" else q.device
    lengths = torch.full((B,), length, dtype=torch.int32, device=dev)
    o = ops.flash_decode(q.reshape(B, K, H // K, D), k.transpose(1, 2),
                         v.transpose(1, 2), lengths)
    return o.reshape(B, 1, H, D)


__all__ = ["gqa_spec", "project_q", "project_qkv", "project_out",
           "expand_kv", "dense_attention", "chunked_attention",
           "sequence_attention", "init_kv_cache", "cache_specs",
           "stack_specs", "token_spec", "KV_CACHE_AXES", "cache_slot",
           "decode_attention", "cache_attention", "NEG_INF",
           "DENSE_ATTN_MAX_SEQ"]
