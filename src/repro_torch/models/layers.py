"""Shared layers of the dense decoder: RMSNorm, RoPE, SwiGLU, embedding,
unembedding and the loss — the port of the parts of
``repro.models.layers`` that the dense family runs, spec-based like the
reference and in its layouts."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from .params import P


def rmsnorm_spec(d: int) -> Dict:
    return {"scale": P((d,), ("d_model",), init="ones")}


def rmsnorm(params: Dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm computed in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * params["scale"].float()).to(dt)


def rope_freqs(head_dim: int, theta: float = 10_000.0,
               device=None) -> torch.Tensor:
    half = head_dim // 2
    exponent = torch.arange(0, half, dtype=torch.float32, device=device) / half
    return 1.0 / (theta ** exponent)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 10_000.0) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq).  Rotates the
    two halves of the head dimension (not interleaved pairs), with f32
    angles."""
    dt = x.dtype
    half = x.shape[-1] // 2
    freqs = rope_freqs(x.shape[-1], theta, device=x.device)     # (half,)
    angles = positions[..., :, None].float() * freqs     # (..., S, half)
    cos = torch.cos(angles)[..., :, None, :]             # (..., S, 1, half)
    sin = torch.sin(angles)[..., :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(dt)


def swiglu_spec(d: int, f: int) -> Dict:
    return {"w_gate": P((d, f), ("d_model", "d_ff")),
            "w_up": P((d, f), ("d_model", "d_ff")),
            "w_down": P((f, d), ("d_ff", "d_model"))}


def swiglu(params: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


def embed_spec(vocab: int, d: int) -> Dict:
    return {"embedding": P((vocab, d), ("vocab", "d_model"), init="embed")}


def embed(params: Dict, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """Rows of the embedding in ``dtype``.  ``F.embedding``'s backward sums
    a repeated token's rows in a fixed order (indexing's backward adds
    them in whatever order the CPU's threads reach them), which keeps a
    restart from a checkpoint bit-exact."""
    return F.embedding(tokens.long(), params["embedding"].to(dtype))


def unembed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32 against the tied embedding, for a stable softmax."""
    return x.float() @ params["embedding"].float().t()


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions. logits: (..., V)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


__all__ = ["rmsnorm_spec", "rmsnorm", "rope_freqs", "apply_rope",
           "swiglu_spec", "swiglu", "embed_spec", "embed", "unembed",
           "softmax_xent"]
