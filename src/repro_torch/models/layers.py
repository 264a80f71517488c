"""Shared layers: RMSNorm, LayerNorm, RoPE, sinusoidal positions, SwiGLU
and GELU MLPs, embedding, unembedding, an output head and the loss — the
port of ``repro.models.layers``, spec-based like the reference and in its
layouts."""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from repro_torch.core.spans import span

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


def layernorm_spec(d: int) -> Dict:
    return {"scale": P((d,), ("d_model",), init="ones"),
            "bias": P((d,), ("d_model",), init="zeros")}


def layernorm(params: Dict, x: torch.Tensor,
              eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm computed in f32, returned in ``x``'s dtype."""
    dt = x.dtype
    x = x.float()
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    x = (x - mu) * torch.rsqrt(var + eps)
    return (x * params["scale"].float() + params["bias"].float()).to(dt)


def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """(..., d) @ (d, heads, Dh) -> (..., heads, Dh)."""
    return (x @ w.reshape(w.shape[0], -1)).unflatten(-1, w.shape[1:])


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


def sinusoidal_positions(seq: int, d: int, device=None,
                         first: int = 0) -> torch.Tensor:
    """(seq, d) f32 for positions first .. first+seq-1: sin of
    pos / 10000**(2i/d) in the even columns, cos in the odd ones."""
    pos = torch.arange(first, first + seq, dtype=torch.float32,
                       device=device)[:, None]
    dim = torch.arange(0, d, 2, dtype=torch.float32, device=device)[None, :]
    angle = pos / torch.pow(10_000.0, dim / d)
    pe = torch.zeros((seq, d), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(angle)
    pe[:, 1::2] = torch.cos(angle[:, : d // 2])
    return pe


def swiglu_spec(d: int, f: int) -> Dict:
    return {"w_gate": P((d, f), ("d_model", "d_ff")),
            "w_up": P((d, f), ("d_model", "d_ff")),
            "w_down": P((f, d), ("d_ff", "d_model"))}


def swiglu(params: Dict, x: torch.Tensor) -> torch.Tensor:
    g = x @ params["w_gate"]
    u = x @ params["w_up"]
    return (F.silu(g) * u) @ params["w_down"]


def gelu_mlp_spec(d: int, f: int) -> Dict:
    return {"w_in": P((d, f), ("d_model", "d_ff")),
            "b_in": P((f,), ("d_ff",), init="zeros"),
            "w_out": P((f, d), ("d_ff", "d_model")),
            "b_out": P((d,), ("d_model",), init="zeros")}


def gelu_mlp(params: Dict, x: torch.Tensor) -> torch.Tensor:
    """GELU in its tanh form (``jax.nn.gelu``'s default), in f32."""
    h = x @ params["w_in"] + params["b_in"]
    h = F.gelu(h.float(), approximate="tanh").to(x.dtype)
    return h @ params["w_out"] + params["b_out"]


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
    """Logits in f32 against the tied embedding, for a stable softmax
    (the span ``unembed`` with ``core.spans`` on)."""
    with span("unembed"):
        return x.float() @ params["embedding"].float().t()


def output_head_spec(d: int, vocab: int) -> Dict:
    return {"w_out": P((d, vocab), ("d_model", "vocab"))}


def output_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    with span("unembed"):
        return x.float() @ params["w_out"].float()


def logz_and_target(logits: torch.Tensor, targets: torch.Tensor):
    """``logsumexp`` of each row of ``logits`` (..., V) and the logit of
    its target."""
    logz = torch.logsumexp(logits, dim=-1)
    ll = torch.gather(logits, -1, targets[..., None].long())[..., 0]
    return logz, ll


def softmax_xent(logits: torch.Tensor, targets: torch.Tensor,
                 mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Mean cross-entropy over valid positions. logits: (..., V)."""
    logz, ll = logz_and_target(logits.float(), targets)
    nll = logz - ll
    if mask is not None:
        mask = mask.float()
        return (nll * mask).sum() / mask.sum().clamp_min(1.0)
    return nll.mean()


__all__ = ["rmsnorm_spec", "rmsnorm", "layernorm_spec", "layernorm",
           "project_heads", "rope_freqs", "apply_rope",
           "sinusoidal_positions", "swiglu_spec",
           "swiglu", "gelu_mlp_spec", "gelu_mlp", "embed_spec", "embed",
           "unembed", "output_head_spec", "output_head", "logz_and_target",
           "softmax_xent"]
