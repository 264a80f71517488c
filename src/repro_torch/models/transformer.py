"""Decoder-only LM, dense family: the port of ``repro.models.transformer``'s
``DecoderLM`` for prefill and decode.

One pre-norm block: x += attn(norm(x)); x += swiglu(norm(x)).  Parameters
are a dict tree under the reference's names, shapes and layout (stacked
``blocks`` with a leading layers axis, ``wq`` at (d, H, Dh), ...), so a
reference tree converts leaf by leaf; the reference's ``lax.scan`` over
the stacked axis is a loop here.  Prefill attention runs the hand-written
flash-attention kernel on a CUDA tensor, over the unexpanded (B,K,T,D) k
and v (the kernel folds head h onto kv head h // G); decode attention runs
the flash-decode kernel.  On the CPU both run their plain versions.  The
MoE and VLM families are queued (ROADMAP D3).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import resolve_device
from repro_torch.kernels import ops

from . import attention as attn
from .layers import (apply_rope, embed, embed_spec, rmsnorm, rmsnorm_spec,
                     swiglu, swiglu_spec, unembed)
from .params import init_params, stack_layer_specs, tree_map


class DecoderLM:
    """Dense decoder LM built from an ArchConfig; parameters and caches
    live on ``device`` (``"cuda"`` by default; raises without a card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.n_experts > 0 or cfg.n_patches > 0 or cfg.family != "dense":
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                "the port's DecoderLM is dense only (MoE and VLM: ROADMAP D3)")
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    # -- specs ---------------------------------------------------------------
    def block_spec(self) -> Dict:
        c = self.cfg
        return {
            "ln1": rmsnorm_spec(c.d_model),
            "attn": attn.gqa_spec(c.d_model, c.n_heads, c.n_kv_heads,
                                  c.resolved_head_dim, qk_norm=c.qk_norm),
            "ln2": rmsnorm_spec(c.d_model),
            "mlp": swiglu_spec(c.d_model, c.d_ff),
        }

    def param_specs(self) -> Dict:
        c = self.cfg
        return {
            "embed": embed_spec(c.vocab, c.d_model),
            "blocks": stack_layer_specs(self.block_spec(), c.n_layers),
            "ln_f": rmsnorm_spec(c.d_model),
        }

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random parameters from ``generator`` (a generator on this
        model's device) in ``dtype`` (the config's by default)."""
        return init_params(self.param_specs(), generator,
                           dtype or self.dtype, self.device)

    # -- forward -------------------------------------------------------------
    @staticmethod
    def _layer(params: Dict, i: int) -> Dict:
        return tree_map(lambda p: p[i], params["blocks"])

    def _block(self, lp: Dict, x: torch.Tensor,
               positions: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        h = rmsnorm(lp["ln1"], x, c.norm_eps)
        q, k, v = attn.project_qkv(lp["attn"], h)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        # (B,S,H,D) -> (B,H,S,D) views: the kernel reads them in place and
        # returns q's layout, so the transpose back is free.
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), causal=True,
                                window=c.window).transpose(1, 2)
        x = x + attn.project_out(lp["attn"], o)
        h = rmsnorm(lp["ln2"], x, c.norm_eps)
        return x + swiglu(lp["mlp"], h)

    def forward(self, params: Dict, tokens: torch.Tensor
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (prefill): tokens (B,S) -> (B,S,V) f32."""
        c = self.cfg
        B, S = tokens.shape
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        for i in range(c.n_layers):
            x = self._block(self._layer(params, i), x, positions)
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), {}

    # -- decode --------------------------------------------------------------
    def _cache_len(self, seq_len: int) -> int:
        c = self.cfg
        return min(c.window, seq_len) if c.window else seq_len

    def init_cache(self, batch: int, seq_len: int) -> Dict:
        """Stacked caches: k and v (L,B,T,K,D) in the model's dtype, and the
        host int ``pos`` that every layer and slot shares (the reference
        keeps one equal scalar per layer)."""
        c = self.cfg
        one = attn.init_kv_cache(batch, self._cache_len(seq_len),
                                 c.n_kv_heads, c.resolved_head_dim,
                                 self.dtype, self.device)
        return {"k": one["k"].repeat(c.n_layers, 1, 1, 1, 1),
                "v": one["v"].repeat(c.n_layers, 1, 1, 1, 1), "pos": 0}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) -> logits (B,1,V), cache with pos + 1 (its k and v
        are written in place)."""
        c = self.cfg
        x = embed(params["embed"], tokens, self.dtype)
        pos = cache["pos"]
        for i in range(c.n_layers):
            lp = self._layer(params, i)
            h = rmsnorm(lp["ln1"], x, c.norm_eps)
            o, _ = attn.decode_attention(
                lp["attn"], {"k": cache["k"][i], "v": cache["v"][i],
                             "pos": pos},
                h, window=c.window, rope_theta=c.rope_theta)
            x = x + o
            h = rmsnorm(lp["ln2"], x, c.norm_eps)
            x = x + swiglu(lp["mlp"], h)
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), {"k": cache["k"],
                                             "v": cache["v"], "pos": pos + 1}


__all__ = ["DecoderLM"]
