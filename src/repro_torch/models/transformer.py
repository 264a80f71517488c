"""Decoder-only LM, dense, MoE and VLM families: the port of
``repro.models.transformer``'s ``DecoderLM`` for prefill and decode.

One pre-norm block: x += attn(norm(x)); x += swiglu|moe(norm(x)).
Parameters are a dict tree under the reference's names, shapes and layout
(stacked ``blocks`` with a leading layers axis, ``wq`` at (d, H, Dh), the
experts at (E, d, f), ...), so a reference tree converts leaf by leaf; the
reference's ``lax.scan`` over the stacked axis is a loop here.  Prefill
attention runs the hand-written flash-attention kernel on a CUDA tensor,
over the unexpanded (B,K,T,D) k and v (the kernel folds head h onto kv
head h // G); decode attention runs the flash-decode kernel; the MoE
family's expert FFNs run the grouped-matmul kernel (``models.moe``).  On
the CPU each runs its plain version.  The VLM family writes its projected
patch embeddings (``extras["patch_embeds"]``) over the first positions.
The audio, hybrid and ssm families are queued (ROADMAP A7).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.configs.base import ArchConfig
from repro_torch.data.pipeline import resolve_device
from repro_torch.kernels import ops

from . import attention as attn
from . import moe as moe_mod
from .layers import (apply_rope, embed, embed_spec, rmsnorm, rmsnorm_spec,
                     swiglu, swiglu_spec, unembed)
from .params import P, init_params, stack_layer_specs, tree_map

FAMILIES = ("dense", "moe", "vlm")


class DecoderLM:
    """dense / moe / vlm decoder LM built from an ArchConfig; parameters and
    caches live on ``device`` (``"cuda"`` by default; raises without a
    card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in FAMILIES:
            raise NotImplementedError(
                f"{cfg.name}: the {cfg.family} family is not ported yet; "
                f"the port's DecoderLM takes {FAMILIES} (the rest: ROADMAP "
                "A7)")
        self.cfg = cfg
        self.is_moe = cfg.n_experts > 0
        self.is_vlm = cfg.n_patches > 0
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)

    # -- specs ---------------------------------------------------------------
    def block_spec(self) -> Dict:
        c = self.cfg
        spec = {
            "ln1": rmsnorm_spec(c.d_model),
            "attn": attn.gqa_spec(c.d_model, c.n_heads, c.n_kv_heads,
                                  c.resolved_head_dim, qk_norm=c.qk_norm),
            "ln2": rmsnorm_spec(c.d_model),
        }
        if self.is_moe:
            spec["moe"] = moe_mod.moe_spec(c.d_model, c.d_ff, c.n_experts)
        else:
            spec["mlp"] = swiglu_spec(c.d_model, c.d_ff)
        return spec

    def param_specs(self) -> Dict:
        c = self.cfg
        spec = {
            "embed": embed_spec(c.vocab, c.d_model),
            "blocks": stack_layer_specs(self.block_spec(), c.n_layers),
            "ln_f": rmsnorm_spec(c.d_model),
        }
        if self.is_vlm:
            spec["mm_proj"] = {"w": P((c.d_model, c.d_model),
                                      ("d_model", "d_model_out"))}
        return spec

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

    def _ffn(self, lp: Dict, h: torch.Tensor
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        c = self.cfg
        if self.is_moe:
            return moe_mod.moe_apply(lp["moe"], h, top_k=c.top_k,
                                     capacity_factor=c.capacity_factor)
        return swiglu(lp["mlp"], h), {}

    def _block(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
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
        y, aux = self._ffn(lp, h)
        return x + y, aux

    def forward(self, params: Dict, tokens: torch.Tensor,
                extras: Optional[Dict] = None) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits (prefill): tokens (B,S) -> (B,S,V) f32, and
        the MoE metrics averaged over layers ({} for the other families).
        A VLM reads ``extras["patch_embeds"]`` (B,P,d), P <= S."""
        c = self.cfg
        B, S = tokens.shape
        x = embed(params["embed"], tokens, self.dtype)
        if self.is_vlm:
            patches = extras["patch_embeds"].to(self.dtype)
            patches = torch.einsum("bpd,de->bpe", patches,
                                   params["mm_proj"]["w"])
            x = torch.cat([patches, x[:, patches.shape[1]:]], dim=1)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        aux = {}
        for i in range(c.n_layers):
            x, layer_aux = self._block(self._layer(params, i), x, positions)
            for k, v in layer_aux.items():
                aux[k] = aux.get(k, 0.0) + v.float()
        aux = {k: v / c.n_layers for k, v in aux.items()}
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), aux

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
            x = x + self._ffn(lp, h)[0]
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), {"k": cache["k"],
                                             "v": cache["v"], "pos": pos + 1}


__all__ = ["DecoderLM"]
