"""Decoder-only LM, dense, MoE and VLM families: the port of
``repro.models.transformer``'s ``DecoderLM`` for training, prefill and
decode.

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
The hybrid, ssm and audio families have models of their own
(``models.hybrid``, ``models.xlstm``, ``models.whisper``).

Training (``forward(..., train=True)``, ``train_loss``) runs plain torch
with autograd, as the reference trains with XLA ops: no kernel has a
backward.  Attention follows the reference's rule: ``dense_attention`` up
to ``DENSE_ATTN_MAX_SEQ`` tokens and ``chunked_attention`` (recompute
backward) above; the MoE experts are the reference's einsums, each
512-token chunk checkpointed (``models.moe``); ``cfg.remat`` recomputes
each layer in the backward (``torch.utils.checkpoint``), as
``jax.checkpoint(nothing_saveable)`` does, with the chunks' checkpoints
nested inside.  A MoE ``train_loss`` adds the reference's
``0.01 * moe_aux_loss + 1e-3 * moe_z_loss``.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import resolve_device

from . import attention as attn
from . import moe as moe_mod
from .attention import DENSE_ATTN_MAX_SEQ
from .layers import (apply_rope, embed, embed_spec, rmsnorm, rmsnorm_spec,
                     softmax_xent, swiglu, swiglu_spec, unembed)
from .params import (P, abstract_params, init_params, logical_axes,
                     stack_layer_specs, unstack)

FAMILIES = ("dense", "moe", "vlm")


class DecoderLM:
    """dense / moe / vlm decoder LM built from an ArchConfig; parameters and
    caches live on ``device`` (``"cuda"`` by default; raises without a
    card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        if cfg.family not in FAMILIES:
            raise ValueError(
                f"{cfg.name}: DecoderLM takes the families {FAMILIES}, not "
                f"{cfg.family!r} (build it with models.build_model)")
        self.cfg = cfg
        self.is_moe = cfg.n_experts > 0
        self.is_vlm = cfg.n_patches > 0
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        # optional sharding constrainers (``sharding.rules``), set by a
        # caller that trains on a mesh; None computes as without them
        self.constrain_act = None
        self.constrain_q = None
        self.constrain_kv = None
        self.constrain_moe = None

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

    def abstract_params(self) -> Dict:
        """The parameter tree as ``meta`` tensors in the config's dtype."""
        return abstract_params(self.param_specs(), self.dtype)

    def param_logical_axes(self) -> Dict:
        return logical_axes(self.param_specs())

    # -- forward -------------------------------------------------------------
    def _ffn(self, lp: Dict, h: torch.Tensor, train: bool = False
             ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        c = self.cfg
        if self.is_moe:
            return moe_mod.moe_apply(lp["moe"], h, top_k=c.top_k,
                                     capacity_factor=c.capacity_factor,
                                     train=train,
                                     constrain=self.constrain_moe)
        return swiglu(lp["mlp"], h), {}

    def _block(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
               train: bool
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        c = self.cfg
        h = rmsnorm(lp["ln1"], x, c.norm_eps)
        q, k, v = attn.project_qkv(lp["attn"], h)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        if self.constrain_q is not None:
            # k and v are the unexpanded (B,S,K,D): the port never
            # expands kv heads
            q = self.constrain_q(q)
            k = self.constrain_kv(k)
            v = self.constrain_kv(v)
        o = attn.sequence_attention(q, k, v, causal=True, window=c.window,
                                    train=train)
        x = x + attn.project_out(lp["attn"], o)
        h = rmsnorm(lp["ln2"], x, c.norm_eps)
        y, aux = self._ffn(lp, h, train)
        return x + y, aux

    def forward(self, params: Dict, tokens: torch.Tensor,
                extras: Optional[Dict] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        """Full-sequence logits: tokens (B,S) -> (B,S,V) f32, and the MoE
        metrics averaged over layers ({} for the other families).  A VLM
        reads ``extras["patch_embeds"]`` (B,P,d), P <= S.

        ``train=False`` (prefill) runs the flash-attention and
        grouped-matmul kernels, which have no backward; ``train=True`` runs
        the differentiable plain attention and expert einsums and, with
        ``cfg.remat``, recomputes each layer in the backward.  The MoE
        metrics are each layer's summed and divided by the layer count,
        as the reference's scan does."""
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
        cst = self.constrain_act or (lambda t: t)
        x = cst(x)
        aux = {}
        for lp in unstack(params["blocks"], c.n_layers):
            if train and c.remat:
                x, layer_aux = checkpoint(self._block, lp, x, positions, True,
                                          use_reentrant=False)
            else:
                x, layer_aux = self._block(lp, x, positions, train)
            x = cst(x)
            for k, v in layer_aux.items():
                aux[k] = aux.get(k, 0.0) + v.float()
        aux = {k: v / c.n_layers for k, v in aux.items()}
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), aux

    # -- losses --------------------------------------------------------------
    def train_loss(self, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy of ``batch["tokens"]`` (B,S) under
        ``batch["loss_mask"]`` (B,S) where given; a VLM without a mask
        scores the text positions only.  Returns (loss, {"xent", "loss"}),
        and for MoE the loss adds ``0.01 * moe_aux_loss + 1e-3 *
        moe_z_loss`` and the metrics carry the three MoE metrics."""
        tokens = batch["tokens"]
        logits, aux = self.forward(params, tokens, batch, train=True)
        targets = tokens[:, 1:]
        mask = batch.get("loss_mask")
        mask = mask[:, 1:] if mask is not None else None
        if self.is_vlm and mask is None:
            pos = torch.arange(targets.shape[1], device=tokens.device)[None]
            mask = (pos >= self.cfg.n_patches).float()
        loss = softmax_xent(logits[:, :-1], targets, mask)
        metrics = {"xent": loss}
        if self.is_moe:
            loss = loss + 0.01 * aux["moe_aux_loss"] + 1e-3 * aux["moe_z_loss"]
            metrics.update(aux)
        metrics["loss"] = loss
        return loss, metrics

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
        for i, lp in enumerate(unstack(params["blocks"], c.n_layers)):
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

    def cache_specs(self, batch: int, seq_len: int) -> Dict:
        """The reference's stacked cache spec as ``meta`` tensors: k and v
        (L,B,T,K,D), ``pos`` (L,) int32."""
        c = self.cfg
        return attn.stack_specs(attn.cache_specs(
            batch, self._cache_len(seq_len), c.n_kv_heads,
            c.resolved_head_dim, self.dtype), c.n_layers)

    # -- shape plumbing ------------------------------------------------------
    def input_specs(self, shape: ShapeConfig) -> Dict:
        """The step's inputs for ``shape`` as ``meta`` tensors."""
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": attn.token_spec(B, 1),
                    "cache": self.cache_specs(B, S)}
        specs = {"tokens": attn.token_spec(B, S)}
        if self.is_vlm:
            specs["patch_embeds"] = torch.empty(
                (B, c.n_patches, c.d_model), dtype=self.dtype, device="meta")
        return specs

    def input_logical_axes(self, shape: ShapeConfig) -> Dict:
        if shape.kind == "decode":
            return {"tokens": ("batch", None),
                    "cache": dict(attn.KV_CACHE_AXES)}
        axes = {"tokens": ("batch", "seq")}
        if self.is_vlm:
            axes["patch_embeds"] = ("batch", "patches", "d_model")
        return axes

    # -- batches -------------------------------------------------------------
    def make_batch(self, generator: torch.Generator, shape: ShapeConfig
                   ) -> Dict:
        """Random inputs of ``shape`` on this model's device, drawn from
        ``generator``: decode gives (B,1) tokens and a fresh cache of
        ``shape.seq_len``; the other kinds (B,S) tokens and, for a VLM,
        patch embeddings at the token embedding's scale."""
        batch = random_tokens(self, generator, shape)
        if self.is_vlm and shape.kind != "decode":
            c = self.cfg
            batch["patch_embeds"] = 0.02 * torch.randn(
                (shape.global_batch, c.n_patches, c.d_model),
                generator=generator, device=self.device).to(self.dtype)
        return batch


def random_tokens(model, generator: torch.Generator,
                  shape: ShapeConfig) -> Dict:
    """The tokens every family's ``make_batch`` draws: (B,1) and a fresh
    cache for a decode shape, else (B,S)."""
    B, S = shape.global_batch, shape.seq_len
    n = 1 if shape.kind == "decode" else S
    tokens = torch.randint(0, model.cfg.vocab, (B, n), generator=generator,
                           device=model.device, dtype=torch.int32)
    if shape.kind == "decode":
        return {"tokens": tokens, "cache": model.init_cache(B, S)}
    return {"tokens": tokens}


__all__ = ["DecoderLM", "DENSE_ATTN_MAX_SEQ", "random_tokens"]
