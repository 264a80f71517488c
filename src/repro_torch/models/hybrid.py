"""Hymba-style hybrid blocks, parallel attention and Mamba heads: the port
of ``repro.models.hybrid``'s ``HymbaModel`` for training, prefill and
decode.

Each block runs a sliding-window GQA attention path and a Mamba (selective
SSM) path over the same normalized input and blends them with a learned
scalar, ``sigmoid(mix)``, in f32 (the reference's simplification of the
paper's per-head fusion; meta-tokens are elided there too).  Parameters
keep the reference's tree (stacked ``blocks`` with a leading layers axis),
so a reference tree converts leaf by leaf.

Prefill attention runs the hand-written flash-attention kernel with the
window over the unexpanded (B,K,T,D) k and v; decode keeps a ring cache of
``min(window, seq_len)`` slots read by the flash-decode kernel, beside the
stacked Mamba states ``h`` (f32) and ``conv`` (the model's dtype), and one
host-int ``pos`` that every layer and slot shares.  On the CPU each kernel
runs its plain version.  Training (``train=True``) runs the reference's
plain attention (``dense_attention`` up to ``DENSE_ATTN_MAX_SEQ`` tokens,
``chunked_attention`` above) and recomputes each layer in the backward
with ``cfg.remat``.  The Mamba path is plain torch everywhere
(``models.ssm``).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import resolve_device

from . import attention as attn
from . import ssm as ssm_mod
from .layers import (apply_rope, embed, embed_spec, rmsnorm, rmsnorm_spec,
                     softmax_xent, swiglu, swiglu_spec, unembed)
from .params import (P, abstract_params, init_params, logical_axes,
                     stack_layer_specs, unstack)
from .transformer import random_tokens


class HymbaModel:
    """Hymba built from an ArchConfig; parameters and caches live on
    ``device`` (``"cuda"`` by default; raises without a card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        self.d_inner = cfg.d_model          # the Mamba path's inner width
        # optional sharding constrainers (``sharding.rules``); None
        # computes as without them
        self.constrain_act = None
        self.constrain_q = None
        self.constrain_kv = None

    # -- specs ---------------------------------------------------------------
    def block_spec(self) -> Dict:
        c = self.cfg
        return {
            "ln1": rmsnorm_spec(c.d_model),
            "attn": attn.gqa_spec(c.d_model, c.n_heads, c.n_kv_heads,
                                  c.resolved_head_dim),
            "mamba": ssm_mod.mamba_spec(c.d_model, self.d_inner, c.ssm_state),
            "mix": P((1,), (None,), init="zeros"),     # sigmoid(mix) blend
            "ln2": rmsnorm_spec(c.d_model),
            "mlp": swiglu_spec(c.d_model, c.d_ff),
        }

    def param_specs(self) -> Dict:
        c = self.cfg
        return {"embed": embed_spec(c.vocab, c.d_model),
                "blocks": stack_layer_specs(self.block_spec(), c.n_layers),
                "ln_f": rmsnorm_spec(c.d_model)}

    def init(self, generator: torch.Generator,
             dtype: Optional[torch.dtype] = None) -> Dict:
        """Random parameters from ``generator`` (on this model's device) in
        ``dtype`` (the config's by default)."""
        return init_params(self.param_specs(), generator,
                           dtype or self.dtype, self.device)

    def abstract_params(self) -> Dict:
        """The parameter tree as ``meta`` tensors in the config's dtype."""
        return abstract_params(self.param_specs(), self.dtype)

    def param_logical_axes(self) -> Dict:
        return logical_axes(self.param_specs())

    # -- forward -------------------------------------------------------------
    @staticmethod
    def _fuse(lp: Dict, ao: torch.Tensor, mo: torch.Tensor,
              dtype: torch.dtype) -> torch.Tensor:
        mix = torch.sigmoid(lp["mix"].float())[0]
        return (mix * ao.float() + (1.0 - mix) * mo.float()).to(dtype)

    def _block(self, lp: Dict, x: torch.Tensor, positions: torch.Tensor,
               train: bool) -> torch.Tensor:
        c = self.cfg
        y = rmsnorm(lp["ln1"], x, c.norm_eps)
        q, k, v = attn.project_qkv(lp["attn"], y)
        q = apply_rope(q, positions, c.rope_theta)
        k = apply_rope(k, positions, c.rope_theta)
        if self.constrain_q is not None:    # k, v unexpanded (B,S,K,D)
            q = self.constrain_q(q)
            k = self.constrain_kv(k)
            v = self.constrain_kv(v)
        ao = attn.sequence_attention(q, k, v, causal=True, window=c.window,
                                     train=train)
        ao = attn.project_out(lp["attn"], ao)
        mo, _ = ssm_mod.mamba_apply(lp["mamba"], y)
        x = x + self._fuse(lp, ao, mo, x.dtype)
        y = rmsnorm(lp["ln2"], x, c.norm_eps)
        return x + swiglu(lp["mlp"], y)

    def forward(self, params: Dict, tokens: torch.Tensor,
                extras: Optional[Dict] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,S) -> (logits (B,S,V) f32, {}).  ``train=False``
        (prefill) runs the flash-attention kernel, which has no backward;
        ``train=True`` the differentiable plain attention, each layer
        recomputed in the backward under ``cfg.remat``."""
        c = self.cfg
        B, S = tokens.shape
        x = embed(params["embed"], tokens, self.dtype)
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device).expand(B, S)
        cst = self.constrain_act or (lambda t: t)
        x = cst(x)
        for lp in unstack(params["blocks"], c.n_layers):
            if train and c.remat:
                x = checkpoint(self._block, lp, x, positions, True,
                               use_reentrant=False)
            else:
                x = self._block(lp, x, positions, train)
            x = cst(x)
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), {}

    def train_loss(self, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy of ``batch["tokens"]`` under
        ``batch["loss_mask"]`` where given: (loss, {"loss", "xent"})."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens, batch, train=True)
        mask = batch.get("loss_mask")
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:],
                            mask[:, 1:] if mask is not None else None)
        return loss, {"loss": loss, "xent": loss}

    # -- decode --------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> Dict:
        """{"kv": k and v (L,B,W,K,D) with W = min(window, seq_len) and the
        shared host int ``pos``; "mamba": h (L,B,D,N) f32 and conv
        (L,B,3,D) in the model's dtype}."""
        c = self.cfg
        L = c.n_layers
        W = min(c.window or seq_len, seq_len)
        shape = (L, batch, W, c.n_kv_heads, c.resolved_head_dim)
        ms = ssm_mod.mamba_init_state(batch, self.d_inner, c.ssm_state,
                                      dtype=self.dtype, device=self.device)
        return {"kv": {"k": torch.zeros(shape, dtype=self.dtype,
                                        device=self.device),
                       "v": torch.zeros(shape, dtype=self.dtype,
                                        device=self.device),
                       "pos": 0},
                "mamba": {k: v.repeat(L, *([1] * v.dim()))
                          for k, v in ms.items()}}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) -> logits (B,1,V), cache with pos + 1 (its tensors
        are written in place)."""
        c = self.cfg
        x = embed(params["embed"], tokens, self.dtype)
        kv, ms = cache["kv"], cache["mamba"]
        pos = kv["pos"]
        for i, lp in enumerate(unstack(params["blocks"], c.n_layers)):
            y = rmsnorm(lp["ln1"], x, c.norm_eps)
            ao, _ = attn.decode_attention(
                lp["attn"], {"k": kv["k"][i], "v": kv["v"][i], "pos": pos},
                y, window=c.window, rope_theta=c.rope_theta)
            mo, state = ssm_mod.mamba_apply(
                lp["mamba"], y, {"h": ms["h"][i], "conv": ms["conv"][i]})
            ms["h"][i] = state["h"]
            ms["conv"][i] = state["conv"]
            x = x + self._fuse(lp, ao, mo, x.dtype)
            y = rmsnorm(lp["ln2"], x, c.norm_eps)
            x = x + swiglu(lp["mlp"], y)
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), {"kv": dict(kv, pos=pos + 1),
                                             "mamba": ms}

    def cache_specs(self, batch: int, seq_len: int) -> Dict:
        """The reference's cache spec as ``meta`` tensors: "kv" as
        ``attn.cache_specs`` over min(window, seq_len) slots and "mamba"
        h (f32) and conv, each stacked over the layers."""
        c = self.cfg
        W = min(c.window or seq_len, seq_len)
        kv = attn.cache_specs(batch, W, c.n_kv_heads, c.resolved_head_dim,
                              self.dtype)
        ms = {"h": torch.empty((batch, self.d_inner, c.ssm_state),
                               dtype=torch.float32, device="meta"),
              "conv": torch.empty((batch, 3, self.d_inner),
                                  dtype=self.dtype, device="meta")}
        return {"kv": attn.stack_specs(kv, c.n_layers),
                "mamba": attn.stack_specs(ms, c.n_layers)}

    def input_specs(self, shape: ShapeConfig) -> Dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": attn.token_spec(B, 1),
                    "cache": self.cache_specs(B, S)}
        return {"tokens": attn.token_spec(B, S)}

    def input_logical_axes(self, shape: ShapeConfig) -> Dict:
        if shape.kind == "decode":
            ms = {"h": ("layers", "batch", "d_inner", "state"),
                  "conv": ("layers", "batch", "conv_k", "d_inner")}
            return {"tokens": ("batch", None),
                    "cache": {"kv": dict(attn.KV_CACHE_AXES), "mamba": ms}}
        return {"tokens": ("batch", "seq")}

    def make_batch(self, generator: torch.Generator, shape: ShapeConfig
                   ) -> Dict:
        """Random tokens of ``shape`` from ``generator``, and for a decode
        shape a fresh cache of ``shape.seq_len``."""
        return random_tokens(self, generator, shape)


__all__ = ["HymbaModel"]
