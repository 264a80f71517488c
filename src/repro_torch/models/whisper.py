"""Whisper-style encoder-decoder backbone (the audio frontend is a stub):
the port of ``repro.models.whisper``'s ``WhisperModel``.

``extras["frames"]`` (B, frames, d_model) are precomputed frame
embeddings, the conv frontend's output.  The encoder adds sinusoidal
positions and runs non-causal self-attention; the decoder adds sinusoidal
positions to its token embeddings and runs causal self-attention and
cross-attention over the encoder's output; LayerNorm and GELU MLPs, biased
q, v and out projections, logits against the tied embedding.  Parameters
keep the reference's tree (stacked ``enc_blocks`` and ``dec_blocks``).

Prefill runs the hand-written flash-attention kernel for all three
attentions: non-causal over the frames in the encoder, causal in the
decoder, and non-causal with S queries against the encoder's F keys for
cross-attention.  Decode runs the flash-decode kernel for self-attention
(unrotated, over a linear cache) and for cross-attention over every frame
of ``cache["cross"]``, which holds the zeros of ``init_cache`` as in the
reference (neither package fills it from an encoder pass).  On the CPU
each kernel runs its plain version.  Training (``train=True``) runs the
reference's plain attention: ``dense_attention``, and
``chunked_attention`` for decoder self-attention above
``DENSE_ATTN_MAX_SEQ`` tokens.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import resolve_device

from . import attention as attn
from .layers import (embed, embed_spec, gelu_mlp, gelu_mlp_spec, layernorm,
                     layernorm_spec, sinusoidal_positions, softmax_xent,
                     unembed)
from .params import (abstract_params, init_params, logical_axes,
                     stack_layer_specs, unstack)
from .transformer import random_tokens


class WhisperModel:
    """Whisper built from an ArchConfig; parameters and caches live on
    ``device`` (``"cuda"`` by default; raises without a card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        self.n_enc = cfg.enc_layers or cfg.n_layers
        self.n_dec = cfg.n_layers
        # optional sharding constrainers (``sharding.rules``); None
        # computes as without them
        self.constrain_act = None
        self.constrain_q = None
        self.constrain_kv = None

    # -- specs ---------------------------------------------------------------
    def _gqa_spec(self) -> Dict:
        c = self.cfg
        return attn.gqa_spec(c.d_model, c.n_heads, c.n_kv_heads,
                             c.resolved_head_dim, bias=True)

    def param_specs(self) -> Dict:
        c = self.cfg
        enc = {"ln1": layernorm_spec(c.d_model), "attn": self._gqa_spec(),
               "ln2": layernorm_spec(c.d_model),
               "mlp": gelu_mlp_spec(c.d_model, c.d_ff)}
        dec = {"ln1": layernorm_spec(c.d_model),
               "self_attn": self._gqa_spec(),
               "ln_x": layernorm_spec(c.d_model),
               "cross_attn": self._gqa_spec(),
               "ln2": layernorm_spec(c.d_model),
               "mlp": gelu_mlp_spec(c.d_model, c.d_ff)}
        return {"embed": embed_spec(c.vocab, c.d_model),
                "enc_blocks": stack_layer_specs(enc, self.n_enc),
                "enc_ln": layernorm_spec(c.d_model),
                "dec_blocks": stack_layer_specs(dec, self.n_dec),
                "dec_ln": layernorm_spec(c.d_model)}

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

    def _layer(self, fn, lp: Dict, *args):
        """One block, recomputed in the backward when training under
        ``cfg.remat`` (``args[-1]`` is ``train``)."""
        if args[-1] and self.cfg.remat:
            return checkpoint(fn, lp, *args, use_reentrant=False)
        return fn(lp, *args)

    # -- encoder -------------------------------------------------------------
    def _enc_block(self, lp: Dict, h: torch.Tensor,
                   train: bool) -> torch.Tensor:
        eps = self.cfg.norm_eps
        q, k, v = attn.project_qkv(lp["attn"], layernorm(lp["ln1"], h, eps))
        o = attn.sequence_attention(q, k, v, causal=False, train=train)
        h = h + attn.project_out(lp["attn"], o)
        return h + gelu_mlp(lp["mlp"], layernorm(lp["ln2"], h, eps))

    def encode(self, params: Dict, frames: torch.Tensor,
               train: bool = False) -> torch.Tensor:
        """frames (B,F,d) -> the encoder's output (B,F,d)."""
        c = self.cfg
        F_ = frames.shape[1]
        x = frames.to(self.dtype) + sinusoidal_positions(
            F_, c.d_model, frames.device).to(self.dtype)[None]
        for lp in unstack(params["enc_blocks"], self.n_enc):
            x = self._layer(self._enc_block, lp, x, train)
        return layernorm(params["enc_ln"], x, c.norm_eps)

    # -- decoder (full sequence: train / prefill) ----------------------------
    def _dec_block(self, lp: Dict, h: torch.Tensor, enc_out: torch.Tensor,
                   train: bool) -> torch.Tensor:
        eps = self.cfg.norm_eps
        q, k, v = attn.project_qkv(lp["self_attn"],
                                   layernorm(lp["ln1"], h, eps))
        o = attn.sequence_attention(q, k, v, causal=True, train=train)
        h = h + attn.project_out(lp["self_attn"], o)
        q, k, v = attn.project_qkv(lp["cross_attn"],
                                   layernorm(lp["ln_x"], h, eps), enc_out)
        o = attn.sequence_attention(q, k, v, causal=False, train=train)
        h = h + attn.project_out(lp["cross_attn"], o)
        return h + gelu_mlp(lp["mlp"], layernorm(lp["ln2"], h, eps))

    def forward(self, params: Dict, tokens: torch.Tensor, extras: Dict,
                train: bool = False) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,S) and ``extras["frames"]`` (B,F,d) -> (logits (B,S,V)
        f32, {}).  ``train=False`` (prefill) runs the flash-attention
        kernel; ``train=True`` the differentiable plain attention."""
        c = self.cfg
        S = tokens.shape[1]
        enc_out = self.encode(params, extras["frames"], train)
        x = embed(params["embed"], tokens, self.dtype) + sinusoidal_positions(
            S, c.d_model, tokens.device).to(self.dtype)[None]
        cst = self.constrain_act or (lambda t: t)
        x = cst(x)
        for lp in unstack(params["dec_blocks"], self.n_dec):
            x = cst(self._layer(self._dec_block, lp, x, enc_out, train))
        x = layernorm(params["dec_ln"], x, c.norm_eps)
        return unembed(params["embed"], x), {}

    def train_loss(self, params: Dict, batch: Dict
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """Next-token cross-entropy of ``batch["tokens"]`` over every
        position (the reference takes no mask here), given
        ``batch["frames"]``: (loss, {"loss", "xent"})."""
        tokens = batch["tokens"]
        logits, _ = self.forward(params, tokens, batch, train=True)
        loss = softmax_xent(logits[:, :-1], tokens[:, 1:])
        return loss, {"loss": loss, "xent": loss}

    # -- decode --------------------------------------------------------------
    def init_cache(self, batch: int, seq_len: int) -> Dict:
        """{"self": k and v (L,B,seq_len,K,D) and the shared host int
        ``pos``; "cross": k and v (L,B,F,K,D) zeros}."""
        c = self.cfg
        kv = (c.n_kv_heads, c.resolved_head_dim)

        def zeros(T):
            return torch.zeros((self.n_dec, batch, T) + kv, dtype=self.dtype,
                               device=self.device)

        return {"self": {"k": zeros(seq_len), "v": zeros(seq_len), "pos": 0},
                "cross": {"k": zeros(c.enc_frames),
                          "v": zeros(c.enc_frames)}}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) -> logits (B,1,V), cache with pos + 1 (the self
        cache's k and v are written in place)."""
        c = self.cfg
        eps = c.norm_eps
        sc, cross = cache["self"], cache["cross"]
        pos = sc["pos"]
        # the sinusoidal position of this step (the linear cache's writes
        # clamp past its end; the position does not)
        x = embed(params["embed"], tokens, self.dtype) + sinusoidal_positions(
            1, c.d_model, self.device, first=pos).to(self.dtype)[None]
        F_ = cross["k"].shape[2]
        for i, lp in enumerate(unstack(params["dec_blocks"], self.n_dec)):
            o, _ = attn.decode_attention(
                lp["self_attn"], {"k": sc["k"][i], "v": sc["v"][i],
                                  "pos": pos},
                layernorm(lp["ln1"], x, eps), use_rope=False)
            x = x + o
            q = attn.project_q(lp["cross_attn"], layernorm(lp["ln_x"], x,
                                                           eps))
            x = x + attn.cache_attention(lp["cross_attn"], q,
                                         cross["k"][i], cross["v"][i], F_)
            x = x + gelu_mlp(lp["mlp"], layernorm(lp["ln2"], x, eps))
        x = layernorm(params["dec_ln"], x, eps)
        return unembed(params["embed"], x), {"self": dict(sc, pos=pos + 1),
                                             "cross": cross}

    def cache_specs(self, batch: int, seq_len: int) -> Dict:
        """The reference's cache spec as ``meta`` tensors: "self" as
        ``attn.cache_specs`` over ``seq_len`` and "cross" k and v over the
        encoder's frames, each stacked over the decoder layers."""
        c = self.cfg
        kv = (c.n_kv_heads, c.resolved_head_dim)
        cross = (self.n_dec, batch, c.enc_frames) + kv
        return {"self": attn.stack_specs(attn.cache_specs(
                    batch, seq_len, *kv, self.dtype), self.n_dec),
                "cross": {k: torch.empty(cross, dtype=self.dtype,
                                         device="meta") for k in "kv"}}

    def input_specs(self, shape: ShapeConfig) -> Dict:
        c = self.cfg
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": attn.token_spec(B, 1),
                    "cache": self.cache_specs(B, S)}
        return {"tokens": attn.token_spec(B, S),
                "frames": torch.empty((B, c.enc_frames, c.d_model),
                                      dtype=self.dtype, device="meta")}

    def input_logical_axes(self, shape: ShapeConfig) -> Dict:
        if shape.kind == "decode":
            cross = {k: ("layers", "batch", "frames", "kv_heads",
                         "head_dim") for k in "kv"}
            return {"tokens": ("batch", None),
                    "cache": {"self": dict(attn.KV_CACHE_AXES),
                              "cross": cross}}
        return {"tokens": ("batch", "seq"),
                "frames": ("batch", "frames", "d_model")}

    def make_batch(self, generator: torch.Generator, shape: ShapeConfig
                   ) -> Dict:
        """Random tokens of ``shape`` from ``generator``; a decode shape
        adds a fresh cache of ``shape.seq_len``, the others frames of
        0.02 N(0, 1) at (B, enc_frames, d_model)."""
        batch = random_tokens(self, generator, shape)
        if shape.kind != "decode":
            c = self.cfg
            batch["frames"] = (0.02 * torch.randn(
                (shape.global_batch, c.enc_frames, c.d_model),
                generator=generator, device=self.device)).to(self.dtype)
        return batch


__all__ = ["WhisperModel"]
