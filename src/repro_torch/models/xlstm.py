"""xLSTM stack, alternating mLSTM (matrix memory) and sLSTM (scalar memory)
blocks: the port of ``repro.models.xlstm``'s ``XLSTMModel``.  The
24-layer config runs as 12 (mLSTM, sLSTM) pairs under the stacked
``pairs`` tree; d_ff = 0, the cells carry their own projections.

Every path is plain torch (``models.ssm``) and reaches no kernel: the
reference runs these cells as XLA ops.  Decode carries O(1) states per
pair: mLSTM's C (B,H,Dh,Dh) and n (B,H,Dh), sLSTM's c, n, m, h (B,d), all
f32, updated in place.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, ShapeConfig
from repro_torch.data.pipeline import resolve_device

from . import attention as attn
from . import ssm as ssm_mod
from .layers import (embed, embed_spec, rmsnorm, rmsnorm_spec, softmax_xent,
                     unembed)
from .params import (abstract_params, init_params, logical_axes,
                     stack_layer_specs, unstack)
from .transformer import random_tokens


class XLSTMModel:
    """xLSTM built from an ArchConfig; parameters and states live on
    ``device`` (``"cuda"`` by default; raises without a card)."""

    def __init__(self, cfg: ArchConfig, device="cuda"):
        self.cfg = cfg
        self.dtype = getattr(torch, cfg.dtype)
        self.device = resolve_device(device)
        self.n_pairs = cfg.n_layers // 2
        self.head_dim = cfg.resolved_head_dim
        # optional sharding constrainers (``sharding.rules``); None
        # computes as without them
        self.constrain_act = None
        self.constrain_q = None
        self.constrain_kv = None

    # -- specs ---------------------------------------------------------------
    def pair_spec(self) -> Dict:
        c = self.cfg
        return {
            "ln_m": rmsnorm_spec(c.d_model),
            "mlstm": ssm_mod.mlstm_spec(c.d_model, c.n_heads, self.head_dim),
            "ln_s": rmsnorm_spec(c.d_model),
            "slstm": ssm_mod.slstm_spec(c.d_model, c.n_heads),
        }

    def param_specs(self) -> Dict:
        c = self.cfg
        return {"embed": embed_spec(c.vocab, c.d_model),
                "pairs": stack_layer_specs(self.pair_spec(), self.n_pairs),
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
    def _pair(self, pp: Dict, x: torch.Tensor) -> torch.Tensor:
        c = self.cfg
        mo, _ = ssm_mod.mlstm_apply(pp["mlstm"], rmsnorm(pp["ln_m"], x,
                                                         c.norm_eps))
        x = x + mo
        so, _ = ssm_mod.slstm_apply(pp["slstm"], rmsnorm(pp["ln_s"], x,
                                                         c.norm_eps))
        return x + so

    def forward(self, params: Dict, tokens: torch.Tensor,
                extras: Optional[Dict] = None, train: bool = False
                ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,S) -> (logits (B,S,V) f32, {}).  Training and prefill
        compute the same; ``train=True`` recomputes each pair in the
        backward under ``cfg.remat``."""
        c = self.cfg
        x = embed(params["embed"], tokens, self.dtype)
        cst = self.constrain_act or (lambda t: t)
        x = cst(x)
        for pp in unstack(params["pairs"], self.n_pairs):
            if train and c.remat:
                x = checkpoint(self._pair, pp, x, use_reentrant=False)
            else:
                x = self._pair(pp, x)
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
        """{"mlstm": C, n; "slstm": c, n, m, h}, each stacked over the
        pairs; ``seq_len`` sizes nothing (the states are O(1))."""
        c = self.cfg
        m = ssm_mod.mlstm_init_state(batch, c.n_heads, self.head_dim,
                                     self.device)
        s = ssm_mod.slstm_init_state(batch, c.d_model, self.device)

        def stack(t):
            return {k: v.repeat(self.n_pairs, *([1] * v.dim()))
                    for k, v in t.items()}

        return {"mlstm": stack(m), "slstm": stack(s)}

    def decode_step(self, params: Dict, cache: Dict, tokens: torch.Tensor
                    ) -> Tuple[torch.Tensor, Dict]:
        """tokens (B,1) -> logits (B,1,V), cache (its states written in
        place)."""
        c = self.cfg
        x = embed(params["embed"], tokens, self.dtype)
        ms, ss = cache["mlstm"], cache["slstm"]
        for i, pp in enumerate(unstack(params["pairs"], self.n_pairs)):
            y = rmsnorm(pp["ln_m"], x, c.norm_eps)
            mo, new_m = ssm_mod.mlstm_apply(
                pp["mlstm"], y, {k: v[i] for k, v in ms.items()})
            x = x + mo
            y = rmsnorm(pp["ln_s"], x, c.norm_eps)
            so, new_s = ssm_mod.slstm_apply(
                pp["slstm"], y, {k: v[i] for k, v in ss.items()})
            x = x + so
            for states, new in ((ms, new_m), (ss, new_s)):
                for k, v in new.items():
                    states[k][i] = v
        x = rmsnorm(params["ln_f"], x, c.norm_eps)
        return unembed(params["embed"], x), cache

    def cache_specs(self, batch: int, seq_len: int) -> Dict:
        """The reference's state spec as ``meta`` tensors (f32): "mlstm" C
        (B,H,Dh,Dh) and n, "slstm" c, n, m and h (B,d), each stacked over
        the pairs; ``seq_len`` sizes nothing."""
        c = self.cfg

        def f32(*shape):
            return torch.empty(shape, dtype=torch.float32, device="meta")

        m = {"C": f32(batch, c.n_heads, self.head_dim, self.head_dim),
             "n": f32(batch, c.n_heads, self.head_dim)}
        s = {k: f32(batch, c.d_model) for k in ("c", "n", "m", "h")}
        return {"mlstm": attn.stack_specs(m, self.n_pairs),
                "slstm": attn.stack_specs(s, self.n_pairs)}

    def input_specs(self, shape: ShapeConfig) -> Dict:
        B, S = shape.global_batch, shape.seq_len
        if shape.kind == "decode":
            return {"tokens": attn.token_spec(B, 1),
                    "cache": self.cache_specs(B, S)}
        return {"tokens": attn.token_spec(B, S)}

    def input_logical_axes(self, shape: ShapeConfig) -> Dict:
        if shape.kind == "decode":
            m = {"C": ("layers", "batch", "heads", "head_dim",
                       "head_dim_out"),
                 "n": ("layers", "batch", "heads", "head_dim")}
            s = {k: ("layers", "batch", "d_model")
                 for k in ("c", "n", "m", "h")}
            return {"tokens": ("batch", None),
                    "cache": {"mlstm": m, "slstm": s}}
        return {"tokens": ("batch", "seq")}

    def make_batch(self, generator: torch.Generator, shape: ShapeConfig
                   ) -> Dict:
        """Random tokens of ``shape`` from ``generator``, and for a decode
        shape fresh states."""
        return random_tokens(self, generator, shape)


__all__ = ["XLSTMModel"]
