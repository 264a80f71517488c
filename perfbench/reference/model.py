"""The plain reference: the benchmark's configurations' decoder in f32.

Plain PyTorch, written from the configuration files alone: it imports
nothing of the program.  Parameters come in the tree the benchmark makes
them in (``perfbench.weights``), as stored (bf16); every product is
computed in f32 with TF32 off.  The block is the port's, with its
departures from the published models listed in each configuration's file:
pre-norm RMSNorm, q/k/v without bias, RoPE over whole heads (the two
halves rotated), causal softmax attention, a SwiGLU FFN or top-k experts
(softmax router, the k highest renormalised, ties to the lower index),
a final RMSNorm and logits against the tied embedding.

``quant`` is the control: "fp8" rounds both inputs of every weight
product, and every cached K and V, to float8 e4m3 (a scale per row of
activations, per output column of weights, per cached row), the
precision below the configurations' bf16.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0


@contextlib.contextmanager
def exact_f32():
    """TF32 off for the block, restored after it."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """``x`` rounded to e4m3 with one scale per slice along ``dim`` (the
    slice's largest magnitude maps to 448), back in f32; gradients pass
    straight through."""
    amax = x.detach().abs().amax(dim=dim, keepdim=True).clamp_min(1e-12)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


class Reference:
    """f32 forward (and, with autograd, backward) of one configuration."""

    def __init__(self, config: Dict, params: Dict,
                 quant: Optional[str] = None):
        if quant not in (None, "fp8"):
            raise ValueError(f"quant must be None or 'fp8', got {quant!r}")
        self.c = config
        self.p = params
        self.quant = quant
        self.moe = bool(config.get("n_experts"))
        self._unembed: Optional[torch.Tensor] = None

    # -- pieces ---------------------------------------------------------------
    def w(self, t: torch.Tensor) -> torch.Tensor:
        """A weight as f32 (rounded to fp8 under the control, with one
        scale per output column: the last axis)."""
        t = t.float()
        return fp8(t, dim=-2) if self.quant else t

    def a(self, t: torch.Tensor) -> torch.Tensor:
        """An activation entering a weight product."""
        return fp8(t, dim=-1) if self.quant else t

    def mm(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., n) @ w (n, m) with ``w`` as stored."""
        return self.a(x) @ self.w(w)

    def rmsnorm(self, x: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
        var = (x * x).mean(dim=-1, keepdim=True)
        return x * torch.rsqrt(var + self.c["norm_eps"]) * scale.float()

    def rope(self, x: torch.Tensor, pos: torch.Tensor) -> torch.Tensor:
        """x (S, heads, D) at absolute positions ``pos`` (S,)."""
        half = x.shape[-1] // 2
        exponent = torch.arange(half, dtype=torch.float32,
                                device=x.device) / half
        freqs = 1.0 / (self.c["rope_theta"] ** exponent)
        ang = pos.float()[:, None] * freqs
        cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)

    def qkv(self, lp: Dict, h: torch.Tensor, pos: torch.Tensor):
        c = self.c
        hd = c["head_dim"]

        def proj(w):
            return self.mm(h, w.reshape(w.shape[0], -1)).unflatten(
                -1, (w.shape[1], hd))
        q = self.rope(proj(lp["wq"]), pos)
        k = self.rope(proj(lp["wk"]), pos)
        v = proj(lp["wv"])
        if self.quant:
            k, v = fp8(k, dim=-1), fp8(v, dim=-1)
        return q, k, v

    def attend(self, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               q_pos: torch.Tensor, k_pos: torch.Tensor,
               block: int = 1024) -> torch.Tensor:
        """Causal attention of q (S, H, D) over k and v (T, K, D) at the
        given positions, in query blocks of ``block``: (S, H, D)."""
        H, K = q.shape[1], k.shape[1]
        G = H // K
        kk = k.repeat_interleave(G, dim=1).transpose(0, 1)      # (H, T, D)
        vv = v.repeat_interleave(G, dim=1).transpose(0, 1)
        scale = q.shape[-1] ** -0.5
        out = []
        for s in range(0, q.shape[0], block):
            qb = q[s:s + block].transpose(0, 1)                 # (H, s, D)
            scores = (qb @ kk.transpose(1, 2)) * scale
            mask = k_pos[None, :] > q_pos[s:s + block, None]
            scores = scores.masked_fill(mask[None], float("-inf"))
            out.append((torch.softmax(scores, dim=-1) @ vv).transpose(0, 1))
        return torch.cat(out, dim=0)

    def ffn(self, lp: Dict, h: torch.Tensor) -> torch.Tensor:
        """h (N, d) -> (N, d): SwiGLU, or the top-k experts of each token."""
        if not self.moe:
            m = lp["mlp"]
            return self.mm(F.silu(self.mm(h, m["w_gate"]))
                           * self.mm(h, m["w_up"]), m["w_down"])
        m = lp["moe"]
        probs = torch.softmax(h @ m["router"].float(), dim=-1)
        gates, experts = torch.sort(probs, dim=-1, descending=True,
                                    stable=True)
        k = self.c["top_k"]
        gates, experts = gates[:, :k], experts[:, :k]
        gates = gates / gates.sum(-1, keepdim=True)
        out = torch.zeros_like(h)
        for e in range(m["w_gate"].shape[0]):
            tok, slot = torch.nonzero(experts == e, as_tuple=True)
            if tok.numel() == 0:
                continue
            x = h[tok]
            y = self.mm(F.silu(self.mm(x, m["w_gate"][e]))
                        * self.mm(x, m["w_up"][e]), m["w_down"][e])
            out.index_add_(0, tok, y * gates[tok, slot, None])
        return out

    def logits(self, x: torch.Tensor) -> torch.Tensor:
        """Final hidden states (N, d) -> f32 logits (N, V); the (tied)
        unembedding is made f32 once, not for every block of rows."""
        if self._unembed is None or torch.is_grad_enabled():
            w = self.w(self.p["embed"]["embedding"].t())
            if torch.is_grad_enabled():
                return self.a(x) @ w
            self._unembed = w
        return self.a(x) @ self._unembed

    def final(self, x: torch.Tensor) -> torch.Tensor:
        return self.rmsnorm(x, self.p["ln_f"]["scale"])

    def layer(self, i: int) -> Dict:
        return _index(self.p["blocks"], i)

    # -- serving: rows of tokens after an optional cached prefix ---------------
    def serve_hidden(self, rows: List[Dict]) -> List[torch.Tensor]:
        """Final hidden states of each row's tokens.  A row is ``tokens``
        (S,) at positions ``start .. start+S-1`` after, where ``start`` >
        0, a prefix of ``start`` cached positions whose (already rotated)
        keys and values ``prefix_k``/``prefix_v`` (L, start, K, D) are
        given.  Layer by layer, every row at once."""
        emb = self.p["embed"]["embedding"]
        xs = [emb[r["tokens"]].float() for r in rows]
        pos = [torch.arange(r["start"], r["start"] + len(r["tokens"]),
                            device=emb.device) for r in rows]
        for i in range(self.c["n_layers"]):
            lp = self.layer(i)
            for j, r in enumerate(rows):
                h = self.rmsnorm(xs[j], lp["ln1"]["scale"])
                q, k, v = self.qkv(lp["attn"], h, pos[j])
                kp = pos[j]
                if r["start"]:
                    pk, pv = r["prefix_k"][i].float(), r["prefix_v"][i].float()
                    if self.quant:
                        pk, pv = fp8(pk, dim=-1), fp8(pv, dim=-1)
                    k, v = torch.cat([pk, k]), torch.cat([pv, v])
                    kp = torch.arange(0, kp[-1] + 1, device=kp.device)
                o = self.attend(q, k, v, pos[j], kp)
                wo = lp["attn"]["wo"]
                xs[j] = xs[j] + self.mm(o.flatten(1),
                                        wo.reshape(-1, wo.shape[-1]))
            n = [len(x) for x in xs]
            h = self.rmsnorm(torch.cat(xs), lp["ln2"]["scale"])
            xs = [x + y for x, y in zip(xs, self.ffn(lp, h).split(n))]
        return [self.final(x) for x in xs]

    # -- training ---------------------------------------------------------------
    def train_loss(self, tokens: torch.Tensor, remat: bool = True
                   ) -> torch.Tensor:
        """Mean next-token cross-entropy of ``tokens`` (B, S), every
        position scored; each layer recomputed in the backward."""
        B, S = tokens.shape
        emb = self.p["embed"]["embedding"]
        x = emb[tokens.long()].float()
        pos = torch.arange(S, device=tokens.device)

        def block(x, lp):
            rows = []
            for b in range(B):
                h = self.rmsnorm(x[b], lp["ln1"]["scale"])
                q, k, v = self.qkv(lp["attn"], h, pos)
                o = self.attend(q, k, v, pos, pos)
                wo = lp["attn"]["wo"]
                rows.append(self.mm(o.flatten(1),
                                    wo.reshape(-1, wo.shape[-1])))
            x = x + torch.stack(rows)
            h = self.rmsnorm(x, lp["ln2"]["scale"])
            return x + self.ffn(lp, h.flatten(0, 1)).view_as(x)

        for lp in _unbind(self.p["blocks"], self.c["n_layers"]):
            x = (checkpoint(block, x, lp, use_reentrant=False) if remat
                 else block(x, lp))
        logits = self.logits(self.final(x))[:, :-1]
        targets = tokens[:, 1:].long()
        return (torch.logsumexp(logits, dim=-1)
                - logits.gather(-1, targets[..., None])[..., 0]).mean()


def _index(tree, i: int):
    if isinstance(tree, dict):
        return {k: _index(v, i) for k, v in tree.items()}
    return tree[i]


def _unbind(tree, n: int) -> List[Dict]:
    """The stacked layers as ``n`` trees, each leaf split once (whose
    backward is one stack, not a zero-filled stack per layer)."""
    def split(t):
        if isinstance(t, dict):
            return {k: split(v) for k, v in t.items()}
        return torch.unbind(t, 0)

    def pick(t, i):
        if isinstance(t, dict):
            return {k: pick(v, i) for k, v in t.items()}
        return t[i]
    parts = split(tree)
    return [pick(parts, i) for i in range(n)]


__all__ = ["Reference", "exact_f32", "fp8", "FP8_MAX"]
