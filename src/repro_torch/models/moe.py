"""Mixture-of-Experts with sort-based, capacity-bounded dispatch: the port
of ``repro.models.moe``, with its names, parameter layout and semantics.

Per batch row (one sequence) and per chunk of the sequence: an f32 router,
softmax and top-k (renormalised gates); Switch aux and z losses; capacity
``C = ceil(S*k*cf/E)``; a stable sort of the (token, choice) pairs by
expert, rank within the expert, drop past C; one gather of the tokens into
an expert-major ``(E, B*C, d)`` buffer; the three expert products; and a
gate-weighted scatter-add back to the tokens.  Routing, sort, gather,
SiLU*up and combine are plain torch, as they are XLA in ``repro``.

Two modes share all of it but the expert products:
- serving (``train=False``, the default): each product is one launch of
  the grouped-matmul kernel (``kernels.ops.grouped_matmul``) over every
  expert; the kernel has no backward;
- training (``train=True``): the products are the reference's einsums in
  plain torch, differentiable, and with gradients on each chunk of a
  chunked sequence runs under ``torch.utils.checkpoint``, as the reference
  wraps its scan body in ``jax.checkpoint``, so the memory per chunk stays
  bounded.  The dispatch passes gradients to ``x``, the router and the
  gates as the reference's drop-mode scatters, gather and scatter-add do:
  the dropped pairs land in a last slot that is cut off, so they get none.

What differs from the reference in form, not in result:
- the buffer is expert-major ``(E, B, C)`` rather than ``(B, E, C)``, a
  permutation of the same slots, so one kernel launch covers all rows of
  an expert; the combine goes through the same index;
- ``lax.scan`` over chunks is a loop; capacity and the metrics are per
  chunk and then averaged, as in ``repro``;
- top-k is a stable descending sort, so equal probabilities pick the
  lower expert index first, as ``jax.lax.top_k`` does;
- ``constrain`` (a sharding constrainer, ``sharding.rules``) sees each
  expert buffer in the reference's ``(B, E, C, X)`` layout, a view of
  the expert-major one; None leaves the buffers as they are.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.core.spans import span
from repro_torch.kernels import ops

from .params import P

SEQ_CHUNK = 512


def moe_spec(d: int, f: int, n_experts: int) -> Dict:
    return {
        "router": P((d, n_experts), ("d_model", "experts"), scale=0.1),
        "w_gate": P((n_experts, d, f), ("experts", "d_model", "d_ff")),
        "w_up": P((n_experts, d, f), ("experts", "d_model", "d_ff")),
        "w_down": P((n_experts, f, d), ("experts", "d_ff", "d_model")),
    }


def n_chunks(S: int, seq_chunk: int = SEQ_CHUNK) -> int:
    """How many chunks ``moe_apply`` cuts a length-S sequence into."""
    return 1 if S % seq_chunk or S <= seq_chunk else S // seq_chunk


def moe_apply(params: Dict, x: torch.Tensor, *, top_k: int,
              capacity_factor: float = 1.25, seq_chunk: int = SEQ_CHUNK,
              train: bool = False, constrain=None
              ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """x: (B, S, d) -> (B, S, d), aux metrics (``moe_aux_loss``,
    ``moe_z_loss``, ``moe_dropped_frac``: 0-d f32, the mean over chunks).
    ``train`` picks the expert products: the einsums (differentiable,
    each chunk checkpointed when there are several and gradients are on)
    or the grouped-matmul kernel.  ``constrain`` (optional) is applied to
    the dispatch and expert buffers, as in the reference.  With
    ``core.spans`` on, the call is the span ``moe`` and each chunk's
    expert products ``moe.experts``: the dispatch is the rest."""
    with span("moe"):
        return _moe_chunks(params, x, top_k=top_k,
                           capacity_factor=capacity_factor,
                           seq_chunk=seq_chunk, train=train,
                           constrain=constrain)


def _moe_chunks(params: Dict, x: torch.Tensor, *, top_k: int,
                capacity_factor: float, seq_chunk: int, train: bool,
                constrain, weights: Optional[Callable] = None,
                first_expert: int = 0
                ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """``moe_apply``'s chunks.  ``weights(params)`` (the params
    themselves for None) gives the expert weights: made once, or inside
    each chunk's checkpoint, so that what it builds is rebuilt in the
    backward rather than kept to it.  Weights that hold Ew of the E
    experts, from ``first_expert`` on, compute those experts' slots."""
    weights = weights or (lambda p: p)
    n = n_chunks(x.shape[1], seq_chunk)
    remat = train and n > 1 and torch.is_grad_enabled()
    once = None if remat else weights(params)

    def chunk(xc):
        return _moe_chunk(weights(params) if remat else once, xc,
                          top_k=top_k, capacity_factor=capacity_factor,
                          train=train, constrain=constrain,
                          first_expert=first_expert)
    outs, auxs = zip(*(checkpoint(chunk, xc, use_reentrant=False) if remat
                       else chunk(xc) for xc in x.chunk(n, dim=1)))
    metrics = {k: torch.stack([a[k] for a in auxs]).mean() for k in auxs[0]}
    return torch.cat(outs, dim=1), metrics


def route(x: torch.Tensor, router: torch.Tensor, top_k: int):
    """f32 router logits (B,S,E), probabilities, and the top-k gates and
    expert indices (B,S,k), highest first, ties to the lower index."""
    logits = x.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, expert_idx = torch.sort(probs, dim=-1, descending=True,
                                       stable=True)
    return logits, probs, gate_vals[..., :top_k], expert_idx[..., :top_k]


def _experts_einsum(h: torch.Tensor, params: Dict, cst) -> torch.Tensor:
    """The expert FFNs as the reference trains them: ``becd,edf->becf``
    and ``becf,efd->becd``, here over the expert-major (E, N, d) buffer."""
    g = cst(torch.einsum("end,edf->enf", h, params["w_gate"]))
    u = cst(torch.einsum("end,edf->enf", h, params["w_up"]))
    return cst(torch.einsum("enf,efd->end", F.silu(g) * u,
                            params["w_down"]))


def _experts_kernel(h: torch.Tensor, params: Dict, cst) -> torch.Tensor:
    """The expert FFNs for serving: three grouped-matmul launches."""
    g = cst(ops.grouped_matmul(h, params["w_gate"]))
    u = cst(ops.grouped_matmul(h, params["w_up"]))
    return cst(ops.grouped_matmul(F.silu(g) * u, params["w_down"]))


def _batch_major(constrain, E: int, B: int, C: int):
    """``constrain`` applied to an expert-major (E, B*C, X) buffer through
    its (B, E, C, X) view, the reference's layout; identity for None."""
    if constrain is None:
        return lambda t: t

    def cst(t):
        t = constrain(t.view(E, B, C, -1).transpose(0, 1))
        return t.transpose(0, 1).reshape(E, B * C, -1)

    return cst


def _moe_chunk(params: Dict, x: torch.Tensor, *, top_k: int,
               capacity_factor: float, train: bool = False, constrain=None,
               first_expert: int = 0
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B, S, d = x.shape
    E = params["router"].shape[-1]
    k = top_k
    Sk = S * k
    dev = x.device

    logits, probs, gate_vals, expert_idx = route(x, params["router"], k)
    gate_vals = gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9)

    # ---- aux losses (Switch/GShard) ---------------------------------------
    flat_e = expert_idx.reshape(B, Sk)
    counts = torch.zeros((B, E), dtype=torch.long, device=dev).scatter_add_(
        1, flat_e, torch.ones_like(flat_e))
    me = probs.mean(dim=(0, 1))                                # (E,)
    ce = counts.sum(0).float() / (B * Sk)
    aux_loss = E * torch.sum(me * ce)
    z_loss = torch.mean(torch.logsumexp(logits, dim=-1) ** 2)

    # ---- per-row sort-based dispatch, inverse-mapping form ----------------
    C = max(int(-(-Sk * capacity_factor // E)), 1)
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)       # (B, Sk)
    sorted_e = flat_e.gather(1, sort_idx)
    tok = sort_idx // k                                        # source token
    starts = counts.cumsum(1) - counts                         # (B, E)
    rank = torch.arange(Sk, device=dev)[None, :] - starts.gather(1, sorted_e)
    keep = rank < C
    dest = torch.where(keep, sorted_e * C + rank, E * C)       # E*C: dropped

    # slot -> source token: scatter into E*C + 1 slots and cut the last,
    # which takes the dropped pairs.  Unfilled slots keep token 0 and are
    # zeroed by ``filled``.
    def slots(values, dtype):
        buf = torch.zeros((B, E * C + 1), dtype=dtype, device=dev)
        return buf.scatter_(1, dest, values)[:, :E * C]

    src = slots(tok, torch.long)
    filled = slots(torch.ones_like(keep), torch.bool)
    gate_slot = slots(gate_vals.reshape(B, Sk).gather(1, sort_idx),
                      torch.float32)

    # Expert-major (E, B, C) layout of the slots: one gather from x builds
    # the (E, B*C, d) buffer, and the combine adds back through the same
    # flat token index.
    def expert_major(t):
        return t.view(B, E, C).transpose(0, 1)

    # The experts these weights hold: all E, or Ew from ``first_expert``.
    Ew = params["w_gate"].shape[0]
    held = slice(first_expert, first_expert + Ew)
    token = (expert_major(src)[held]
             + S * torch.arange(B, device=dev)[None, :, None]).reshape(-1)
    mask = expert_major(filled)[held].reshape(Ew, B * C, 1)
    cst = _batch_major(constrain, Ew, B, C)
    h = cst(x.reshape(B * S, d)[token].view(Ew, B * C, d) * mask.to(x.dtype))

    experts = _experts_einsum if train else _experts_kernel
    with span("moe.experts"):
        y = experts(h, params, cst)                            # (Ew, B*C, d)

    weight = (expert_major(gate_slot)[held].reshape(Ew, B * C, 1) * mask)
    updates = (y * weight.to(x.dtype)).reshape(Ew * B * C, d)
    out = torch.zeros((B * S, d), dtype=x.dtype, device=dev).index_add_(
        0, token, updates)

    metrics = {
        "moe_aux_loss": aux_loss,
        "moe_z_loss": z_loss,
        "moe_dropped_frac": 1.0 - keep.float().mean(),
    }
    return out.view(B, S, d), metrics


__all__ = ["moe_spec", "moe_apply", "route", "n_chunks", "SEQ_CHUNK"]
