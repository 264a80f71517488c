"""Gradient compression for the data-parallel all-reduce (int8 + error
feedback): the port of ``repro.train.compression`` over a
``torch.distributed`` process group (gloo on the CPU, NCCL on the card).

Each data-parallel rank quantizes its local gradient to int8 with a
per-row scale, all-reduces the codes (a quarter of f32's bytes on the
wire, widened to int32 for the sum), dequantizes to the mean, and keeps
the quantization residual locally as *error feedback*, added to the next
step's gradient: the standard EF-SGD recipe, which keeps the applied
update unbiased over steps.  The per-row scale is shared first (an
all-reduce MAX of each row's amax), so the sum of the codes is exact in
the quantized domain.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_leaves, tree_map, tree_unflatten
from repro_torch.train.optimizer import divide


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """f32 ``x`` -> (int8 codes, f32 scale per row of the last axis):
    ``scale = max(amax, 1e-12) / 127``, codes rounded half to even and
    clipped to +-127; a 0-d ``x`` is one row of one."""
    if x.dim() == 0:
        x = x[None]
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = divide(torch.clamp(amax, min=1e-12), 127.0)
    q = torch.clamp(torch.round(x / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def compress_leaf(g: torch.Tensor, err: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One EF round on a local leaf: returns (g_compressed, new_err)."""
    g32 = g.float() + err
    q, scale = quantize_int8(g32)
    deq = dequantize_int8(q, scale).reshape(g32.shape)
    return deq.to(g.dtype), g32 - deq


@torch.no_grad()
def compressed_psum_grads(grads: Any, errors: Any, group=None
                          ) -> Tuple[Any, Any]:
    """int8-compress each rank's local gradients (+ error feedback) and
    all-reduce them over ``group`` (the default group for None): returns
    (the mean gradient, each leaf in its own dtype; the new local
    residuals, f32).  Every rank of the group must call it with trees of
    the same shapes."""
    n = float(dist.get_world_size(group))

    def one(g, e):
        g32 = g.float() + e
        amax = g32.abs().amax(dim=-1, keepdim=True)
        dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group)
        scale = divide(torch.clamp(amax, min=1e-12), 127.0)
        q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group)
        deq = divide(summed.float() * scale, n)        # the mean gradient
        new_e = g32 - q.float() * scale                # local EF residual
        return deq.to(g.dtype), new_e

    out = [one(g, e) for g, e in zip(tree_leaves(grads),
                                     tree_leaves(errors))]
    return (tree_unflatten(grads, [o[0] for o in out]),
            tree_unflatten(grads, [o[1] for o in out]))


def init_error_feedback(params: Any) -> Any:
    """f32 zeros shaped like ``params``, on their devices."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


__all__ = ["quantize_int8", "dequantize_int8", "compress_leaf",
           "compressed_psum_grads", "init_error_feedback"]
