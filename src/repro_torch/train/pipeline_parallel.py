"""GPipe-style pipeline parallelism over a ``torch.distributed`` process
group: the port of ``repro.train.pipeline_parallel``.

The layer stack is split into S contiguous stages, one per rank of the
group; M microbatches stream through them in M + S - 1 ticks, stage s
working on microbatch t - s at tick t, and each activation goes to the
next stage by point-to-point ``isend``/``recv`` (the reference's
``ppermute``).  Schedule: plain GPipe (fill S - 1 bubbles, then steady
state), bubble fraction (S - 1)/(M + S - 1).  The last stage's outputs
are broadcast to every rank, which stands for the reference's masked
``psum``.  Forward only, as in the reference.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from repro_torch.models.params import tree_map


def _global_rank(group, rank: int) -> int:
    return rank if group is None else dist.get_global_rank(group, rank)


def pipeline_forward(stage_fn: Callable, n_stages: int, n_microbatches: int,
                     group=None) -> Callable:
    """Build a pipelined forward: ``(stage_params, x) -> y``, with x and
    y (M, mb, ...) on every rank of ``group`` (the default group for
    None), which has one rank per stage.

    ``stage_fn(stage_params, h)`` applies one stage's layers to a
    microbatch and keeps its shape and dtype; each rank passes its own
    stage's parameters (``stack_stage_params(...)[rank]``) and the same
    x."""

    @torch.no_grad()
    def pipelined(stage_params: Any, x_mb: torch.Tensor) -> torch.Tensor:
        S, M = n_stages, n_microbatches
        if dist.get_world_size(group) != S:
            raise ValueError(f"pipeline of {S} stages on a group of "
                             f"{dist.get_world_size(group)} ranks")
        if x_mb.shape[0] != M:
            raise ValueError(f"x has {x_mb.shape[0]} microbatches, not {M}")
        stage = dist.get_rank(group)
        outputs = torch.zeros_like(x_mb)
        sends = []
        for t in range(M + S - 1):
            mb = t - stage
            if not 0 <= mb < M:
                continue
            if stage == 0:
                h = x_mb[mb]
            else:
                h = torch.empty_like(x_mb[0])
                dist.recv(h, src=_global_rank(group, stage - 1), group=group)
            y = stage_fn(stage_params, h)
            if stage < S - 1:
                y = y.contiguous()          # kept alive until sent
                sends.append((y, dist.isend(
                    y, dst=_global_rank(group, stage + 1), group=group)))
            else:
                outputs[mb] = y
        for _, req in sends:
            req.wait()
        dist.broadcast(outputs, src=_global_rank(group, S - 1), group=group)
        return outputs

    return pipelined


def stack_stage_params(layer_params: Any, n_stages: int) -> Any:
    """(L, ...) layer-stacked params -> (S, L/S, ...) stage-stacked."""
    def resh(p):
        L = p.shape[0]
        return p.reshape((n_stages, L // n_stages) + tuple(p.shape[1:]))

    return tree_map(resh, layer_params)


__all__ = ["pipeline_forward", "stack_stage_params"]
