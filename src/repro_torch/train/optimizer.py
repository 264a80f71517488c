"""AdamW with f32 optimizer state, global-norm clipping and a warmup +
cosine schedule: the port of ``repro.train.optimizer``.

Trees are nested dicts of tensors under the parameter tree's keys.  The
update runs under ``torch.no_grad()`` and writes parameters and moments
in place; as in the reference there is no f32 master copy: each
parameter is updated through its f32 view and written back in its own
dtype.  Only ``state_dtype="float32"`` is ported; the int8 variants are
queued (ROADMAP A8).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Iterator, List, Tuple

import torch

from repro_torch.models.params import tree_leaves, tree_map

# A leaf above this many elements is updated in views of at most this
# many (0.5 GB of f32 per temporary): a layer-stacked weight one
# leading-axis slice at a time, as the reference's ``upd_leaf`` maps over
# it, and further down the stack (Grok-1's experts, (L, 8, 6144, 32768),
# per expert), a matrix (an embedding, one expert) in blocks of rows.  The
# update is elementwise, so the bits are those of the whole leaf's.
CHUNK_ELEMS = 1 << 27


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    peak_lr: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    # float32 is the one state type ported; int8 and int8_factored are
    # ROADMAP A8
    state_dtype: str = "float32"


def lr_at(cfg: OptimizerConfig, step: torch.Tensor) -> torch.Tensor:
    """Learning rate at ``step`` (a tensor): linear warmup, then cosine
    decay to ``min_lr_ratio * peak_lr``; f32."""
    step = torch.as_tensor(step).float()
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1.0 + torch.cos(math.pi * frac))
    return cfg.peak_lr * warm * (cfg.min_lr_ratio
                                 + (1 - cfg.min_lr_ratio) * cos)


def _parts(t: torch.Tensor) -> List[torch.Tensor]:
    """``t`` whole, or views of it of at most ``CHUNK_ELEMS`` elements:
    cut down its leading axes to matrices, and a matrix into blocks of
    rows (a single row, or a vector, stays whole)."""
    if t.numel() <= CHUNK_ELEMS or t.dim() < 2:
        return [t]
    if t.dim() == 2:
        return list(t.split(max(1, CHUNK_ELEMS // t.shape[1])))
    return [part for s in t.unbind(0) for part in _parts(s)]


def _slices(*leaves: torch.Tensor) -> Iterator[Tuple[torch.Tensor, ...]]:
    """Matching views of same-shaped leaves (``_parts``), one tuple at a
    time."""
    yield from zip(*map(_parts, leaves))


def _check_state_dtype(cfg: OptimizerConfig) -> None:
    if cfg.state_dtype != "float32":
        raise NotImplementedError(
            f"optimizer state_dtype={cfg.state_dtype!r} is not ported yet "
            "(ROADMAP A8); the port keeps float32 moments")


def adamw_init(params: Any, cfg: OptimizerConfig) -> Dict:
    """{"m", "v"} zeros in f32 shaped like ``params``, and ``step`` a 0-d
    int32 tensor, all on the parameters' device."""
    _check_state_dtype(cfg)
    zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32,  # noqa: E731
                                  device=p.device)
    device = tree_leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=device)}


@torch.no_grad()
def global_norm(tree: Any) -> torch.Tensor:
    """sqrt of the sum of every element's square, in f32."""
    total = None
    for leaf in tree_leaves(tree):
        for (part,) in _slices(leaf):
            sq = part.float().square().sum()
            total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Any, opt_state: Dict, params: Any,
                 cfg: OptimizerConfig) -> Tuple[Any, Dict, Dict]:
    """One AdamW step.  Returns (params, opt_state, stats) with
    ``stats = {"grad_norm", "lr"}``; ``params`` and the moments are the
    same tensors, updated in place, and ``step`` is a new tensor."""
    _check_state_dtype(cfg)
    step = opt_state["step"] + 1
    gnorm = global_norm(grads)
    clip = torch.clamp(cfg.clip_norm / torch.clamp(gnorm, min=1e-9), max=1.0)
    lr = lr_at(cfg, step)
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1.0 - b1 ** step.float()
    bc2 = 1.0 - b2 ** step.float()
    trees = (params, grads, opt_state["m"], opt_state["v"])
    for leaves in zip(*map(tree_leaves, trees)):
        for p, g, m, v in _slices(*leaves):
            g = g.float() * clip
            m.mul_(b1).add_((1 - b1) * g)
            v.mul_(b2).add_((1 - b2) * g * g)
            p32 = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps) \
                + cfg.weight_decay * p32
            p.copy_(p32 - lr * delta)
    stats = {"grad_norm": gnorm, "lr": lr}
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, stats


__all__ = ["OptimizerConfig", "lr_at", "adamw_init", "adamw_update",
           "global_norm", "CHUNK_ELEMS"]
