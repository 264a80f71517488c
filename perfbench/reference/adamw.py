"""The reference's optimizer: AdamW as the configuration states it.

f32 moments; gradients clipped by their global norm; a linear warm-up
then a cosine decay to ``min_lr_ratio`` of the peak; decoupled weight
decay on every leaf; the update computed in f32 and each parameter
stored back in its own dtype (bf16 here: no f32 master copy).  Written
from the optimizer's settings, not from the program.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch


def lr_at(opt: Dict, step: int) -> float:
    warm = min(step / max(opt["warmup_steps"], 1), 1.0)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0),
               1.0)
    cos = 0.5 * (1.0 + math.cos(math.pi * frac))
    return opt["peak_lr"] * warm * (opt["min_lr_ratio"]
                                    + (1 - opt["min_lr_ratio"]) * cos)


class AdamW:
    def __init__(self, params: List[torch.Tensor], opt: Dict):
        self.params = params
        self.opt = opt
        self.m = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.v = [torch.zeros_like(p, dtype=torch.float32) for p in params]
        self.step = 0

    @torch.no_grad()
    def update(self, grads: List[torch.Tensor]) -> None:
        o = self.opt
        self.step += 1
        gnorm = torch.sqrt(sum(g.float().square().sum() for g in grads))
        clip = torch.clamp(o["clip_norm"] / torch.clamp(gnorm, min=1e-9),
                           max=1.0)
        lr = lr_at(o, self.step)
        bc1 = 1.0 - o["b1"] ** self.step
        bc2 = 1.0 - o["b2"] ** self.step
        for p, g, m, v in zip(self.params, grads, self.m, self.v):
            g = g.float() * clip
            m.mul_(o["b1"]).add_((1 - o["b1"]) * g)
            v.mul_(o["b2"]).add_((1 - o["b2"]) * g * g)
            p32 = p.float()
            delta = (m / bc1) / (torch.sqrt(v / bc2) + o["eps"]) \
                + o["weight_decay"] * p32
            p.copy_(p32 - lr * delta)


__all__ = ["AdamW", "lr_at"]
