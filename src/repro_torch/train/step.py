"""Serve-step builders: the port of ``repro.train.step``'s
``make_serve_step`` and ``make_prefill_step``.  The train step comes with
the trainer slice.  Both steps run without autograd: the kernels have no
backward."""

from __future__ import annotations

from typing import Any, Callable, Dict

import torch


def make_serve_step(model) -> Callable:
    """(params, cache, tokens) -> (logits, cache); the cache's k and v are
    updated in place."""

    @torch.no_grad()
    def serve_step(params: Dict, cache: Any, tokens: torch.Tensor):
        return model.decode_step(params, cache, tokens)

    return serve_step


def make_prefill_step(model) -> Callable:
    """(params, batch) -> logits (B,S,V) for ``batch["tokens"]`` (B,S);
    the rest of ``batch`` (a VLM's ``patch_embeds``) goes to the model as
    its extras."""

    @torch.no_grad()
    def prefill_step(params: Dict, batch: Dict):
        logits, _ = model.forward(params, batch["tokens"], batch)
        return logits

    return prefill_step


__all__ = ["make_serve_step", "make_prefill_step"]
