"""Train / serve step builders: the port of ``repro.train.step``.  State is
a plain dict tree: ``{"params", "opt"}``.

The train step computes gradients with autograd through
``model.train_loss`` (plain torch; no kernel has a backward) and updates
the state in place with AdamW.  The serve and prefill steps run without
autograd and through the kernels.  ``abstract_state`` (``meta`` tensors)
and ``state_logical_axes`` describe the state without building it, for
``sharding.rules.tree_shardings``.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch

from repro_torch.core.spans import span
from repro_torch.models.params import tree_leaves, tree_unflatten

from .optimizer import (OptimizerConfig, abstract_opt_state, adamw_init,
                        adamw_update, opt_state_logical_axes)


def make_train_step(model, opt_cfg: OptimizerConfig, microbatches: int = 1,
                    accum_dtype: torch.dtype = torch.float32) -> Callable:
    """(state, batch) -> (state, metrics).  The state's tensors are updated
    in place (the reference donates them).

    ``microbatches > 1`` accumulates gradients: the batch is split along
    dim 0, each part's gradients are added in ``accum_dtype`` divided by
    the count, and the metrics are averaged.  Metrics are detached 0-d
    tensors: ``loss``, ``xent``, ``grad_norm`` and ``lr``.

    With ``core.spans`` on, each ``train_loss`` is the span
    ``train.forward``, each ``autograd.grad`` (the remat recompute with
    the backward) ``train.backward`` and the update ``train.optimizer``.
    """

    def grads_of(leaves: list, params: Dict, batch: Dict
                 ) -> Tuple[list, Dict[str, torch.Tensor]]:
        with span("train.forward"):
            loss, metrics = model.train_loss(params, batch)
        with span("train.backward"):
            grads = torch.autograd.grad(loss, leaves)
        return list(grads), {k: v.detach() for k, v in metrics.items()}

    def train_step(state: Dict, batch: Dict) -> Tuple[Dict, Dict]:
        params = state["params"]
        leaves = tree_leaves(params)
        for leaf in leaves:
            leaf.requires_grad_(True)
        if microbatches == 1:
            grads, metrics = grads_of(leaves, params, batch)
        else:
            parts = {k: v.chunk(microbatches, dim=0) for k, v in
                     batch.items()}
            grads = [torch.zeros_like(p, dtype=accum_dtype) for p in leaves]
            per_mb = []
            for i in range(microbatches):
                g, m = grads_of(leaves, params,
                                {k: v[i] for k, v in parts.items()})
                for acc, gi in zip(grads, g):
                    acc.add_(gi.to(accum_dtype) / microbatches)
                per_mb.append(m)
            metrics = {k: torch.stack([m[k] for m in per_mb]).mean()
                       for k in per_mb[0]}
        with span("train.optimizer"):
            new_params, new_opt, stats = adamw_update(
                tree_unflatten(params, grads), state["opt"], params, opt_cfg)
        metrics.update(stats)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step


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


def init_state(model, opt_cfg: OptimizerConfig,
               generator: torch.Generator,
               dtype: Optional[torch.dtype] = None) -> Dict:
    """Random parameters from ``generator`` (on the model's device) and
    fresh AdamW state."""
    params = model.init(generator, dtype)
    return {"params": params, "opt": adamw_init(params, opt_cfg)}


def abstract_state(model, opt_cfg: OptimizerConfig) -> Dict:
    """``init_state``'s tree as ``meta`` tensors (shapes and dtypes)."""
    ap = model.abstract_params()
    return {"params": ap, "opt": abstract_opt_state(ap, opt_cfg)}


def state_logical_axes(model, opt_cfg: OptimizerConfig) -> Dict:
    """The logical-axis tuples of every leaf of ``init_state``'s tree."""
    pa = model.param_logical_axes()
    return {"params": pa, "opt": opt_state_logical_axes(pa, opt_cfg)}


__all__ = ["make_train_step", "make_serve_step", "make_prefill_step",
           "init_state", "abstract_state", "state_logical_axes"]
