"""Parameter specs: shapes + logical axes + initializers.

The port of ``repro.models.params``.  Models declare parameters as
``P(shape, axes)`` trees (nested dicts); ``init_params`` materializes them
as tensors, ``abstract_params`` as ``meta`` tensors, and ``logical_axes``
yields the matching tree of logical-axis tuples that
``repro_torch.sharding.rules`` maps onto a device mesh.  Stacked layers
prepend a ``"layers"`` axis.  Trees are plain dicts of tensors, keyed
exactly as the reference's, so a parameter tree converts leaf by leaf
(``repro_torch.convert``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable, Optional, Tuple

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class P:
    """Spec of one parameter tensor."""

    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names, len == ndim
    init: str = "normal"                  # normal | zeros | ones | embed
    scale: float = 1.0                    # fan-in override multiplier

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def tree_map(fn: Callable, tree: Any) -> Any:
    """Apply ``fn`` to every leaf of a tree of nested dicts."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    """The leaves of a tree of nested dicts, in sorted-key order (the
    reference's ``jax.tree.leaves`` order), whatever the dicts' insertion
    order."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_unflatten(tree: Any, leaves: list) -> Any:
    """``tree``'s structure around ``leaves`` given in
    :func:`tree_leaves` order."""
    it = iter(leaves)

    def build(t: Any) -> Any:
        if not isinstance(t, dict):
            return next(it)
        made = {k: build(t[k]) for k in sorted(t)}
        return {k: made[k] for k in t}

    return build(tree)


def unstack(stacked: Any, n: int) -> list:
    """A tree whose leaves have a leading axis of ``n`` (stacked layers) as
    ``n`` trees, one per layer.  Each leaf is split once with ``unbind``,
    whose backward is one ``stack`` (indexing ``p[i]`` per layer would
    write a zero-filled gradient of the whole stack for every layer)."""
    parts = tree_map(lambda p: torch.unbind(p, 0), stacked)
    return [tree_map(lambda t: t[i], parts) for i in range(n)]


def count_params(tree: Any) -> int:
    """Elements in a tree of specs or of tensors."""
    return sum(int(np.prod(leaf.shape)) for leaf in tree_leaves(tree))


def _fan_in(shape: Tuple[int, ...]) -> int:
    # convention: last axis is the output axis for weight matrices
    return int(np.prod(shape[:-1])) if len(shape) > 1 else shape[0]


def init_params(spec_tree: Any, generator: torch.Generator,
                dtype: torch.dtype = torch.float32,
                device="cuda") -> Any:
    """Materialize a spec tree into parameter tensors on ``device``.

    The reference's rules: ``normal`` draws N(0,1) scaled by
    ``scale / sqrt(fan_in)``, where the fan-in counts every axis but the
    last (a stacked ``layers`` axis included); ``embed`` draws N(0, 0.02
    * scale).  Leaves are drawn in the reference's leaf order from one
    ``generator`` on ``device``; the numbers differ from ``jax.random``'s,
    so parity tests convert weights instead of sharing seeds.
    """
    def make(spec: P) -> torch.Tensor:
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=device)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=device)
        x = torch.randn(spec.shape, generator=generator, dtype=dtype,
                        device=device)
        if spec.init == "embed":
            return x.mul_(0.02 * spec.scale)
        return x.mul_(spec.scale / math.sqrt(max(_fan_in(spec.shape), 1)))

    def build(tree: Any) -> Any:
        if not isinstance(tree, dict):
            return make(tree)
        made = {k: build(tree[k]) for k in sorted(tree)}
        return {k: made[k] for k in tree}

    return build(spec_tree)


def abstract_params(spec_tree: Any, dtype: torch.dtype = torch.bfloat16
                    ) -> Any:
    """The spec tree as tensors on the ``meta`` device: shapes and a dtype,
    no storage (the reference's ``ShapeDtypeStruct`` tree)."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=dtype,
                                          device="meta"), spec_tree)


def logical_axes(spec_tree: Any) -> Any:
    """Tree of logical-axis tuples matching the param tree."""
    return tree_map(lambda s: s.axes, spec_tree)


def stack_layer_specs(spec_tree: Any, n_layers: int) -> Any:
    """Prepend a stacked 'layers' axis to every spec in the tree."""
    return tree_map(
        lambda s: P((n_layers,) + s.shape, ("layers",) + s.axes,
                    init=s.init, scale=s.scale), spec_tree)


__all__ = ["P", "init_params", "abstract_params", "logical_axes",
           "stack_layer_specs", "tree_map", "tree_leaves", "tree_unflatten",
           "unstack", "count_params"]
