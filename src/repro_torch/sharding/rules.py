"""Logical-axis sharding rules -> DTensor placements, divisibility-aware:
the port of ``repro.sharding.rules``.

Every parameter and input tensor carries logical axis names
(``models.params.P``).  This engine maps logical axes to mesh axes with:
  * a global priority order (e.g. shard kv_heads before falling back to
    sharding the KV sequence of a cache);
  * divisibility checks (25 heads on a 16-way axis -> replicate, logged);
  * profile-dependent rules: "tp" shards weights over the model axis only;
    "fsdp_tp" additionally shards the d_model dim over the data axis
    (ZeRO-3/FSDP-style).

A mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named dims;
the choice of a spec reads only its ``mesh_dim_names`` and ``shape``, so
any object with those two works there (the tests use a stub).  A
``PartitionSpec`` gives each tensor dim ``None``, a mesh axis name or a
tuple of names; ``NamedSharding(mesh, spec).placements`` is the DTensor
form: ``Shard(d)`` on each mesh dim that splits tensor dim ``d``,
``Replicate()`` on the rest.  DTensor splits a dim over several mesh dims
in mesh order, JAX in the tuple's order, so a tuple must name its axes in
the mesh's order (the rules' ``("pod", "data")`` does); then each rank
holds the slice JAX's ``NamedSharding`` puts on the device at its mesh
position.

The constrainers (``make_*_constrainer(s)``) redistribute a DTensor to
the spec their pure ``*_spec`` function picks and return a plain tensor
unchanged: the counterpart of ``jax.lax.with_sharding_constraint``.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from torch.distributed.tensor import DTensor, Replicate, Shard

log = logging.getLogger(__name__)

Candidate = Tuple[str, ...]

# candidates per logical axis, in preference order
BASE_RULES: Dict[str, List[Candidate]] = {
    # data-parallel axes
    "batch": [("pod", "data"), ("data",)],
    # tensor-parallel axes
    "experts": [("model",)],
    "heads": [("model",)],
    "kv_heads": [("model",)],
    "d_ff": [("model",)],
    "vocab": [("model",)],
    "d_inner": [("model",)],
    "d_inner2": [("model",)],
    "heads2": [("model",)],
    "gates": [("model",)],
    "gates_h": [("model",)],
    # sequence/context parallelism (activations, KV caches, long-context)
    "seq": [("data",)],
    "kv_seq": [("model",)],
    "frames": [],
    # last-resort: shard head_dim over model (e.g. KV caches whose kv_heads
    # don't divide the model axis, xlstm matrix states)
    "head_dim": [("model",)],
    # replicated by default
    "d_model": [],
    "d_model_out": [],
    "head_dim_out": [],
    "state": [],
    "state2": [],
    "conv_k": [],
    "layers": [],
    "patches": [],
}

FSDP_EXTRA: Dict[str, List[Candidate]] = {
    # prefer sharding over pod x data (multi-pod FSDP: without the pod axis
    # the parameter shards replicate per pod); single-pod meshes filter the
    # absent "pod" axis out and use data only.
    "d_model": [("pod", "data"), ("data",)],
    "d_model_out": [("pod", "data"), ("data",)],
}

# assignment priority: earlier names grab mesh axes first
PRIORITY = [
    "experts", "heads", "kv_heads", "d_ff", "vocab", "d_inner", "d_inner2",
    "heads2", "gates", "gates_h", "batch", "seq", "kv_seq", "d_model",
    "d_model_out", "head_dim", "state", "frames",
]


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (the dim split over all of them)."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


def mesh_sizes(mesh) -> Dict[str, int]:
    """{axis name: size} of a mesh with named dims."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


class NamedSharding:
    """A mesh and a ``PartitionSpec`` over its axis names; ``placements``
    is the DTensor form (one placement per mesh dim)."""

    def __init__(self, mesh, spec: PartitionSpec) -> None:
        names = tuple(mesh.mesh_dim_names)
        for part in spec:
            axes = part if isinstance(part, tuple) else (part,)
            if any(a is not None and a not in names for a in axes):
                raise ValueError(f"{spec} names an axis not in the mesh's "
                                 f"{names}")
            order = [names.index(a) for a in axes if a is not None]
            if order != sorted(order):
                raise ValueError(f"{spec}: a dim split over several mesh "
                                 f"axes must name them in the mesh's order "
                                 f"{names}, as DTensor splits them")
        self.mesh = mesh
        self.spec = spec

    @property
    def placements(self) -> tuple:
        names = tuple(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for d, part in enumerate(self.spec):
            for a in (part if isinstance(part, tuple) else (part,)):
                if a is not None:
                    out[names.index(a)] = Shard(d)
        return tuple(out)

    def __repr__(self) -> str:
        return f"NamedSharding({self.mesh!r}, {self.spec!r})"


def rules_for_profile(profile: str) -> Dict[str, List[Candidate]]:
    rules = {k: list(v) for k, v in BASE_RULES.items()}
    if profile == "fsdp_tp":
        for k, v in FSDP_EXTRA.items():
            rules[k] = list(v) + rules.get(k, [])
    return rules


def spec_for(axes: Sequence[Optional[str]], shape: Sequence[int], mesh,
             rules: Dict[str, List[Candidate]]) -> PartitionSpec:
    """Build a PartitionSpec for one tensor."""
    sizes = mesh_sizes(mesh)
    assignment: Dict[int, Candidate] = {}
    used: set = set()

    def axis_priority(name: Optional[str]) -> int:
        if name is None or name not in PRIORITY:
            return len(PRIORITY)
        return PRIORITY.index(name)

    dims = sorted(range(len(axes)), key=lambda i: (axis_priority(axes[i]), i))
    for i in dims:
        name = axes[i]
        if name is None:
            continue
        for cand in rules.get(name, []):
            cand = tuple(a for a in cand if a in sizes)
            if not cand or any(a in used for a in cand):
                continue
            size = math.prod(sizes[a] for a in cand)
            if shape[i] % size == 0 and shape[i] >= size:
                assignment[i] = cand
                used.update(cand)
                break
        else:
            if rules.get(name):
                log.debug("replicating axis %r of shape %s (no divisible rule)",
                          name, tuple(shape))
    parts = []
    for i in range(len(axes)):
        a = assignment.get(i)
        parts.append(a if a is None or len(a) > 1 else a[0])
    return PartitionSpec(*parts)


def _map_with_axes(fn: Callable, values: Any, axes: Any) -> Any:
    """``fn(leaf, axes)`` over a tree of nested dicts and the matching
    tree of logical-axis tuples."""
    if isinstance(values, dict):
        return {k: _map_with_axes(fn, v, axes[k]) for k, v in values.items()}
    return fn(values, axes)


def tree_shardings(spec_tree, axes_tree, mesh, profile: str = "tp",
                   extra_rules: Optional[Dict[str, List[Candidate]]] = None):
    """NamedSharding tree for a tree of tensors (``meta`` ones from
    ``abstract_state`` cost nothing) and its tree of logical axes."""
    rules = rules_for_profile(profile)
    if extra_rules:
        for k, v in extra_rules.items():
            rules[k] = list(v) + rules.get(k, [])
    return _map_with_axes(
        lambda x, a: NamedSharding(mesh, spec_for(a, x.shape, mesh, rules)),
        spec_tree, axes_tree)


# ---------------------------------------------------------------------------
# Activation constrainers: a pure choice of spec, and the redistribution
# ---------------------------------------------------------------------------

def _batch_axes(sizes: Dict[str, int], batch_axes) -> Tuple[Any, int]:
    """(the batch dim's spec entry or None, its split count)."""
    names = tuple(a for a in batch_axes if a in sizes and sizes[a] > 1)
    size = math.prod(sizes[a] for a in names) if names else 1
    part = names if len(names) > 1 else (names[0] if names else None)
    return part, size


def act_spec(shape, sizes: Dict[str, int], batch_axes=("pod", "data"),
             seq_axis: str = "model") -> Optional[PartitionSpec]:
    """Sequence-parallel residual stream (Megatron-SP style): a (B, S, D)
    activation as P(batch_axes, seq_axis, None) where divisible; None
    leaves it as it is."""
    if len(shape) != 3:
        return None
    bpart, bsize = _batch_axes(sizes, batch_axes)
    ssize = sizes.get(seq_axis, 1)
    parts = [None, None, None]
    if bsize > 1 and shape[0] % bsize == 0:
        parts[0] = bpart
    if ssize > 1 and shape[1] % ssize == 0:
        parts[1] = seq_axis
    if parts[0] is None and parts[1] is None:
        return None
    return PartitionSpec(*parts)


def attn_spec(shape, sizes: Dict[str, int], head_ok: bool, seq_ok: bool,
              batch_axes=("pod", "data"), tp_axis: str = "model"
              ) -> Optional[PartitionSpec]:
    """q (``seq_ok``) or k/v (B, S, H, D): heads over the model axis when
    divisible, else (q only) the sequence; the batch over the data axes."""
    tsize = sizes.get(tp_axis, 1)
    if len(shape) != 4 or tsize <= 1:
        return None
    bpart, bsize = _batch_axes(sizes, batch_axes)
    parts = [None, None, None, None]
    if bsize > 1 and shape[0] % bsize == 0:
        parts[0] = bpart
    if head_ok and shape[2] % tsize == 0:
        parts[2] = tp_axis
    elif seq_ok and shape[1] % tsize == 0:
        parts[1] = tp_axis
    if all(p is None for p in parts):
        return None
    return PartitionSpec(*parts)


def moe_buffer_spec(shape, sizes: Dict[str, int],
                    batch_axes=("pod", "data"), tp_axis: str = "model"
                    ) -> Optional[PartitionSpec]:
    """(B, E, C, X) grouped dispatch/expert buffers: groups over the data
    axes, experts over the model axis when divisible (else the feature
    dim), capacity replicated."""
    tsize = sizes.get(tp_axis, 1)
    if len(shape) != 4 or tsize <= 1:
        return None
    B, E, C, X = shape
    bpart, bsize = _batch_axes(sizes, batch_axes)
    parts = [None, None, None, None]
    if bsize > 1 and B % bsize == 0:
        parts[0] = bpart
    if E % tsize == 0:
        parts[1] = tp_axis
    elif X % tsize == 0:
        parts[3] = tp_axis
    if all(p is None for p in parts):
        return None
    return PartitionSpec(*parts)


def _constrainer(mesh, choose: Callable) -> Callable:
    """f(x): a DTensor redistributed to ``choose(shape, sizes)``'s spec
    (where it picks one); any other tensor unchanged."""
    sizes = mesh_sizes(mesh)

    def constrain(x):
        spec = choose(tuple(x.shape), sizes)
        if spec is None or not isinstance(x, DTensor):
            return x
        return x.redistribute(mesh, NamedSharding(mesh, spec).placements)

    return constrain


def make_act_constrainer(mesh, batch_axes=("pod", "data"),
                         seq_axis: str = "model") -> Callable:
    """The residual-stream constrainer (``act_spec``)."""
    return _constrainer(mesh, lambda shape, sizes: act_spec(
        shape, sizes, batch_axes, seq_axis))


def make_attn_constrainers(mesh, batch_axes=("pod", "data"),
                           tp_axis: str = "model") -> Tuple[Callable, Callable]:
    """(constrain_q, constrain_kv) for attention operands (``attn_spec``):
    q falls back to its sequence when its heads do not divide the model
    axis; k and v stay replicated then (every q shard needs all of them
    under causal masking)."""
    def q(shape, sizes):
        return attn_spec(shape, sizes, True, True, batch_axes, tp_axis)

    def kv(shape, sizes):
        return attn_spec(shape, sizes, True, False, batch_axes, tp_axis)

    return _constrainer(mesh, q), _constrainer(mesh, kv)


def make_moe_constrainer(mesh, batch_axes=("pod", "data"),
                         tp_axis: str = "model") -> Callable:
    """The MoE buffer constrainer (``moe_buffer_spec``)."""
    return _constrainer(mesh, lambda shape, sizes: moe_buffer_spec(
        shape, sizes, batch_axes, tp_axis))


def shard_batch_spec(mesh, ndim: int) -> NamedSharding:
    """Default data-parallel sharding for a (B, ...) host batch array."""
    names = [a for a in ("pod", "data") if a in mesh.mesh_dim_names]
    parts = [tuple(names) if len(names) > 1 else names[0]] + [None] * (ndim - 1)
    return NamedSharding(mesh, PartitionSpec(*parts))


__all__ = ["BASE_RULES", "FSDP_EXTRA", "PRIORITY", "PartitionSpec",
           "NamedSharding", "mesh_sizes", "rules_for_profile", "spec_for",
           "tree_shardings", "shard_batch_spec", "act_spec", "attn_spec",
           "moe_buffer_spec", "make_act_constrainer",
           "make_attn_constrainers", "make_moe_constrainer"]
