"""Dry-run core: count every (arch x shape) cell's step on a mesh, per
device, and extract memory / FLOP / collective statistics for the roofline
analysis: the port of ``repro.launch.dryrun_lib``.

The reference lowers and compiles each cell for a forced-host mesh and
reads XLA's analyses.  The port has no compiler: it builds the model on
``meta``, distributes the parameters, optimizer state and inputs as
DTensors whose local shards are ``meta`` tensors (``tree_shardings``, as
the reference), sets the models' ``constrain_*`` hooks, and runs the
step itself, once, under ``launch.op_cost.OpCost``, which charges each op
on this device's shards (a plain tensor the step makes, such as the
rope tables, counts as replicated: ``implicit_replication``).  A mesh is a ``DeviceMesh`` over a fake process
group (``launch.mesh``), so no device is needed.

What differs from the reference's record, key by key:
  * ``raw_cost_analysis``: ``flops`` is ``FlopCounterMode``'s count of the
    same run, which charges each op on its GLOBAL shapes (the sum over
    devices, where the op is split; ``bytes`` is -1: it counts none);
  * ``lower_s`` is the time to build and distribute the cell, and
    ``compile_s`` the time of the counted run (the trace);
  * ``memory``: ``argument_bytes`` are the local shards of the step's
    arguments that it reads (``jax.jit`` drops an unused argument, such as
    Whisper's encoder weights in a decode step; a decode cache's ``pos``
    counts as read, as the reference's step reads it, though the port
    keeps it as a host int; ``local_bytes`` of ``build_cell``'s
    arguments counts them all), ``output_bytes`` the local storages of
    its outputs,
    ``alias_bytes`` those outputs that are arguments (the train step
    updates the state in place, decode writes the cache in place: the
    reference donates both), and ``temp_bytes`` the peak of live local
    bytes during the step less all the arguments and the outputs that are
    not aliases, so that argument + temp + output - alias is that peak
    less the unread arguments, as in the reference.
Every count is DEVICE 0's (the fake group's rank 0): where DTensor has no
fitting rule, ``launch.per_device``'s rules, installed only while
``count`` runs, charge device 0's shards.  Every device does the same
work but in causal attention over a sequence split over the model axis
(q's heads do not divide it), where device 0, holding the first
positions, does the least; those cells' attention FLOPs and bytes are
device 0's, not the critical device's (``PERF.md`` lists the cells).
A decode cell is counted at its last position (``pos = seq_len - 1``):
the kernels read every valid row, and a full cache is the most work.
"""

from __future__ import annotations

import math
import time
from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch.distributed.tensor import DTensor, Shard
from torch.distributed.tensor.experimental import implicit_replication
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.configs.base import SHAPES, ArchConfig, ShapeConfig, get_arch
from repro_torch.models import build_model
from repro_torch.models.params import count_params, tree_leaves, tree_map
from repro_torch.sharding.rules import (make_act_constrainer,
                                        make_attn_constrainers,
                                        make_moe_constrainer, mesh_sizes,
                                        tree_shardings)
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import (abstract_state, make_prefill_step,
                                    make_serve_step, make_train_step,
                                    state_logical_axes)

from . import per_device
from .mesh import mesh_name
from .op_cost import COLLECTIVE_OPS, OpCost

# Per-arch memory policy, the reference's: optimizer state dtype, the
# microbatch count of train_4k and the gradient accumulator's dtype.
OPT_STATE_DTYPE = {
    "grok-1-314b": "int8",
    "kimi-k2-1t-a32b": "int8_factored",
}
TRAIN_MICROBATCHES = {
    "qwen3-4b": 1, "qwen3-14b": 1, "yi-34b": 1, "stablelm-1.6b": 1,
    "whisper-tiny": 4, "grok-1-314b": 2, "kimi-k2-1t-a32b": 2,
    "hymba-1.5b": 2, "xlstm-350m": 2, "internvl2-2b": 1,
}
ACCUM_DTYPE = {
    "grok-1-314b": torch.bfloat16,
    "kimi-k2-1t-a32b": torch.bfloat16,
}


def model_flops_estimate(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6*N*D (dense) / 6*N_active*D (MoE); decode counts one token/seq."""
    model = build_model(cfg, device="meta")
    n_params = count_params(model.param_specs())
    if cfg.n_experts and cfg.top_k:
        # subtract inactive expert params
        expert_params = 3 * cfg.d_model * cfg.d_ff * cfg.n_experts * cfg.n_layers
        active = expert_params * cfg.top_k / cfg.n_experts
        n_active = n_params - expert_params + active
    else:
        n_active = n_params
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_active * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_active * tokens
    tokens = shape.global_batch  # one new token per sequence
    return 2.0 * n_active * tokens


def local_shape(shape, placements, mesh_shape) -> Tuple[int, ...]:
    """One device's shard of a tensor of ``shape`` under ``placements``
    (the rules split only where a dim divides)."""
    out = list(shape)
    for size, p in zip(mesh_shape, placements):
        if isinstance(p, Shard):
            if out[p.dim] % size:
                raise ValueError(f"{tuple(shape)} dim {p.dim} does not "
                                 f"divide over {size}")
            out[p.dim] //= size
    return tuple(out)


def distribute(specs, shardings):
    """A tree of ``meta`` specs as DTensors laid out by ``shardings`` (a
    matching tree of ``NamedSharding``), each holding a ``meta`` shard.  On
    a one-device mesh the specs themselves: a shard is the whole tensor,
    and the step then runs the very ops it runs on a card."""
    def one(spec, sh):
        if math.prod(sh.mesh.shape) == 1:
            return spec
        placements = sh.placements
        local = torch.empty(local_shape(spec.shape, placements,
                                        tuple(sh.mesh.shape)),
                            dtype=spec.dtype, device="meta")
        return DTensor.from_local(local, sh.mesh, placements,
                                  run_check=False, shape=spec.shape,
                                  stride=spec.stride())
    return _map2(one, specs, shardings)


def _map2(fn: Callable, a, b):
    if isinstance(a, dict):
        return {k: _map2(fn, v, b[k]) for k, v in a.items()}
    return fn(a, b)


def local_bytes(tree) -> int:
    """Bytes of one device's shards of ``tree``'s tensors."""
    total = 0
    for t in tree_leaves(_as_tree(tree)):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            total += t.numel() * t.element_size()
    return total


def build_cell(arch_id: str, shape_name: str, mesh,
               opt_cfg: Optional[OptimizerConfig] = None,
               microbatches: Optional[int] = None,
               seq_parallel: bool = True, *,
               cfg: Optional[ArchConfig] = None,
               shape: Optional[ShapeConfig] = None,
               decode_pos: Optional[int] = None):
    """Returns (run, args, cfg, shape) for a cell: ``run()`` runs the step
    once on ``args``, the tuple of its distributed arguments.  ``cfg`` and
    ``shape`` override the registry's (a cut model, a card's batch), and
    ``decode_pos`` the position a decode step writes (``seq_len - 1``).

    seq_parallel=True sets the models' constrainers (the Megatron-SP
    residual stream, the attention operands, the MoE buffers); False is
    the naive baseline."""
    cfg = cfg or get_arch(arch_id)
    shape = shape or SHAPES[shape_name]
    model = build_model(cfg, device="meta")
    if seq_parallel:
        model.constrain_act = make_act_constrainer(mesh)
        model.constrain_q, model.constrain_kv = make_attn_constrainers(mesh)
        model.constrain_moe = make_moe_constrainer(mesh)
    profile = cfg.sharding_profile
    if opt_cfg is None:
        opt_cfg = OptimizerConfig(
            state_dtype=OPT_STATE_DTYPE.get(cfg.name, "float32"))
    if microbatches is None:
        microbatches = TRAIN_MICROBATCHES.get(cfg.name, 1)

    input_specs = model.input_specs(shape)
    inputs = distribute(input_specs, tree_shardings(
        input_specs, model.input_logical_axes(shape), mesh, profile))

    if shape.kind == "train":
        step = make_train_step(model, opt_cfg, microbatches=microbatches,
                               accum_dtype=ACCUM_DTYPE.get(cfg.name,
                                                           torch.float32))
        specs = abstract_state(model, opt_cfg)
        axes = state_logical_axes(model, opt_cfg)
        # ZeRO-1: optimizer state also sharded over the data axis
        state = {
            "params": distribute(specs["params"], tree_shardings(
                specs["params"], axes["params"], mesh, profile)),
            "opt": distribute(specs["opt"], tree_shardings(
                specs["opt"], axes["opt"], mesh, "fsdp_tp")),
        }
        return (lambda: step(state, inputs)), (state, inputs), cfg, shape
    ap = model.abstract_params()
    params = distribute(ap, tree_shardings(ap, model.param_logical_axes(),
                                           mesh, profile))
    if shape.kind == "prefill":
        step = make_prefill_step(model)
        return (lambda: step(params, inputs)), (params, inputs), cfg, shape
    # decode: the port's caches carry ``pos`` as one host int
    step = make_serve_step(model)
    cache, tokens = inputs["cache"], inputs["tokens"]
    live = tree_map(lambda t: t, cache)
    _set_pos(live, shape.seq_len - 1 if decode_pos is None else decode_pos)
    return (lambda: step(params, live, tokens)), (params, cache, tokens), \
        cfg, shape


def _set_pos(tree: Dict, pos: int) -> None:
    for k, v in tree.items():
        if k == "pos":
            tree[k] = pos
        elif isinstance(v, dict):
            _set_pos(v, pos)


def count(run: Callable, args, read=()) -> Dict[str, Any]:
    """Run ``run()`` once under ``OpCost`` (and ``FlopCounterMode`` for
    the global count) with ``args`` tracked as live; returns the counter,
    the global flops and the memory record.  ``read`` holds arguments the
    step reads off the device in the reference (a decode cache's ``pos``)."""
    counter = OpCost()
    flop_mode = FlopCounterMode(display=False)
    with counter.counting(), per_device.installed():
        base = counter.track(args)
        with flop_mode, implicit_replication():
            out = run()
    arg_storages = _storages(args)
    out_storages = _storages(out)
    out_bytes = sum(out_storages.values())
    alias = sum(n for k, n in out_storages.items() if k in arg_storages)
    read = counter.read | set(_storages(read))
    memory = {"argument_bytes": sum(n for k, n in arg_storages.items()
                                    if k in read),
              "output_bytes": out_bytes,
              "temp_bytes": max(counter.peak_bytes - base
                                - (out_bytes - alias), 0),
              "alias_bytes": alias}
    return {"counter": counter, "global_flops": flop_mode.get_total_flops(),
            "memory": memory}


def _storages(tree) -> Dict[int, int]:
    """{storage key: bytes} of the local shards of ``tree``'s tensors."""
    out = {}
    for t in tree_leaves(_as_tree(tree)):
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def _pos_leaves(tree) -> list:
    """The ``pos`` leaves of a tree (a decode cache's)."""
    if isinstance(tree, (tuple, list)):
        return [p for t in tree for p in _pos_leaves(t)]
    if isinstance(tree, dict):
        return [p for k, v in tree.items()
                for p in ([v] if k == "pos" else _pos_leaves(v))]
    return []


def _as_tree(x):
    """Tuples and lists as dicts, so ``tree_leaves`` walks them."""
    if isinstance(x, (tuple, list)):
        return {i: _as_tree(v) for i, v in enumerate(x)}
    if isinstance(x, dict):
        return {k: _as_tree(v) for k, v in x.items()}
    return x


def peak_bytes(rec: Dict[str, Any]) -> int:
    """What a record says one device must hold at once: argument + temp +
    output - alias bytes."""
    m = rec["memory"]
    return (m["argument_bytes"] + m["temp_bytes"] + m["output_bytes"]
            - max(m["alias_bytes"], 0))


def run_cell(arch_id: str, shape_name: str, mesh, verbose: bool = True, *,
             cfg: Optional[ArchConfig] = None,
             shape: Optional[ShapeConfig] = None,
             **build_kw) -> Dict[str, Any]:
    t0 = time.time()
    run, args, cfg, shape = build_cell(arch_id, shape_name, mesh, cfg=cfg,
                                       shape=shape, **build_kw)
    t_lower = time.time() - t0
    counted = count(run, args, read=_pos_leaves(args))
    t_compile = time.time() - t0 - t_lower
    counter = counted["counter"]
    coll = {k: float(counter.collectives[k]) for k in COLLECTIVE_OPS}
    coll["total"] = float(sum(coll.values()))
    n_dev = math.prod(mesh_sizes(mesh).values())
    result = {
        "arch": arch_id, "shape": shape_name,
        "mesh": mesh_name(mesh),
        "devices": n_dev,
        "flops_per_device": float(counter.flops),
        "bytes_per_device": float(counter.bytes),
        "collective_bytes_per_device": coll,
        "raw_cost_analysis": {"flops": float(counted["global_flops"]),
                              "bytes": -1.0},
        "memory": counted["memory"],
        "kernel_calls": dict(counter.kernels),
        "model_flops_total": model_flops_estimate(cfg, shape),
        "lower_s": round(t_lower, 1), "compile_s": round(t_compile, 1),
    }
    if verbose:
        peak = peak_bytes(result)
        print(f"[dryrun] {arch_id:18s} {shape_name:12s} mesh={result['mesh']:9s}"
              f" flops/dev={result['flops_per_device']:.3e}"
              f" bytes/dev={result['bytes_per_device']:.3e}"
              f" coll/dev={coll['total']:.3e}"
              f" mem(arg+tmp+out-alias)={peak / 2**30:.2f} GiB"
              f" build={t_lower:.0f}s trace={t_compile:.0f}s", flush=True)
    return result


__all__ = ["build_cell", "run_cell", "count", "peak_bytes", "distribute", "local_shape",
           "local_bytes", "model_flops_estimate", "OPT_STATE_DTYPE",
           "TRAIN_MICROBATCHES", "ACCUM_DTYPE", "COLLECTIVE_OPS"]
