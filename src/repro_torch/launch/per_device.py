"""The dry run's per-device rules: how one device's share of a step is
charged where DTensor's own propagation has no fitting rule, or one that
would gather whole tensors onto every device.

``installed()`` swaps the functions named in ``RULES`` for the rules below,
in their own module and in every ``repro_torch`` module that imported
them by name, and puts the originals back when it exits.
``dryrun_lib.count`` holds it around the counted run and nothing else does,
so the models and the optimizer keep their single path everywhere else.
A rule given plain tensors calls the original unchanged.  Given DTensors
it runs the original on this device's local shards, and has DTensor emit
the collectives that the layout implies (which ``op_cost.OpCost`` counts):

  * ``project_heads``: a column-parallel projection.  x is gathered
    where w's heads or head dim are split (Megatron-SP gathers its
    sequence), and w is gathered elsewhere (an FSDP d split);
  * ``project_out``: a row-parallel projection, whose output is a partial
    sum reduced where it is next used;
  * ``embed``: a vocab-parallel lookup, its rows all-reduced;
  * ``unembed`` and ``output_head``: the sequence gathered, so the logits
    are split over the batch and the vocabulary only;
  * ``logz_and_target``: a vocab-parallel loss (a max, a sum of
    exponentials and the target logit reduced over the model axis);
  * ``sequence_attention``: attention on q's batch, sequence and head
    shards against k and v moved to q's batch and head split;
  * ``attention._decode``: decode on the cache where it lies, with a
    split-K combine over a length split;
  * ``moe_apply``: tensor- and expert-parallel MoE in the model axis;
  * ``ssm._mlstm_scan`` and ``ssm._slstm_scan``: the recurrences on each
    device's rows;
  * ``adamw_update``: ZeRO-1, each leaf updated on its moments' shard.

Every rule counts DEVICE 0, the fake group's rank 0.  It raises unless its
local shards are ``meta`` tensors, because it charges device 0's work and
traffic and does not compute device 0's values:

  * a split-K combine all-reduces an unset buffer of the right size;
  * a split sequence is attended as device 0's shard, from position 0;
  * device 0's kv heads, vocabulary rows and experts are the first ones;
  * a factored v's row and column means are taken over the shard (their
    all-reduce, one vector per matrix, is not counted).

Device 0 does the same work as every other device, except in causal
attention over a split sequence.  There device 0 does the least: shard i
of n attends about (2i + 1)/(2n) of the keys.
"""

from __future__ import annotations

import contextlib
import inspect
import math
import sys
from typing import Callable, Dict, Iterator

import torch
import torch.distributed._functional_collectives as funcol
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from repro_torch.models import attention, layers, moe, ssm
from repro_torch.train import optimizer

_ORIG: Dict[str, Callable] = {}


def _meta_only(t: DTensor) -> None:
    if t.to_local().device.type != "meta":
        raise RuntimeError(
            "the dry run's per-device rules count device 0's work on meta "
            f"shards; got a DTensor on {t.to_local().device}")


def _replicated(x: torch.Tensor, mesh) -> DTensor:
    if isinstance(x, DTensor):
        return x
    return DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                              run_check=False)


# ---- projections, embedding, loss -----------------------------------------

def project_heads(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    if not isinstance(w, DTensor):
        return _ORIG["project_heads"](x, w)
    _meta_only(w)
    mesh = w.device_mesh
    x = _replicated(x, mesh)
    lead = x.dim() - 1
    cols = [p in (Shard(1), Shard(2)) for p in w.placements]
    xp = [Replicate() if c or not isinstance(p, Shard) or p.dim == lead
          else p for p, c in zip(x.placements, cols)]
    wp = [p if c else Replicate() for p, c in zip(w.placements, cols)]
    xl = x.redistribute(mesh, xp).to_local()
    wl = w.redistribute(mesh, wp).to_local()
    y = (xl @ wl.reshape(wl.shape[0], -1)).unflatten(-1, wl.shape[1:])
    return DTensor.from_local(
        y, mesh, [Shard(lead + p.dim - 1) if c else q
                  for p, q, c in zip(wp, xp, cols)], run_check=False)


def project_out(params: Dict, o: torch.Tensor) -> torch.Tensor:
    """o is moved to ``wo``'s split of the heads or the head dim (its
    batch and sequence splits kept where ``wo`` does not use that mesh
    dim); the product is a partial sum over the dims that split them.
    ``wo``'s d split (FSDP) is gathered."""
    wo = params["wo"]
    if not isinstance(wo, DTensor):
        return _ORIG["project_out"](params, o)
    _meta_only(wo)
    mesh = wo.device_mesh
    o = _replicated(o, mesh)
    inner = [p in (Shard(0), Shard(1)) for p in wo.placements]
    op = [Shard(p.dim + 2) if split else
          (p if isinstance(p, Shard) and p.dim < 2 else Replicate())
          for p, split in zip(wo.placements, inner)]
    ol = o.redistribute(mesh, op).to_local()
    wl = wo.redistribute(mesh, [p if split else Replicate() for p, split
                                in zip(wo.placements, inner)]).to_local()
    out = ol.flatten(-2) @ wl.reshape(-1, wl.shape[-1])
    out = DTensor.from_local(out, mesh, [Partial() if split else p
                                         for p, split in zip(op, inner)],
                             run_check=False)
    if "bo" in params:
        out = out + params["bo"].to(out.dtype)
    return out


def embed(params: Dict, tokens: torch.Tensor,
          dtype: torch.dtype = torch.bfloat16) -> torch.Tensor:
    """The lookup's pending partial sums reduced at once (DTensor cannot
    reduce-scatter the masked partial of a sharded lookup later)."""
    x = _ORIG["embed"](params, tokens, dtype)
    if not isinstance(x, DTensor) or not any(p.is_partial()
                                              for p in x.placements):
        return x
    _meta_only(x)
    return x.redistribute(x.device_mesh, [
        Replicate() if p.is_partial() else p for p in x.placements])


def _whole_rows(x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, DTensor):
        return x
    _meta_only(x)
    return x.redistribute(x.device_mesh, [
        Replicate() if p == Shard(1) else p for p in x.placements])


# The two heads' products are written out here, so that the gathered x is
# freed once it is cast, as in the originals.
def unembed(params: Dict, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, DTensor):
        return _ORIG["unembed"](params, x)
    return _whole_rows(x).float() @ params["embedding"].float().t()


def output_head(params: Dict, x: torch.Tensor) -> torch.Tensor:
    if not isinstance(x, DTensor):
        return _ORIG["output_head"](params, x)
    return _whole_rows(x).float() @ params["w_out"].float()


def logz_and_target(logits: torch.Tensor, targets: torch.Tensor):
    """Each device on its shard of the logits (B,S,V): the tokens split
    over the batch axes, the vocabulary over the model axis (DTensor's
    own gather backward would put the global (B,S,V) on every device)."""
    if not isinstance(logits, DTensor):
        return _ORIG["logz_and_target"](logits, targets)
    _meta_only(logits)
    mesh = logits.device_mesh
    names = mesh.mesh_dim_names
    want = [Shard(2) if n == "model" else
            Shard(0) if n in ("pod", "data") and
            logits.shape[0] % math.prod(mesh.shape[i] for i, m in
                                        enumerate(names)
                                        if m in ("pod", "data")) == 0
            else Replicate() for n in names]
    logits = logits.redistribute(mesh, want)
    rows = [p if p == Shard(0) else Replicate() for p in want]
    if isinstance(targets, DTensor):
        targets = targets.redistribute(mesh, rows).to_local()
    local = logits.to_local()

    def reduced(t: torch.Tensor, op: str) -> DTensor:
        return DTensor.from_local(t, mesh, [
            Partial(op) if p == Shard(2) else p for p in want],
            run_check=False).redistribute(mesh, rows)

    with torch.no_grad():
        m = reduced(local.amax(dim=-1), "max")
    logz = torch.log(reduced(torch.exp(local - m.to_local()[..., None])
                             .sum(dim=-1), "sum")) + m
    idx = targets.long()[..., None]
    valid = idx < local.shape[-1]
    ll = torch.gather(local, -1, idx.clamp_max(local.shape[-1] - 1))
    return logz, reduced((ll * valid)[..., 0], "sum")


# ---- attention -------------------------------------------------------------

def sequence_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       **kw) -> torch.Tensor:
    """q keeps its batch, sequence and head splits (a split head dim is
    gathered); k and v are moved to q's batch split, and to its head
    split where their kv heads divide, else replicated.  Where q's heads
    are split and k's are not, the shard takes the first kv heads."""
    fn = _ORIG["sequence_attention"]
    if not isinstance(q, DTensor):
        return fn(q, k, v, **kw)
    _meta_only(q)
    mesh, K = q.device_mesh, k.shape[2]
    qp = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
          for p in q.placements]
    kp = [p if p == Shard(0) or (p == Shard(2) and K % n == 0)
          else Replicate() for p, n in zip(qp, mesh.shape)]
    ql = q.redistribute(mesh, qp).to_local()
    kl, vl = (t.redistribute(mesh, kp).to_local() for t in (k, v))
    H = q.shape[2]
    if ql.shape[2] < H and kl.shape[2] == K:
        n_kv = max(1, ql.shape[2] * K // H)
        kl, vl = kl[:, :, :n_kv], vl[:, :, :n_kv]
    return DTensor.from_local(fn(ql, kl, vl, **kw), mesh, qp,
                              run_check=False)


def decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           length: int) -> torch.Tensor:
    """The cache stays where it lies (its batch, kv-head or length split;
    a split head dim is gathered); q, one token, is moved to the cache's
    batch and kv-head split and gathered elsewhere.  Over a length split
    each device attends its rows (``min(length, rows)`` valid) and the
    output and its two f32 softmax row statistics are all-reduced over
    the dims that split it, as a split-K combine does."""
    fn = _ORIG["_decode"]
    if not isinstance(q, DTensor):
        return fn(q, k, v, length)
    _meta_only(q)
    mesh = q.device_mesh
    kp = [p if p in (Shard(0), Shard(1), Shard(2)) else Replicate()
          for p in k.placements]
    qp = [p if p in (Shard(0), Shard(2)) else Replicate() for p in kp]
    kl, vl = (t.redistribute(mesh, kp).to_local() for t in (k, v))
    ql = q.redistribute(mesh, qp).to_local()
    along_t = [i for i, p in enumerate(kp) if p == Shard(1)]
    o = fn(ql, kl, vl, min(length, kl.shape[1]))
    if along_t:
        stats = torch.empty(o.numel() + 2 * o[..., 0].numel(),
                            dtype=torch.float32, device=o.device)
        for i in along_t:
            funcol.wait_tensor(funcol.all_reduce(stats, "sum", (mesh, i)))
    return DTensor.from_local(o, mesh, qp, run_check=False)


# ---- MoE and the recurrences -----------------------------------------------

def moe_apply(params: Dict, x: torch.Tensor, **kw):
    """The tokens are split over the batch axes and gathered over the
    model axis (every device of it routes the same tokens); the router is
    replicated; each device holds its split of the experts (the experts
    where they divide the model axis, else each expert's d_ff), gathered
    over the other axes (FSDP) inside each chunk's checkpoint, and
    computes those experts' slots.  The outputs, partial sums over the
    model axis, are reduced where they are next used; the metrics are
    averaged over the rows' devices.  The ``constrain`` hook is not used:
    the buffers are local."""
    if not isinstance(x, DTensor):
        return _ORIG["moe_apply"](params, x, **kw)
    _meta_only(x)
    args = inspect.signature(_ORIG["moe_apply"]).bind(params, x, **kw)
    args.apply_defaults()
    kw = {k: v for k, v in args.arguments.items()
          if k not in ("params", "x", "constrain")}
    mesh = x.device_mesh
    names, sizes = mesh.mesh_dim_names, tuple(mesh.shape)
    n_rows = math.prod(n for a, n in zip(names, sizes) if a != "model")
    rows = [Shard(0) if a != "model" and x.shape[0] % n_rows == 0
            else Replicate() for a in names]
    E = params["router"].shape[-1]
    n_model = sizes[names.index("model")]
    by_expert = E % n_model == 0

    def layout(dim: int):
        return [Shard(dim) if a == "model" else Replicate() for a in names]

    def local(p: Dict) -> Dict:
        split = {"w_gate": 0 if by_expert else 2,
                 "w_up": 0 if by_expert else 2,
                 "w_down": 0 if by_expert else 1}
        out = {"router": p["router"].redistribute(
            mesh, [Replicate()] * len(names)).to_local()}
        for k, dim in split.items():
            out[k] = p[k].redistribute(mesh, layout(dim)).to_local()
        return out

    first = (mesh.get_local_rank("model") * (E // n_model) if by_expert
             else 0)
    out, metrics = moe._moe_chunks(
        params, x.redistribute(mesh, rows).to_local(), constrain=None,
        weights=local, first_expert=first, **kw)
    partial = [Partial() if a == "model" else p for a, p in zip(names, rows)]
    mean = [Partial("avg") if p == Shard(0) else Replicate() for p in rows]
    return DTensor.from_local(out, mesh, partial, run_check=False), {
        k: DTensor.from_local(v, mesh, mean, run_check=False)
        for k, v in metrics.items()}


def _on_rows(fn: Callable, *args):
    """``fn`` on this device's rows of a batch split over the mesh (the
    first argument's split); every other tensor in ``args`` (and those in
    tuples, which follow the rows) is gathered, and the outputs keep the
    rows' split."""
    first = args[0]
    _meta_only(first)
    mesh = first.device_mesh
    rows = [p if p == Shard(0) else Replicate() for p in first.placements]
    full = [Replicate()] * mesh.ndim

    def local(t, want):
        if isinstance(t, tuple):
            return tuple(local(u, want) for u in t)
        if not isinstance(t, torch.Tensor):
            return t
        return _replicated(t, mesh).redistribute(mesh, want).to_local()

    def wrap(t):
        if isinstance(t, tuple):
            return tuple(wrap(u) for u in t)
        return DTensor.from_local(t, mesh, rows, run_check=False)

    return wrap(fn(*(local(a, rows if i == 0 or isinstance(a, tuple)
                          else full) for i, a in enumerate(args))))


def mlstm_scan(q, rest, carry, chunk: int):
    fn = _ORIG["_mlstm_scan"]
    if not isinstance(q, DTensor):
        return fn(q, rest, carry, chunk)
    return _on_rows(fn, q, rest, carry, chunk)


def slstm_scan(zx, r, carry=None):
    fn = _ORIG["_slstm_scan"]
    if not isinstance(zx, DTensor):
        return fn(zx, r, carry)
    return _on_rows(fn, zx, r, carry)


# ---- the optimizer ----------------------------------------------------------

def _local_of(x, mesh, place, backs: list):
    """The local shard of a moment (or of each tensor of its dict) laid
    out as ``place``: a factored v's ``vr`` (rows, 1) and ``vc`` (1, cols)
    follow the moment's rows and columns; a tensor moved to get there is
    copied back through ``backs``."""
    if isinstance(x, dict):
        return {k: _local_of(v, mesh, place, backs) for k, v in x.items()}
    if not isinstance(x, DTensor):
        return x
    want = [Replicate() if isinstance(p, Shard) and x.shape[p.dim] == 1
            else p for p in place]
    if list(want) == list(x.placements):
        return x.to_local()
    local = x.redistribute(mesh, want).to_local().clone()
    backs.append((x, local, mesh, want))
    return local


def _moment_shards(leaves: list):
    """Each (param, grad, m, v) on this device's shard of its moments,
    the gradient norm, and the (tensor, local shard, mesh, placements) of
    what is to be gathered back."""
    local, backs, total = [], [], None
    for p, g, m, v in leaves:
        _meta_only(p)
        like = m["q"] if isinstance(m, dict) else m
        mesh, place = like.device_mesh, like.placements
        p_l = p.redistribute(mesh, place).to_local().clone()
        g_l = g.redistribute(mesh, place).to_local()
        backs.append((p, p_l, mesh, place))
        local.append((p_l, g_l, _local_of(m, mesh, place, backs),
                      _local_of(v, mesh, place, backs)))
        sq = sum(part.float().square().sum()
                 for part in optimizer._parts(g_l))
        sq = DTensor.from_local(sq, mesh, [
            Partial() if isinstance(x, Shard) else Replicate()
            for x in place], run_check=False).full_tensor()
        total = sq if total is None else total + sq
    return local, backs, torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads, opt_state: Dict, params, cfg):
    """ZeRO-1: each leaf's update on this device's shard of its moments.
    The gradient is reduce-scattered (or sliced) to the moments' layout
    and the parameter sliced to it; the update's views are cut by the
    local shapes (indexing a DTensor along a split dim would gather the
    whole leaf for every view); the gradient norm is each shard's sum of
    squares all-reduced; each updated slice (and a moved moment) is then
    gathered back into its tensor."""
    leaves = optimizer._leaf_groups(grads, opt_state, params)
    if not any(isinstance(p, DTensor) for p, _, _, _ in leaves):
        return _ORIG["adamw_update"](grads, opt_state, params, cfg)
    optimizer._check_state_dtype(cfg)
    step = opt_state["step"] + 1
    local, backs, gnorm = _moment_shards(leaves)
    # the step count is replicated: this device's copy
    lr = optimizer._update_leaves(
        local, gnorm, step.to_local() if isinstance(step, DTensor) else step,
        cfg)
    for x, x_l, mesh, place in backs:
        new = DTensor.from_local(x_l, mesh, place, run_check=False)
        x.to_local().copy_(new.redistribute(x.device_mesh,
                                            x.placements).to_local())
    return params, {"m": opt_state["m"], "v": opt_state["v"],
                    "step": step}, {"grad_norm": gnorm, "lr": lr}


# ---- installing -------------------------------------------------------------

# (module that defines it, name) -> the rule that stands in for it
RULES = {
    (layers, "project_heads"): project_heads,
    (layers, "embed"): embed,
    (layers, "unembed"): unembed,
    (layers, "output_head"): output_head,
    (layers, "logz_and_target"): logz_and_target,
    (attention, "project_out"): project_out,
    (attention, "sequence_attention"): sequence_attention,
    (attention, "_decode"): decode,
    (moe, "moe_apply"): moe_apply,
    (ssm, "_mlstm_scan"): mlstm_scan,
    (ssm, "_slstm_scan"): slstm_scan,
    (optimizer, "adamw_update"): adamw_update,
}


@contextlib.contextmanager
def installed() -> Iterator[None]:
    """The rules in place of the originals, in every ``repro_torch``
    module that binds an original, until the block exits."""
    if _ORIG:
        raise RuntimeError("the per-device rules are already installed")
    swaps = []
    for (module, name), rule in RULES.items():
        orig = getattr(module, name)
        _ORIG[name] = orig
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("repro_torch.") and \
                    getattr(mod, name, None) is orig:
                swaps.append((mod, name, orig))
                setattr(mod, name, rule)
    try:
        yield
    finally:
        for mod, name, orig in swaps:
            setattr(mod, name, orig)
        _ORIG.clear()


__all__ = ["installed", "RULES"]
