"""Per-device cost of the port's program, counted op by op: the
counterpart of ``repro.launch.hlo_cost``.

The reference re-derives FLOPs, HBM bytes and collective bytes from the
optimized HLO text, because ``cost_analysis()`` visits a scanned body
once.  The port produces no HLO: it runs eager ATen ops, so ``OpCost``, a
``TorchDispatchMode``, sees the program itself as it runs (on ``meta``
tensors in the dry run, on the card in a check), one op at a time:

  * FLOPs: ``torch.utils.flop_counter``'s formula for each op it knows
    (the matmuls, convolutions and attention ops), as ``FlopCounterMode``
    counts, decomposing an op it does not know first, as it does;
  * HBM bytes: operand + output bytes of every op that moves data (an
    eager op is a kernel that reads its operands and writes its output;
    views, factories of uninitialised memory and metadata queries move
    nothing);
  * collective bytes: operand bytes of every functional collective, by
    the reference's kind names (``COLLECTIVE_OPS``); they count toward
    the HBM bytes too, as the reference's do;
  * a kernel call of ``kernels.ops`` on ``meta``: its ``kernels.cost``
    formula (``charge_kernel``), counted by name;
  * live bytes: each output's storage from its op until it is freed, on
    top of ``track``ed arguments; ``peak_bytes`` is the most at once, and
    ``read`` the storages some op read data from (views read nothing; an
    argument no op reads is one ``jax.jit`` would have dropped).

Each op is charged by its LOCAL shapes.  A DTensor op is left to DTensor
(``__torch_dispatch__`` returns ``NotImplemented`` for it), which turns it
into the collectives that its redistribution needs and the op on each
device's shard, and those come back here as plain ops.  The ops DTensor
runs on fake tensors of the global shapes to propagate shapes are not
counted.

Loop multiplicity is exact by construction, where the reference explains
its ``known_trip_count`` handling: eager runs unroll the layers, the
microbatches and ``torch.utils.checkpoint``'s recompute, so each trip is
counted as it runs.
"""

from __future__ import annotations

import contextlib
import weakref
from collections import Counter
from typing import Dict, Iterator

import torch
from torch.distributed.tensor import DTensor
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

from repro_torch.kernels import cost as kcost

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                  "collective-permute")
# functional-collective op name (``_c10d_functional[_autograd]``) -> kind
_COLLECTIVE_KIND = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce", "all_reduce_": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute", "broadcast_": "collective-permute",
}
_COLLECTIVE_NS = ("_c10d_functional", "_c10d_functional_autograd")
_FREE_NS = _COLLECTIVE_NS + ("prim",)
# ops that allocate without writing, or move no data
_FREE_OPS = {"empty", "empty_strided", "new_empty", "new_empty_strided",
             "empty_like", "lift_fresh", "_local_scalar_dense",
             "is_same_size", "record_stream", "set_"}
# skipped by ``FlopCounterMode`` (metadata queries)
_META_QUERIES = {"sym_is_contiguous", "is_contiguous", "is_strides_like_format",
                 "is_non_overlapping_and_dense", "size", "sym_size", "stride",
                 "sym_stride", "storage_offset", "sym_storage_offset", "numel",
                 "sym_numel", "dim"}


def _nbytes(t: torch.Tensor) -> int:
    """Bytes a kernel touches of ``t``: its elements, or its storage where
    that is smaller (a broadcast view reads its storage once)."""
    n = t.numel() * t.element_size()
    try:
        return min(n, t.untyped_storage().nbytes())
    except (RuntimeError, NotImplementedError):
        return n


def _is_view(func) -> bool:
    """Whether ``func`` returns an alias of an input without writing it."""
    rets = func._schema.returns
    return bool(rets) and all(r.alias_info is not None
                              and not r.alias_info.is_write for r in rets)


def _fake_mode_active() -> bool:
    return torch._C._get_dispatch_mode(
        torch._C._TorchDispatchModeKey.FAKE) is not None


class OpCost(TorchDispatchMode):
    """Counts the ops run under it, per device (see the module's doc).

    Enter it with ``counting()``, which also makes it the counter that
    ``kernels.ops``'s meta branch charges.  ``flops``, ``bytes``,
    ``collectives`` (bytes by kind), ``kernels`` (calls by name),
    ``live_bytes`` and ``peak_bytes`` (after ``track``)."""

    def __init__(self) -> None:
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.collectives: Dict[str, float] = {k: 0.0 for k in COLLECTIVE_OPS}
        self.kernels: Counter = Counter()
        self.live_bytes = 0
        self.peak_bytes = 0
        self._storages: Dict[int, weakref.ref] = {}
        self.read: set = set()        # storages some op read (``_cdata``)

    # -- memory ----------------------------------------------------------------
    def track(self, tree) -> int:
        """Count the storages of ``tree``'s tensors (a DTensor's local
        shard) as live until they are freed; returns the bytes newly
        counted."""
        added = 0
        for t in tree_flatten(tree)[0]:
            if isinstance(t, DTensor):
                t = t._local_tensor
            if isinstance(t, torch.Tensor):
                added += self._track_storage(t)
        return added

    def _track_storage(self, t: torch.Tensor) -> int:
        try:
            st = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return 0
        key = st._cdata
        ref = self._storages.get(key)
        if ref is not None and ref() is not None:
            return 0
        n = st.nbytes()
        self._storages[key] = weakref.ref(st, lambda _, k=key, n=n:
                                          self._free(k, n))
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        return n

    def _free(self, key: int, n: int) -> None:
        if self._storages.pop(key, None) is not None:
            self.live_bytes -= n

    # -- kernels ---------------------------------------------------------------
    def _mark_read(self, tensors) -> None:
        for t in tensors:
            self.read.add(t.untyped_storage()._cdata)

    def charge_kernel(self, name: str, flops: int, nbytes: int,
                      operands=()) -> None:
        """One call of kernel ``name`` doing ``flops`` and moving
        ``nbytes`` on this device, reading ``operands``."""
        self._mark_read(operands)
        self.kernels[name] += 1
        self.flops += flops
        self.bytes += nbytes

    # -- the mode --------------------------------------------------------------
    @contextlib.contextmanager
    def counting(self) -> Iterator["OpCost"]:
        """The mode, with the kernels' meta branch charging it too."""
        with self, kcost.charging(self):
            yield self

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented          # DTensor desugars it first
        if _fake_mode_active():            # DTensor's shape propagation
            return func(*args, **kwargs)
        ns = func.namespace
        name = func._schema.name.split("::")[-1]
        if ns == "aten" and name in _META_QUERIES:
            return func(*args, **kwargs)
        if func not in flop_registry and ns not in _FREE_NS:
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        out = func(*args, **kwargs)
        self._charge(func, ns, name, args, kwargs, out)
        for t in tree_flatten(out)[0]:
            if isinstance(t, torch.Tensor):
                self._track_storage(t)
        return out

    def _charge(self, func, ns, name, args, kwargs, out) -> None:
        ins = [t for t in tree_flatten((args, kwargs))[0]
               if isinstance(t, torch.Tensor)]
        outs = [t for t in tree_flatten(out)[0] if isinstance(t, torch.Tensor)]
        if ns in _COLLECTIVE_NS:
            self._mark_read(ins)
            kind = _COLLECTIVE_KIND.get(name)
            if kind is not None:
                n = sum(_nbytes(t) for t in ins)
                self.collectives[kind] += n
                self.bytes += n + sum(_nbytes(t) for t in outs)
            return
        if ns == "prim" or name in _FREE_OPS or _is_view(func):
            return
        self._mark_read(ins)
        packet = func._overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs,
                                                out_val=out)
        self.bytes += sum(_nbytes(t) for t in ins + outs)


__all__ = ["OpCost", "COLLECTIVE_OPS"]
