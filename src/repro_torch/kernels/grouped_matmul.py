"""Grouped (per-expert) matrix product on Hopper: x (E,C,d) @ w (E,d,f) ->
(E,C,f), the expert FFNs of the MoE path, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py``
(``grouped_matmul`` -> ``_gmm_kernel``).  Two CUDA C++ kernels, built for
``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/grouped_matmul_tc.cu`` takes bf16 on the tensor cores
(``mma.sync`` up to 64 rows per expert, ``wgmma`` above, both fed from
a ``cp.async`` ring), and ``csrc/grouped_matmul.cu`` takes f32 on the CUDA
cores (IEEE products: TF32 would miss the f32 tolerance).  Their plain
version is ``ref.gmm_reference``.  :func:`plan` picks the kernel, its
tile, its ring depth and its split of d from the shapes, in Python, so
that the CPU tests check it.

Bound, at Grok-1's shapes on the serving path (E=8, d=6144, f=32768, bf16):
bytes at decode (8 rows per expert: 3.23 GB of weights, 0.963 ms at 3.35
TB/s) and, narrowly, operations in a 512-token prefill chunk (320 rows per
expert: 1.03 TFLOP, 1.04 ms on the tensor cores).  Kimi-K2's (E=384,
d=7168, f=2048; 8 and 28 rows per expert) are bound by bytes.

The wrapper takes strides: x and w may be views whose last axis is
contiguous (one layer's slice of the stacked expert weights goes in
without a copy); any other layout is copied to a contiguous one first.
The output is a new contiguous (E,C,f) tensor.  There is no backward
kernel, in the port or in ``repro``: a call that would need a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from . import build as _build

SOURCE = _build.CSRC / "grouped_matmul.cu"          # f32, CUDA cores
TC_SOURCE = _build.CSRC / "grouped_matmul_tc.cu"    # bf16, tensor cores
SOURCES = (SOURCE, TC_SOURCE)
DTYPES = (torch.float32, torch.bfloat16)
BN = 128                        # output columns per CTA of the f32 kernel
MAX_GRID_YZ = 65535             # column tiles on grid.y, experts on grid.z
MAX_INT = 2 ** 31 - 1           # C, d and f go in as C ints
# Row tiles of the f32 kernel's three variants, smallest first: a launch
# takes the first that holds all C rows, else the largest.
ROW_TILES = (8, 32, 64)
# The bf16 kernel's variants, as ``grouped_matmul_tc.cu::dispatch`` has
# them: (rows, columns, depth of a slice, warps, ring stages); a launch
# takes the first that holds all C rows, else the last.  The first
# ``MMA_SYNC_VARIANTS`` run on mma.sync: 32 rows, the decode regime, and 64
# rows (Kimi-K2's chunk of 3 or 4 rows of 512 tokens).  The rest run on
# wgmma with one CTA over all of a tile's rows, so that w is read once:
# 160 (Grok-1's chunk of one row of 512 tokens) and 320 (of two rows).
TC_VARIANTS = ((32, 128, 64, 4, 4), (64, 128, 64, 8, 4),
               (160, 128, 64, 8, 4), (320, 128, 64, 8, 4))
MMA_SYNC_VARIANTS = 2
SMS = 132                       # streaming multiprocessors of an H100
# Decode is bound by bytes: split d when the grid has fewer CTAs than this,
# and keep at least MIN_SPLIT_SLICES slices of depth in each split.
SPLIT_TARGET = 8 * SMS
MIN_SPLIT_SLICES = 8


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32) or "tensor_core"
    (bf16); ``regime`` "f32", "decode" or "prefill"; ``variant`` the index
    into ``ROW_TILES`` (f32) or ``TC_VARIANTS`` (bf16); the tile
    (``bm`` x ``bn``, slices ``bk`` deep) and ring ``stages``; d split into
    ``split`` ranges of ``chunk`` (the last may be shorter)."""
    kernel: str
    regime: str
    variant: int
    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    chunk: int

# Launches of the CUDA kernel in this process; plain-version calls do not
# count.  A run sets it to 0 and reads it to show which path it took.
launches = 0


def check_args(x, w) -> None:
    """Raise on anything the kernel (and so its plain version) does not
    take."""
    for name, t in dict(x=x, w=w).items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 3:
            raise ValueError(f"{name} must be 3-d, got {tuple(t.shape)}")
    if w.device != x.device or w.dtype != x.dtype:
        raise ValueError(f"w is {w.dtype} on {w.device}; x is {x.dtype} on "
                         f"{x.device}")
    if x.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {x.dtype}")
    E, C, d = x.shape
    if w.shape[:2] != (E, d):
        raise ValueError(f"w {tuple(w.shape)} must be ({E}, {d}, f) for x "
                         f"{tuple(x.shape)}")
    f = w.shape[2]
    if min(E, C, d, f) < 1 or max(C, d, f) > MAX_INT or E > MAX_GRID_YZ \
            or -(-f // BN) > MAX_GRID_YZ:
        raise ValueError(f"need 1 <= E <= {MAX_GRID_YZ}, C, d, f >= 1 and "
                         f"f <= {MAX_GRID_YZ * BN}, got E={E} C={C} d={d} "
                         f"f={f}")


def _holding(tiles, C: int) -> int:
    """Index of the first of ``tiles`` (rows, ascending) that holds C rows,
    else of the last."""
    for i, bm in enumerate(tiles):
        if C <= bm:
            return i
    return len(tiles) - 1


def row_tile(C: int) -> int:
    """Index into ``ROW_TILES`` of the f32 variant that a launch with C rows
    takes."""
    return _holding(ROW_TILES, C)


def plan(E: int, C: int, d: int, f: int, dtype: torch.dtype) -> Plan:
    """The launch of an (E,C,d) @ (E,d,f) call in ``dtype``.

    f32 takes the CUDA-core kernel with the row tile that holds C.  bf16
    takes the tensor-core kernel with the ``TC_VARIANTS`` tile that holds
    C: up to 32 rows the decode regime, above it the prefill regime.  On
    mma.sync d is split when the grid would have fewer than
    ``SPLIT_TARGET`` CTAs (each split at least ``MIN_SPLIT_SLICES`` slices
    deep); the wgmma tiles are not split.
    """
    if dtype == torch.float32:
        t = row_tile(C)
        return Plan("cuda_core", "f32", t, ROW_TILES[t], BN, 16, 2, 1, d)
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    v = _holding(tuple(t[0] for t in TC_VARIANTS), C)
    bm, bn, bk, _, stages = TC_VARIANTS[v]
    slices = -(-d // bk)
    split = 1
    if v < MMA_SYNC_VARIANTS:
        ctas = -(-C // bm) * -(-f // bn) * E
        if ctas < SPLIT_TARGET:
            split = max(1, min(-(-SPLIT_TARGET // ctas),
                               slices // MIN_SPLIT_SLICES))
    chunk = -(-slices // split) * bk
    return Plan("tensor_core", "decode" if bm <= 32 else "prefill", v, bm,
                bn, bk, stages, -(-d // chunk), chunk)


def _bind(lib) -> None:
    fn = lib.grouped_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_tc(lib) -> None:
    fn = lib.grouped_matmul_bf16_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong)] + [ctypes.c_int] * 4 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _vec_ok(t: torch.Tensor) -> bool:
    """Whether every row of ``t`` starts on a 16-byte boundary."""
    per16 = 16 // t.element_size()
    return t.data_ptr() % 16 == 0 and all(s % per16 == 0
                                          for s in t.stride()[:2])


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: x (E,C,d), w (E,d,f) CUDA tensors -> (E,C,f)
    in x's dtype, summed in f32.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs, on inputs
    that need a gradient and on a failed launch; it never falls back to the
    plain version.
    """
    global launches
    check_args(x, w)
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        raise RuntimeError("grouped_matmul has no backward kernel (nor has "
                           "repro's) and serves only: MoE training runs the "
                           "expert einsums (moe_apply(train=True)); call it "
                           "under torch.no_grad()")
    _build.require_card(x.device)
    x, w = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, w))
    E, C, d = x.shape
    f = w.shape[2]
    p = plan(E, C, d, f, x.dtype)
    o = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 6)(*(s for t in (x, w, o)
                                        for s in t.stride()[:2]))
    vec = int(_vec_ok(x) and _vec_ok(w))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.kernel == "cuda_core":
            lib = _build.load(SOURCE, _bind)
            err = lib.grouped_matmul_fwd(
                x.data_ptr(), w.data_ptr(), o.data_ptr(), E, C, d, f,
                strides, p.variant, vec, stream)
        else:
            lib = _build.load(TC_SOURCE, _bind_tc)
            part = (torch.empty(p.split * E * C * f, dtype=torch.float32,
                                device=x.device) if p.split > 1 else None)
            err = lib.grouped_matmul_bf16_fwd(
                x.data_ptr(), w.data_ptr(), o.data_ptr(),
                None if part is None else part.data_ptr(), E, C, d, f,
                strides, p.variant, vec, p.split, p.chunk, stream)
    _build.check(lib, err, "grouped_matmul")
    launches += 1
    return o


__all__ = ["grouped_matmul", "check_args", "row_tile", "plan", "Plan"]
