"""Grouped (per-expert) matrix product on Hopper: x (E,C,d) @ w (E,d,f) ->
(E,C,f), the expert FFNs of the MoE path, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py``
(``grouped_matmul`` -> ``_gmm_kernel``).  Two CUDA C++ kernels, built for
``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/grouped_matmul_tc.cu`` takes bf16 on the tensor cores
(``mma.sync`` from a ``cp.async`` ring up to 64 rows per expert; above, a
warp-specialised ``wgmma`` kernel fed by a TMA producer warpgroup, its
CTAs in clusters along f that share each slice of x by multicast), and
``csrc/grouped_matmul.cu`` takes f32 on the CUDA cores (IEEE products:
TF32 would miss the f32 tolerance).  Their plain version is
``ref.gmm_reference``.  :func:`plan` picks the kernel, its tile, its ring
depth, its cluster and its split of d from the shapes, and
:func:`tma_layout` and :func:`tma_grid` give the wgmma kernel's tensor
maps and grid, in Python, so that the CPU tests check them.

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
# The bf16 kernel's variants, as ``grouped_matmul_tc.cu::dispatch`` and
# ``dispatch_tma`` have them: (rows, columns, depth of a slice, warps, ring
# stages); a launch takes the first that holds all C rows, else the last.
# The first ``MMA_SYNC_VARIANTS`` run on mma.sync: 32 rows, the decode
# regime, and 64 rows (Kimi-K2's chunk of 3 or 4 rows of 512 tokens).  The
# rest run on wgmma (a producer and two consumer warpgroups) with one CTA
# over all of a tile's rows, so that w is read once: 160 (Grok-1's chunk of
# one row of 512 tokens) and 320 (of two rows), each with as many ring
# slots as shared memory holds.  Rows that TMA cannot read take the 64-row
# mma.sync tile.
TC_VARIANTS = ((32, 128, 64, 4, 4), (64, 128, 64, 8, 4),
               (160, 128, 64, 12, 6), (320, 128, 64, 12, 4))
MMA_SYNC_VARIANTS = 2
# CTAs per cluster along f on wgmma (the source's kCluster): each loads
# rows / CLUSTER of a slice of x and multicasts them to the others.
CLUSTER = 2
PANEL = 64                      # columns of one TMA box: 128 bytes of bf16
SMEM_LIMIT = 232448             # shared memory a block may use on an H100
SMS = 132                       # streaming multiprocessors of an H100
# Decode is bound by bytes: split d when the grid has fewer CTAs than this,
# and keep at least MIN_SPLIT_SLICES slices of depth in each split.
SPLIT_TARGET = 8 * SMS
MIN_SPLIT_SLICES = 8


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32), "tensor_core" (bf16
    on mma.sync) or "wgmma" (bf16, the warp-specialised TMA kernel);
    ``regime`` "f32", "decode" or "prefill"; ``variant`` the index
    into ``ROW_TILES`` (f32) or ``TC_VARIANTS`` (bf16); the tile
    (``bm`` x ``bn``, slices ``bk`` deep) and ring ``stages``; d split into
    ``split`` ranges of ``chunk`` (the last may be shorter); ``cluster``
    CTAs per cluster along f (1 off wgmma)."""
    kernel: str
    regime: str
    variant: int
    bm: int
    bn: int
    bk: int
    stages: int
    split: int
    chunk: int
    cluster: int = 1

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


def plan(E: int, C: int, d: int, f: int, dtype: torch.dtype,
         tma: bool = True) -> Plan:
    """The launch of an (E,C,d) @ (E,d,f) call in ``dtype``; ``tma``
    whether TMA can read x and w (16-byte aligned bases and strides).

    f32 takes the CUDA-core kernel with the row tile that holds C.  bf16
    takes the tensor-core kernel with the ``TC_VARIANTS`` tile that holds
    C: up to 32 rows the decode regime, above it the prefill regime (on
    mma.sync up to 64 rows and wherever TMA cannot read the operands, on
    wgmma in clusters of ``CLUSTER`` above).  On mma.sync d is split when
    the grid would have fewer than ``SPLIT_TARGET`` CTAs (each split at
    least ``MIN_SPLIT_SLICES`` slices deep); the wgmma tiles are not split.
    """
    if dtype == torch.float32:
        t = row_tile(C)
        return Plan("cuda_core", "f32", t, ROW_TILES[t], BN, 16, 2, 1, d)
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    v = _holding(tuple(t[0] for t in TC_VARIANTS), C)
    if not tma:
        v = min(v, MMA_SYNC_VARIANTS - 1)
    bm, bn, bk, _, stages = TC_VARIANTS[v]
    slices = -(-d // bk)
    split = 1
    if v < MMA_SYNC_VARIANTS:
        ctas = -(-C // bm) * -(-f // bn) * E
        if ctas < SPLIT_TARGET:
            split = max(1, min(-(-SPLIT_TARGET // ctas),
                               slices // MIN_SPLIT_SLICES))
    chunk = -(-slices // split) * bk
    wgmma = v >= MMA_SYNC_VARIANTS
    return Plan("wgmma" if wgmma else "tensor_core",
                "decode" if bm <= 32 else "prefill", v, bm, bn, bk, stages,
                -(-d // chunk), chunk, CLUSTER if wgmma else 1)


def tma_smem_bytes(variant: int) -> int:
    """Dynamic shared memory of one wgmma CTA (the source's
    ``TmaTile::kSmem``): the ring of slices of w (bk x bn) and x (bm x bk),
    a full and an empty mbarrier a slot, and 1024 bytes to align the
    base.  The epilogue's staged output tile reuses the ring."""
    bm, bn, bk, _, stages = TC_VARIANTS[variant]
    return stages * (bk * bn + bm * bk) * 2 + 2 * stages * 8 + 1024


def tma_layout(t: torch.Tensor, rows: int) -> tuple:
    """The 3-d bf16 tensor map over t (E, R, K), read through its strides:
    dims (K, R, E) innermost first, the byte strides of R and E, and the
    box (PANEL, rows, 1): 128-byte rows, as the 128-byte swizzle takes
    them.  x takes rows = bm / cluster (each CTA of a cluster loads its
    share of the token tile), w takes rows = bk."""
    E, R, K = t.shape
    se, sr, sk = t.stride()
    if sk != 1:
        raise ValueError(f"the last dimension must be contiguous, got "
                         f"strides {t.stride()}")
    es = t.element_size()
    return (K, R, E, sr * es, se * es, PANEL, rows, 1)


def tma_grid(p: Plan, E: int, C: int, f: int) -> tuple:
    """The wgmma launch's grid: column tiles of ``bn`` rounded up to whole
    clusters (a CTA past f loads zeros and stores nothing), token tiles of
    ``bm``, experts."""
    cols = -(-f // p.bn)
    return (-(-cols // p.cluster) * p.cluster, -(-C // p.bm), E)


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
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
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
    vec = int(_vec_ok(x) and _vec_ok(w))
    p = plan(E, C, d, f, x.dtype, tma=bool(vec))
    o = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 6)(*(s for t in (x, w, o)
                                        for s in t.stride()[:2]))
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
            maps = None
            if p.variant >= MMA_SYNC_VARIANTS:
                maps = (ctypes.c_longlong * 16)(
                    *tma_layout(x, p.bm // p.cluster), *tma_layout(w, p.bk))
            err = lib.grouped_matmul_bf16_fwd(
                x.data_ptr(), w.data_ptr(), o.data_ptr(),
                None if part is None else part.data_ptr(), E, C, d, f,
                strides, p.variant, vec, p.split, p.chunk, maps, p.cluster,
                stream)
    _build.check(lib, err, "grouped_matmul")
    launches += 1
    return o


__all__ = ["grouped_matmul", "check_args", "row_tile", "plan", "Plan",
           "tma_smem_bytes", "tma_layout", "tma_grid"]
