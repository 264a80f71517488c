"""Grouped (per-expert) matrix product on Hopper: x (E,C,d) @ w (E,d,f) ->
(E,C,f), the expert FFNs of the MoE path, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py``
(``grouped_matmul`` -> ``_gmm_kernel``).  Two CUDA C++ sources, built for
``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/grouped_matmul_tc.cu`` takes bf16 on the tensor cores and
``csrc/grouped_matmul.cu`` takes f32 on the CUDA cores (IEEE products:
TF32 would miss the f32 tolerance).  In bf16, up to 64 rows an expert
(decode, Kimi-K2's prefill chunks: bound by the bytes of w) a persistent,
warp-specialised TMA stream of w into narrow ``wgmma`` (persistent CTAs
that take its (expert, column tile) items in rounds; where items are left
over, they are cut into even ranges of 64-deep slices whose pieces a
second pass adds in a fixed order); above, a warp-specialised ``wgmma`` kernel
fed by a TMA producer warpgroup, its CTAs in clusters along f that share
each slice of x by multicast; rows that TMA cannot read, ``mma.sync`` on
64-row tiles filled with plain loads.  Their plain version is
``ref.gmm_reference``.  :func:`plan` picks the kernel, its tile, its ring
depth, its cluster and its grid from the shapes, and :func:`tma_layout`,
:func:`tma_grid` and the ``stream_*`` functions give the TMA kernels'
tensor maps, grids, shared memory and the stream's walk, in Python, so
that the CPU tests check them.

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
import functools
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
# takes the first that holds all C rows, else the largest; each with its
# thread tile (rows x columns a thread, the source's dispatch_tile): one
# thread a column at decode, 4 x 4, and 8 x 8 at 64 rows (Grok-1's 320-row
# chunk is five whole tiles).
ROW_TILES = (8, 32, 64)
F32_THREAD_TILES = ((8, 1), (4, 4), (8, 8))
# The bf16 kernels' variants, as ``grouped_matmul_tc.cu::dispatch`` has
# them: (rows, columns, depth of a slice, warps, ring stages); a call whose
# rows TMA can read takes the first whose rows hold C, else the last.  The
# first ``STREAM_VARIANTS`` are the small-C stream (``gmm_stream_kernel``)
# up to 32 and 64 rows, bound by the bytes of w: its wgmma width
# (``stream_rows``), ring (``STREAM_STAGES``, 0 here) and grid
# (``stream_ctas``) follow the call.  The
# rest run on wgmma (a producer and two consumer warpgroups) with one CTA
# over all of a tile's rows, so that w is read once: 160 (Grok-1's chunk of
# one row of 512 tokens) and 320 (of two rows), each with as many ring
# slots as shared memory holds.  Rows that TMA cannot read take
# ``SYNC_VARIANT``, mma.sync on ``SYNC_TILE``, whatever C.
STREAM_BN = 256                 # output columns of a stream item
# Ring slots of the stream: 3, 96 KB of w in flight an SM.  The 4 to 6 that
# shared memory holds timed no faster at 8 rows and 1-4% slower at 32
# (tools/torch_kernel_ablate.py, stages4 and stages_max).
STREAM_STAGES = 3
TC_VARIANTS = ((32, STREAM_BN, 64, 5, 0), (64, STREAM_BN, 64, 5, 0),
               (160, 128, 64, 12, 6), (320, 128, 64, 12, 4))
STREAM_VARIANTS = 2
SYNC_VARIANT = 4
SYNC_TILE = (64, 128, 64, 8, 4)
# wgmma widths of the stream (mma_sm90.cuh::wgmma_m64nNk16_ta): a call
# computes C rounded up to the first that holds it.
STREAM_ROWS = (8, 16, 32, 64)
# CTAs per cluster along f on wgmma (the source's kCluster): each loads
# rows / CLUSTER of a slice of x and multicasts them to the others.
CLUSTER = 2
PANEL = 64                      # columns of one TMA box: 128 bytes of bf16
SMEM_LIMIT = 232448             # shared memory a block may use on an H100
SMS = 132                       # streaming multiprocessors of an H100


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32), "stream" (bf16, the
    small-C TMA stream), "wgmma" (bf16, the warp-specialised prefill
    kernel) or "tensor_core" (bf16 on mma.sync, rows TMA cannot read);
    ``regime`` "f32", "decode" (C <= 32) or "prefill"; ``variant`` the
    index into ``ROW_TILES`` (f32) or ``TC_VARIANTS`` (bf16; or
    ``SYNC_VARIANT``); the tile (``bm`` x ``bn``, slices ``bk`` deep; for
    the stream ``bm`` is its wgmma width and ``bn`` an item's columns) and
    ring ``stages``; ``cluster`` CTAs per cluster along f (1 off wgmma);
    ``ctas`` the stream's persistent CTAs (0 off it)."""
    kernel: str
    regime: str
    variant: int
    bm: int
    bn: int
    bk: int
    stages: int
    cluster: int = 1
    ctas: int = 0

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


@functools.lru_cache(maxsize=256)
def plan(E: int, C: int, d: int, f: int, dtype: torch.dtype,
         tma: bool = True) -> Plan:
    """The launch of an (E,C,d) @ (E,d,f) call in ``dtype``; ``tma``
    whether TMA can read x and w (16-byte aligned bases and strides).

    f32 takes the CUDA-core kernel with the row tile that holds C.  bf16
    takes, up to 64 rows, the small-C stream over ``stream_ctas``
    persistent CTAs, and above, the ``TC_VARIANTS``
    wgmma tile that holds C, in clusters of ``CLUSTER``; where TMA cannot
    read the operands, ``SYNC_TILE`` on mma.sync.  Up to 32 rows is the
    decode regime, above it prefill.
    """
    if dtype == torch.float32:
        t = row_tile(C)
        return Plan("cuda_core", "f32", t, ROW_TILES[t], BN, 16, 2)
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    regime = "decode" if C <= 32 else "prefill"
    if not tma:
        bm, bn, bk, _, stages = SYNC_TILE
        return Plan("tensor_core", regime, SYNC_VARIANT, bm, bn, bk, stages)
    v = _holding(tuple(t[0] for t in TC_VARIANTS), C)
    if v < STREAM_VARIANTS:
        rows = stream_rows(C)
        cols, slices, _ = stream_units(E, d, f, STREAM_BN)
        return Plan("stream", regime, v, rows, STREAM_BN, PANEL,
                    min(STREAM_STAGES, stream_stages(rows, STREAM_BN)), 1,
                    stream_ctas(E * cols, slices))
    bm, bn, bk, _, stages = TC_VARIANTS[v]
    return Plan("wgmma", regime, v, bm, bn, bk, stages, CLUSTER)


def f32_smem_bytes(p: Plan) -> int:
    """Static shared memory of one f32 CTA: ``stages`` buffers of a slice
    of x (``bk`` x ``bm``, k-major) and of w (``bk`` x ``bn``)."""
    return p.stages * p.bk * (p.bm + p.bn) * 4


def f32_threads(p: Plan) -> int:
    """Threads of one f32 CTA: one per thread tile of the CTA's tile."""
    tm, tn = F32_THREAD_TILES[p.variant]
    return p.bm // tm * (p.bn // tn)


def f32_grid(p: Plan, E: int, C: int, f: int) -> tuple:
    """The f32 launch's grid: row tiles (the fastest, so that the row
    tiles of a column tile run together), column tiles, experts."""
    return (-(-C // p.bm), -(-f // p.bn), E)


def f32_thread_outputs(p: Plan, tid: int) -> list:
    """The Python twin of the f32 kernel's outputs of thread ``tid``, as
    (row, column) offsets in its CTA's tile: with a TM x TN thread tile,
    threads ty = tid // (bn / TN) and tx = tid % (bn / TN) hold rows ty TM
    + i (i < TM) and, in runs of nv = min(TN, 4) columns, columns g bn /
    (TN / nv) + tx nv + j (g < TN / nv, j < nv)."""
    tm, tn = F32_THREAD_TILES[p.variant]
    cols = p.bn // tn
    ty, tx = divmod(tid, cols)
    nv = min(tn, 4)
    ng = tn // nv
    return [(ty * tm + i, g * (p.bn // ng) + tx * nv + j)
            for i in range(tm) for g in range(ng) for j in range(nv)]


def stream_rows(C: int) -> int:
    """The stream's wgmma width for C rows: the first of ``STREAM_ROWS``
    that holds them."""
    return STREAM_ROWS[_holding(STREAM_ROWS, C)]


def stream_ctas(items: int, slices: int) -> int:
    """The stream's persistent CTAs: ``SMS``, or, where a count down to
    15/16 of them divides the items into whole rounds, the largest such
    count, so that no item is cut and the call needs no second pass (the
    stream is bound by the bytes of w, which 128 SMs moved as fast as 132:
    ``tools/torch_kernel_ablate.py``'s ``ctas132``); fewer when the call
    has fewer slices."""
    for ctas in range(SMS, SMS - SMS // 16 - 1, -1):
        if items % ctas == 0:
            return ctas
    return min(SMS, items * slices)


def stream_smem_bytes(rows: int, bn: int, stages: int) -> int:
    """Dynamic shared memory of one stream CTA (the source's
    ``StreamTile::smem``): 1024 bytes to align the base, ``stages`` ring
    slots of a slice of w (64 x bn) and of x (rows x 64), each with a full
    and an empty mbarrier, and the staged output tile (rows of bn + 8)."""
    return 1024 + stages * (PANEL * bn * 2 + rows * PANEL * 2 + 16) \
        + rows * (bn + 8) * 2


def stream_stages(rows: int, bn: int) -> int:
    """The most ring slots of the stream that shared memory holds."""
    slot = PANEL * bn * 2 + rows * PANEL * 2 + 16
    return (SMEM_LIMIT - stream_smem_bytes(rows, bn, 0)) // slot


def stream_units(E: int, d: int, f: int, bn: int) -> tuple:
    """(column tiles, slices of d per item, units): the stream's items are
    (expert, column tile) in that order, each ``slices`` 64-deep slices;
    a unit is one slice of one item."""
    cols, slices = -(-f // bn), -(-d // PANEL)
    return cols, slices, E * cols * slices


def stream_ranges(items: int, slices: int, ctas: int) -> list:
    """The stream's CTAs take the items in rounds, CTA c item r ctas + c
    of round r; the items left after the last full round are cut into
    ``ctas`` ranges of their units, CTA c's [c rest // ctas, (c + 1) rest
    // ctas), counted from the first of them, as the kernel computes
    them."""
    rest = items % ctas * slices
    return [(c * rest // ctas, (c + 1) * rest // ctas) for c in range(ctas)]


def stream_pieces(p: Plan, E: int, d: int, f: int) -> list:
    """The Python twin of ``gmm_stream_kernel``'s walk (``stream_walk``):
    for each CTA, its pieces (expert, first column, first and end slice,
    scratch slot) in order; the slot is None for a whole item (stored as
    bf16 in o), else 0 for the piece that starts the CTA's range of the
    items left after the rounds and 1 for the one that ends it (f32 sums
    to scratch)."""
    cols, slices, _ = stream_units(E, d, f, p.bn)
    items = E * cols
    rounds = items // p.ctas
    first = rounds * p.ctas
    out = []
    for c, (lo, hi) in enumerate(stream_ranges(items, slices, p.ctas)):
        pieces = [(r * p.ctas + c, 0, slices, None) for r in range(rounds)]
        u = lo
        while u < hi:
            item, s0 = divmod(u, slices)
            s1 = min(slices, s0 + hi - u)
            whole = s0 == 0 and s1 == slices
            pieces.append((first + item, s0, s1,
                           None if whole else int(u != lo)))
            u += s1 - s0
        out.append([(item // cols, item % cols * p.bn, s0, s1, slot)
                    for item, s0, s1, slot in pieces])
    return out


def stream_folds(p: Plan, E: int, d: int, f: int) -> dict:
    """The Python twin of ``gmm_stream_fold_kernel``: item -> the (CTA,
    slot) of its pieces in the order their sums are added, for every item
    that a CTA's range cuts."""
    cols, slices, _ = stream_units(E, d, f, p.bn)
    items = E * cols
    first = items // p.ctas * p.ctas
    lo = [r[0] for r in stream_ranges(items, slices, p.ctas)]
    lo.append((items - first) * slices)
    out = {}
    for c in range(1, p.ctas):
        item = lo[c] // slices
        start, end = item * slices, (item + 1) * slices
        if lo[c] == start or lo[c - 1] > start:
            continue
        cc, pieces = c - 1, []
        while cc < p.ctas and lo[cc] < end:
            if lo[cc + 1] != lo[cc]:
                pieces.append((cc, 0 if lo[cc] // slices == item else 1))
            cc += 1
        out[first + item] = pieces
    return out


@functools.lru_cache(maxsize=256)
def stream_cuts(items: int, slices: int, ctas: int) -> bool:
    """Whether some CTA's range of the items left after the rounds starts
    inside an item, so that the call needs scratch and the second pass
    (the source's ``stream_cuts``)."""
    rest = items % ctas * slices
    return any(c * rest // ctas % slices for c in range(1, ctas))


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
    them.  x takes rows = bm / cluster on wgmma (each CTA of a cluster
    loads its share of the token tile) and the stream's width bm (rows
    past C read as zeros: R is C), w takes rows = bk."""
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
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int,
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.grouped_matmul_bf16_stream
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 8 + [
        ctypes.POINTER(ctypes.c_longlong)] * 2 + [ctypes.c_void_p]
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
        elif p.kernel == "stream":
            lib = _build.load(TC_SOURCE, _bind_tc)
            cols, slices, _ = stream_units(E, d, f, p.bn)
            part = (torch.empty(p.ctas * 2 * p.bn * p.bm,
                                dtype=torch.float32, device=x.device)
                    if stream_cuts(E * cols, slices, p.ctas) else None)
            maps = (ctypes.c_longlong * 16)(*tma_layout(x, p.bm),
                                            *tma_layout(w, p.bk))
            err = lib.grouped_matmul_bf16_stream(
                x.data_ptr(), w.data_ptr(), o.data_ptr(),
                None if part is None else part.data_ptr(), E, C, d, f,
                p.bm, p.bn, p.stages, p.ctas, maps,
                (ctypes.c_longlong * 2)(*o.stride()[:2]), stream)
        else:
            lib = _build.load(TC_SOURCE, _bind_tc)
            maps = None
            if p.kernel == "wgmma":
                maps = (ctypes.c_longlong * 16)(
                    *tma_layout(x, p.bm // p.cluster), *tma_layout(w, p.bk))
            err = lib.grouped_matmul_bf16_fwd(
                x.data_ptr(), w.data_ptr(), o.data_ptr(), E, C, d, f,
                strides, p.variant, maps, p.cluster, stream)
    _build.check(lib, err, "grouped_matmul")
    launches += 1
    return o


__all__ = ["grouped_matmul", "check_args", "row_tile", "plan", "Plan",
           "f32_smem_bytes", "f32_threads", "f32_grid", "f32_thread_outputs",
           "stream_rows", "stream_ctas", "stream_smem_bytes", "stream_stages",
           "stream_units", "stream_ranges", "stream_pieces", "stream_folds",
           "stream_cuts", "tma_smem_bytes", "tma_layout", "tma_grid"]
