"""Flash decoding on Hopper: one query token per (batch, kv head), with its
G grouped query heads, against a long KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``flash_decode`` -> ``_decode_kernel``).  Two CUDA C++ kernels, built for
``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/flash_decode_tc.cu`` takes bf16 on the tensor cores (``mma.sync``,
K and V through a 3-stage ``cp.async`` ring, a split per row chosen on the
device from ``lengths`` and folded inside one launch by a thread-block
cluster), and ``csrc/flash_decode.cu`` takes f32 on the CUDA cores
(flash-decoding with a second combine pass; TF32 would miss the f32
tolerance).  Their plain version is ``ref.decode_reference``; :func:`plan`
says which kernel, tile and split a call takes.

Bound: bytes.  The kernel streams each valid K and V row once, about 2
flops per byte at G=4 in bf16; at the decode_32k shape (B=16, K=8, G=4,
T=32768, D=128) that is 2.147 GB, 0.641 ms at 3.35 TB/s.  Both kernels
split T among CTAs so that B*K alone, 64 rows for 8 slots x 8 kv heads,
does not leave half the 132 SMs idle.

Precondition: ``1 <= lengths[b] <= T``.  The reference leaves a length
of 0 undefined, and the wrapper does not read ``lengths`` on the host (that
would cost a sync per layer).  k and v are read through strides, so the
model's (B,T,K,D) cache goes in as a (B,K,T,D) view without a copy.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build as _build
from .flash_attention import DTYPES, HEAD_DIMS, kernel_layout

SOURCE = _build.CSRC / "flash_decode.cu"          # f32, CUDA cores
TC_SOURCE = _build.CSRC / "flash_decode_tc.cu"    # bf16, tensor cores
SOURCES = (SOURCE, TC_SOURCE)
MAX_GROUP = 8                   # query heads per kv head the kernels hold
TILE = 128                      # CUDA-core kernel: keys per tile of a chunk
SMS = 132                       # streaming multiprocessors of an H100
CTAS_PER_SM = 8                 # its split aims at this many CTAs per SM
MAX_GRID_Y = 65535              # both kernels put B*K on grid.y
# The tensor-core kernel: keys per tile, tiles in its cp.async ring, warps
# per CTA (16 keys of a tile each), CTAs an SM holds (104 KB of shared
# memory each at D=128) and CTAs per row (a portable cluster).
TC_TILE = 64
TC_STAGES = 3
TC_WARPS = 4
TC_CTAS_PER_SM = 2
MAX_SPLIT = 8


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32) or "tensor_core"
    (bf16); keys in tiles of ``tile`` through a ring of ``stages`` buffers;
    ``split`` CTAs per (b, kv head) row; ``grid`` (split, B*K)."""
    kernel: str
    tile: int
    stages: int
    split: int
    grid: Tuple[int, int]


# Launches of the CUDA kernel in this process; plain-version calls do not
# count.  A run sets it to 0 and reads it to show which path it took.
launches = 0


def check_args(q, k, v, lengths) -> None:
    """Raise on anything the kernel (and so its plain version) does not
    take."""
    for name, t in dict(q=q, k=k, v=v, lengths=lengths).items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {q.dtype}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError(f"k, v must be {q.dtype}, got {k.dtype}, {v.dtype}")
    if q.dim() != 4:
        raise ValueError(f"q must be (B,K,G,D), got {tuple(q.shape)}")
    B, K, G, D = q.shape
    if k.dim() != 4 or k.shape != v.shape or tuple(k.shape[:2]) != (B, K) \
            or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, {K}, T, {D})")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"need 1 <= G <= {MAX_GROUP} query heads per kv "
                         f"head, got {G}")
    if min(B, K, k.shape[2]) < 1 or B * K > MAX_GRID_Y:
        raise ValueError(f"need B, K, T >= 1 and B*K <= {MAX_GRID_Y}, got "
                         f"B={B} K={K} T={k.shape[2]}")
    if tuple(lengths.shape) != (B,) or lengths.dtype not in (torch.int32,
                                                             torch.int64):
        raise ValueError(f"lengths must be ({B},) int32 or int64, got "
                         f"{tuple(lengths.shape)} {lengths.dtype}")


def split(n_rows: int, T: int):
    """(chunk, n_chunks): the split of T among CTAs for ``n_rows`` = B*K
    rows, aiming at ``CTAS_PER_SM * SMS`` CTAs; chunk is whole tiles."""
    n_tiles = -(-T // TILE)
    chunks = max(1, min(n_tiles, -(-CTAS_PER_SM * SMS // n_rows)))
    chunk = -(-n_tiles // chunks) * TILE
    return chunk, -(-T // chunk)


def plan(B: int, K: int, G: int, T: int, D: int,
         dtype: torch.dtype) -> Plan:
    """The launch of a call with q (B,K,G,D) and a T-key cache in
    ``dtype``.  f32: the CUDA-core kernel, T split by :func:`split`.  bf16:
    the tensor-core kernel, as many CTAs per row (a cluster) as the card
    holds at ``TC_CTAS_PER_SM`` per SM, at most ``MAX_SPLIT`` and at most
    T's tiles, and at most 2 once B*K is a quarter of the SMs (2 per row
    then keep at least half of them streaming): a larger cluster costs more
    to launch and fold than its bandwidth gains there.  Each CTA takes its
    share of the live keys on the device (:func:`tc_chunk`)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if not 1 <= G <= MAX_GROUP:
        raise ValueError(f"need 1 <= G <= {MAX_GROUP}, got {G}")
    if dtype == torch.float32:
        _, n_chunks = split(B * K, T)
        return Plan("cuda_core", TILE, 1, n_chunks, (n_chunks, B * K))
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    n = max(1, min(MAX_SPLIT, TC_CTAS_PER_SM * SMS // (B * K),
                   -(-T // TC_TILE)))
    if 4 * B * K >= SMS:
        n = min(n, 2)
    return Plan("tensor_core", TC_TILE, TC_STAGES, n, (n, B * K))


def tc_chunk(rank: int, n_split: int, length: int) -> Tuple[int, int]:
    """Keys [begin, end) that CTA ``rank`` of a row's ``n_split`` takes in
    the tensor-core kernel: a balanced share of the row's whole live tiles,
    cut at ``length`` (the kernel computes the same on the device)."""
    n_live = -(-max(length, 0) // TC_TILE)
    lo = rank * n_live // n_split
    hi = (rank + 1) * n_live // n_split
    return lo * TC_TILE, max(lo * TC_TILE, min(hi * TC_TILE, length))


def _bind(lib) -> None:
    fn = lib.flash_decode_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_tc(lib) -> None:
    fn = lib.flash_decode_bf16_fwd
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.flash_decode_bf16_max_clusters
    fn.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    fn.restype = ctypes.c_int


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor, *,
                 kernel: str | None = None) -> torch.Tensor:
    """The kernels' wrapper: q (B,K,G,D), k/v (B,K,T,D), lengths (B,) CUDA
    tensors -> (B,K,G,D) in q's dtype, on the kernel :func:`plan` picks.
    ``kernel="cuda_core"`` takes the CUDA-core kernel for bf16 as well, so
    that a run can time the two side by side.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs and on a failed
    launch; it never falls back to the plain version.
    """
    global launches
    check_args(q, k, v, lengths)
    if kernel not in (None, "cuda_core"):
        raise ValueError(f"kernel must be None or 'cuda_core', got {kernel!r}")
    _build.require_card(q.device)
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    lengths = lengths.to(torch.int32).contiguous()
    B, K, G, D = q.shape
    T = k.shape[2]
    p = plan(B, K, G, T, D, q.dtype)
    dev = q.device
    o = torch.empty((B, K, G, D), dtype=q.dtype, device=dev)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        if p.kernel == "tensor_core" and kernel is None:
            lib = _build.load(TC_SOURCE, _bind_tc)
            err = lib.flash_decode_bf16_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), B, K, G, T, D, p.split, strides, D ** -0.5,
                stream)
        else:
            lib = _build.load(SOURCE, _bind)
            chunk, n_chunks = split(B * K, T)
            n_part = B * K * n_chunks * G
            part_m = torch.empty(n_part, dtype=torch.float32, device=dev)
            part_l = torch.empty(n_part, dtype=torch.float32, device=dev)
            part_acc = torch.empty(n_part * D, dtype=torch.float32,
                                   device=dev)
            err = lib.flash_decode_fwd(
                q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
                o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
                part_acc.data_ptr(), B, K, G, T, D, chunk, n_chunks, strides,
                D ** -0.5, int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "flash_decode")
    launches += 1
    return o


def max_active_clusters(D: int, n_split: int) -> int:
    """How many clusters of ``n_split`` CTAs of the tensor-core kernel at
    head dim ``D`` the current card holds at once."""
    lib = _build.load(TC_SOURCE, _bind_tc)
    out = ctypes.c_int(0)
    _build.check(lib, lib.flash_decode_bf16_max_clusters(
        D, n_split, ctypes.byref(out)), "flash_decode occupancy")
    return out.value


__all__ = ["flash_decode", "check_args", "split", "plan", "Plan", "tc_chunk",
           "max_active_clusters"]
