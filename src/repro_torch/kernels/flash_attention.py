"""Flash attention forward (prefill) on Hopper: GQA, causal and/or sliding
window, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``).  Two CUDA C++ kernels, built
for ``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/flash_attention_wgmma.cu`` takes bf16 on the tensor cores
(FlashAttention-3's shape: a TMA producer warpgroup and two consumer
warpgroups on ``wgmma``, P kept in registers), and
``csrc/flash_attention.cu`` takes f32 on the CUDA cores (IEEE products:
TF32 would miss the f32 tolerance; 8 x 8 thread tiles in both products,
K and V streamed through a ring of 64-column panels by cp.async).  Their
plain version is ``ref.mha_reference``; :func:`plan` says which kernel
and which blocks a call takes, and :func:`tma_layout`, :func:`key_tiles`
and :func:`mask_free` are the host-side and Python twins of the bf16
kernel's tensor maps, key-tile range and mask test, :func:`f32_smem_bytes`,
:func:`f32_thread_scores`, :func:`f32_thread_outputs` and
:func:`f32_k_swizzle` those of the f32 kernel's shared memory, thread
tiles and K layout, which the CPU tests check.

Bound: operations.  At the prefill shape the model drives (B=4, H=32,
K=8, S=T=2048, D=128, causal) the work is 137.5 GFLOP against 167.8 MB:
0.139 ms on the bf16 tensor cores, 2.05 ms at the f32 rate.

The wrapper takes strides: q, k and v may be (B,H,S,D) / (B,K,T,D) views
of the model's (B,S,H,D) / (B,T,K,D) tensors, read in place (the bf16
kernel's tensor maps describe the views), and the output is allocated
with q's memory layout, so the model's transpose back is free.  A tensor
whose last dimension is not contiguous or whose base or strides are not
16-byte aligned (which TMA cannot describe) is copied to a contiguous one
first.  There is no backward kernel: a call that would need a gradient
raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import torch

from . import build as _build

SOURCE = _build.CSRC / "flash_attention.cu"             # f32, CUDA cores
WGMMA_SOURCE = _build.CSRC / "flash_attention_wgmma.cu"  # bf16, wgmma
SOURCES = (SOURCE, WGMMA_SOURCE)
HEAD_DIMS = (16, 32, 64, 112, 128)  # 16: smoke_config(); 112: Kimi-K2
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535              # the f32 kernel's query blocks on grid.y
SMS = 132                       # streaming multiprocessors of an H100
# The bf16 kernel's blocks, as ``flash_attention_wgmma.cu`` has them: 128
# query rows a CTA (64 per consumer warpgroup), 128-key tiles through a ring
# of STAGES slots, one producer and two consumer warpgroups; shared memory holds Q and the ring in panels of 64 columns
# (128-byte rows, the TMA's 128-byte swizzle), a 1024-byte tile of ones
# and 2 + 4 * stages mbarriers, from a base aligned up to 1024 bytes.
BLOCK_Q, BLOCK_KV, STAGES, WG_ROWS = 128, 128, 2, 64
WGMMA_WARPS = 12
PANEL = 64                      # columns of one box: 128 bytes of bf16
SMEM_LIMIT = 232448             # shared memory a block may use on an H100
# The f32 kernel's blocks, as ``flash_attention.cu`` has them: 256 threads
# (a 16 x 16 grid), 128-key tiles, K and V streamed as panels of 64 columns
# through a ring of 3 slots; a CTA takes 128 query rows (an 8 x 8 thread
# tile) where that fills the SMs, else 64 (4 x 8).
F32_BLOCKS = (64, 128)
F32_BLOCK_K, F32_THREADS, F32_SLOTS, F32_PANEL = 128, 256, 3, 64


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32) or "wgmma" (bf16);
    ``block_q`` query rows and ``warps`` warps per CTA, keys in tiles of
    ``block_k`` through a ring of ``stages`` buffers (f32: panels); ``grid``
    (B*H, query blocks) for f32, (persistent CTAs, 1) for bf16."""
    kernel: str
    block_q: int
    block_k: int
    warps: int
    stages: int
    grid: Tuple[int, int]

# Launches of the CUDA kernel in this process; plain-version calls do not
# count.  A run sets it to 0 and reads it to show which path it took.
launches = 0


def check_args(q, k, v, causal: bool, window: int) -> None:
    """Raise on anything the kernel (and so its plain version) does not
    take."""
    for name, t in dict(q=q, k=k, v=v).items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if t.dim() != 4:
            raise ValueError(f"{name} must be 4-d, got {tuple(t.shape)}")
        if t.device != q.device or t.dtype != q.dtype:
            raise ValueError(f"{name} is {t.dtype} on {t.device}; q is "
                             f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise ValueError(f"dtype must be float32 or bfloat16, got {q.dtype}")
    B, H, S, D = q.shape
    if k.shape != v.shape or k.shape[0] != B or k.shape[3] != D:
        raise ValueError(f"k {tuple(k.shape)} and v {tuple(v.shape)} must be "
                         f"({B}, K, T, {D})")
    K, T = k.shape[1], k.shape[2]
    if K < 1 or H % K:
        raise ValueError(f"H={H} not a multiple of K={K}")
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    rows = min(F32_BLOCKS)
    if min(B, S, T) < 1 or -(-S // rows) > MAX_GRID_Y:
        raise ValueError(f"need B, S, T >= 1 and S <= {rows * MAX_GRID_Y}, "
                         f"got B={B} H={H} S={S} T={T}")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, got {causal!r}")
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")


def f32_block_q(B: int, H: int, S: int) -> int:
    """The f32 kernel's query rows a CTA: the largest of ``F32_BLOCKS``
    whose blocks give every SM a CTA (one fits an SM), else the
    smallest, so that a small call keeps the SMs busy."""
    fill = [bq for bq in F32_BLOCKS if -(-S // bq) * B * H >= SMS]
    return max(fill) if fill else min(F32_BLOCKS)


def plan(B: int, H: int, S: int, D: int, dtype: torch.dtype) -> Plan:
    """The launch of a call with q (B,H,S,D) in ``dtype``: f32 on the
    CUDA-core kernel (:func:`f32_block_q` query rows, 128-key tiles
    streamed as 64-column panels through a 3-slot cp.async ring, 8 warps;
    a CTA per (b*h, query block)), bf16 on the wgmma kernel (128 query
    rows, 128-key tiles through a 2-slot TMA ring, three warpgroups; one
    CTA per SM, or per work item if there are fewer, see
    :func:`work_items`)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        bq = f32_block_q(B, H, S)
        return Plan("cuda_core", bq, F32_BLOCK_K, F32_THREADS // 32,
                    F32_SLOTS, (B * H, -(-S // bq)))
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return Plan("wgmma", BLOCK_Q, BLOCK_KV, WGMMA_WARPS, STAGES,
                (min(SMS, -(-S // BLOCK_Q) * B * H), 1))


def work_items(S: int, BH: int, ctas: int) -> list:
    """The bf16 kernel's work, per CTA: CTA c takes items c, c + ctas, ...
    in turn, item i being (query block, b*h) = (n_qb - 1 - i // BH,
    i % BH): the heaviest causal blocks first, and a block's heads side by
    side."""
    n_qb = -(-S // BLOCK_Q)
    return [[(n_qb - 1 - i // BH, i % BH)
             for i in range(c, n_qb * BH, ctas)] for c in range(ctas)]


def padded_head_dim(D: int) -> int:
    """Columns the bf16 kernel computes for head dim D: whole 64-column
    panels (the columns past D arrive as zeros)."""
    return PANEL if D <= PANEL else 2 * PANEL


def smem_bytes(D: int) -> int:
    """Dynamic shared memory of one bf16 CTA at head dim D (the source's
    ``Layout<DP>::kBytes``): Q, the K and V rings, the tile of ones,
    2 + 4 * stages mbarriers, and 1024 bytes to align the base."""
    dp = padded_head_dim(D)
    return (BLOCK_Q + 2 * STAGES * BLOCK_KV) * dp * 2 + 1024 \
        + (2 + 4 * STAGES) * 8 + 1024


def f32_panels(D: int) -> Tuple[int, int]:
    """(panels, width): the f32 kernel streams each K or V tile as this
    many panels of ``width`` columns (64, or D below 64)."""
    return -(-D // F32_PANEL), min(D, F32_PANEL)


def f32_smem_bytes(D: int, block_q: int) -> int:
    """Dynamic shared memory of one f32 CTA (the source's ``smem_bytes``):
    Q (block_q x D), P (block_q x 128) and the ring's slots of 128 keys x
    one panel, as f32."""
    return 4 * (block_q * D + block_q * F32_BLOCK_K
                + F32_SLOTS * F32_BLOCK_K * f32_panels(D)[1])


def f32_thread_scores(block_q: int, t: int) -> list:
    """The (row, key) scores of a query block and key tile that thread t of
    the f32 kernel computes: rows ty + 16 i, keys tx + 16 j (tx, ty = t %
    16, t // 16)."""
    tx, ty = t % 16, t // 16
    return [(ty + 16 * i, tx + 16 * j) for i in range(block_q // 16)
            for j in range(F32_BLOCK_K // 16)]


def f32_thread_outputs(block_q: int, D: int, t: int) -> list:
    """The (row, column) outputs thread t of the f32 kernel accumulates and
    stores: its rows, and in each panel p the ``width // 16`` columns from
    64 p + tx * width // 16 that lie below D."""
    tx, ty = t % 16, t // 16
    n, width = f32_panels(D)
    vw = width // 16
    return [(ty + 16 * i, F32_PANEL * p + tx * vw + e)
            for i in range(block_q // 16) for p in range(n)
            for e in range(vw) if F32_PANEL * p + tx * vw + e < D]


def f32_k_swizzle(D: int, key: int) -> int:
    """The XOR applied to the 16-byte chunk index of key row ``key`` of a K
    panel in the f32 kernel's ring (the source's ``k_swizzle``)."""
    chunks = f32_panels(D)[1] // 4
    return key & 7 if chunks >= 8 else (key >> 1) & (chunks - 1)


def tma_layout(x: torch.Tensor, rows: int) -> Tuple[int, ...]:
    """The 4-d bf16 tensor map over x (B, N, L, D) (heads N, rows L),
    read through its strides: dims (D, L, N, B) innermost first, the byte
    strides of L, N and B, and the box (PANEL, rows, 1, 1): 128-byte rows,
    as the 128-byte swizzle takes them."""
    B, N, L, D = x.shape
    sb, sn, sl, sd = x.stride()
    if sd != 1:
        raise ValueError(f"the last dimension must be contiguous, got "
                         f"strides {x.stride()}")
    es = x.element_size()
    return (D, L, N, B, sl * es, sn * es, sb * es, PANEL, rows, 1, 1)


def key_tiles(q0: int, S: int, T: int, causal: bool,
              window: int) -> Tuple[int, int]:
    """(k_lo, n_tiles): the key tiles a bf16 CTA whose block starts at
    query row q0 visits, ``BLOCK_KV`` keys each from k_lo, as the kernel
    computes them.  Tiles before k_lo lie wholly outside every row's
    window; keys at or past min(T, q0 + BLOCK_Q, S) are past every row
    (causal)."""
    k_lo = max(0, q0 - window + 1) if window > 0 else 0
    k_lo = k_lo // BLOCK_KV * BLOCK_KV
    k_hi = min(T, q0 + BLOCK_Q, S) if causal else T
    n = -(-(k_hi - k_lo) // BLOCK_KV) if k_hi > k_lo else 0
    return k_lo, n


def mask_free(k0: int, r0: int, T: int, causal: bool, window: int) -> bool:
    """Whether the key tile at k0 keeps every key for every query row of a
    consumer warpgroup's rows r0 .. r0 + WG_ROWS - 1 (the kernel then skips
    the mask arithmetic)."""
    return (k0 + BLOCK_KV <= T
            and (not causal or k0 + BLOCK_KV - 1 <= r0)
            and (window <= 0 or r0 + WG_ROWS - 1 - k0 < window))


def _bind(lib) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_wgmma(lib) -> None:
    fn = lib.flash_attention_wgmma_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong)] * 2 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it in place (contiguous last dimension,
    16-byte aligned base and strides, which a TMA tensor map needs), else a
    contiguous copy."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0,
                    block_q: Optional[int] = None) -> torch.Tensor:
    """The kernel's wrapper: q (B,H,S,D), k/v (B,K,T,D) CUDA tensors ->
    (B,H,S,D) in q's dtype and memory layout.  ``block_q`` (f32 only, one
    of ``F32_BLOCKS``) overrides the plan's query rows a CTA, so that a
    check can hold each block against the plain version.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs, on inputs
    that need a gradient and on a failed launch; it never falls back to the
    plain version.
    """
    global launches
    check_args(q, k, v, causal, window)
    if block_q is not None and (q.dtype != torch.float32
                                or block_q not in F32_BLOCKS):
        raise ValueError(f"block_q {block_q} is for the f32 kernel, one of "
                         f"{F32_BLOCKS}; got it with {q.dtype}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_attention has no backward kernel: "
                           "training runs the plain attention "
                           "(models.attention.sequence_attention(..., "
                           "train=True)); call the kernel under "
                           "torch.no_grad()")
    _build.require_card(q.device)
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    o = torch.empty_like(q)
    B, H, S, D = q.shape
    K, T = k.shape[1], k.shape[2]
    p = plan(B, H, S, D, q.dtype)
    if block_q is not None:
        p = p._replace(block_q=block_q, grid=(B * H, -(-S // block_q)))
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K,
            S, T, D)
    tail = (int(causal), window, D ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.kernel == "cuda_core":
            strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                                 for s in t.stride()[:3]))
            lib = _build.load(SOURCE, _bind)
            err = lib.flash_attention_fwd(*ptrs, strides, *tail, p.block_q,
                                          stream)
        else:
            maps = (ctypes.c_longlong * 33)(
                *tma_layout(q, BLOCK_Q), *tma_layout(k, BLOCK_KV),
                *tma_layout(v, BLOCK_KV))
            ostrides = (ctypes.c_longlong * 3)(*o.stride()[:3])
            lib = _build.load(WGMMA_SOURCE, _bind_wgmma)
            err = lib.flash_attention_wgmma_fwd(*ptrs, p.grid[0], maps,
                                                ostrides, *tail, stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return o


__all__ = ["flash_attention", "check_args", "plan", "Plan", "kernel_layout",
           "padded_head_dim", "smem_bytes", "tma_layout", "key_tiles",
           "mask_free", "work_items", "f32_block_q", "f32_panels",
           "f32_smem_bytes", "f32_thread_scores", "f32_thread_outputs",
           "f32_k_swizzle"]
