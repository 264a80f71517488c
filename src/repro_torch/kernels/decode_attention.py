"""Flash decoding on Hopper: one query token per (batch, kv head), with its
G grouped query heads, against a long KV cache.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``flash_decode`` -> ``_decode_kernel``).  The kernel is CUDA C++ in
``csrc/flash_decode.cu``, built for ``sm_90a`` at first use and bound with
``ctypes`` (``build.py``).  Its plain version is ``ref.decode_reference``.

Bound: bytes.  The kernel streams each valid K and V row once, about 2
flops per byte at G=4 in bf16; at the decode_32k shape (B=16, K=8, G=4,
T=32768, D=128) that is 2.147 GB, 0.641 ms at 3.35 TB/s.  The design
splits T into chunks (flash-decoding) so that B*K alone, 64 CTAs for 8
slots x 8 kv heads, does not leave half the 132 SMs idle; a second small
pass combines the chunks.

Precondition: ``1 <= lengths[b] <= T``.  The reference leaves a length
of 0 undefined, and the wrapper does not read ``lengths`` on the host (that
would cost a sync per layer).  k and v are read through strides, so the
model's (B,T,K,D) cache goes in as a (B,K,T,D) view without a copy.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build
from .flash_attention import DTYPES, HEAD_DIMS, kernel_layout

SOURCE = _build.CSRC / "flash_decode.cu"
SOURCES = (SOURCE,)
MAX_GROUP = 8                   # query heads per kv head the kernel holds
TILE = 128                      # keys per tile inside a chunk
SMS = 132                       # streaming multiprocessors of an H100
CTAS_PER_SM = 8                 # the split aims at this many CTAs per SM
MAX_GRID_Y = 65535              # the kernel puts B*K on grid.y

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


def _bind(lib) -> None:
    fn = lib.flash_decode_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p]
    fn.restype = ctypes.c_int


def flash_decode(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 lengths: torch.Tensor) -> torch.Tensor:
    """The kernel's wrapper: q (B,K,G,D), k/v (B,K,T,D), lengths (B,) CUDA
    tensors -> (B,K,G,D) in q's dtype.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs and on a failed
    launch; it never falls back to the plain version.
    """
    global launches
    check_args(q, k, v, lengths)
    _build.require_card(q.device)
    lib = _build.load(SOURCE, _bind)
    q, k, v = (kernel_layout(t) for t in (q, k, v))
    lengths = lengths.to(torch.int32).contiguous()
    B, K, G, D = q.shape
    T = k.shape[2]
    chunk, n_chunks = split(B * K, T)
    dev = q.device
    o = torch.empty((B, K, G, D), dtype=q.dtype, device=dev)
    n_part = B * K * n_chunks * G
    part_m = torch.empty(n_part, dtype=torch.float32, device=dev)
    part_l = torch.empty(n_part, dtype=torch.float32, device=dev)
    part_acc = torch.empty(n_part * D, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.flash_decode_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), lengths.data_ptr(),
            o.data_ptr(), part_m.data_ptr(), part_l.data_ptr(),
            part_acc.data_ptr(), B, K, G, T, D, chunk, n_chunks, strides,
            D ** -0.5, int(q.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "flash_decode")
    launches += 1
    return o


__all__ = ["flash_decode", "check_args", "split"]
