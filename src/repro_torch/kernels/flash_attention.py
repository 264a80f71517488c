"""Flash attention forward (prefill) on Hopper: GQA, causal and/or sliding
window, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``).  Two CUDA C++ kernels, built
for ``sm_90a`` at first use and bound with ``ctypes`` (``build.py``):
``csrc/flash_attention_tc.cu`` takes bf16 on the tensor cores
(FlashAttention-2: ``mma.sync`` for Q K^T and P V, P kept in registers),
and ``csrc/flash_attention.cu`` takes f32 on the CUDA cores (IEEE
products: TF32 would miss the f32 tolerance).  Their plain version is
``ref.mha_reference``; :func:`plan` says which kernel and which blocks a
call takes.

Bound: operations.  At the prefill shape the model drives (B=4, H=32,
K=8, S=T=2048, D=128, causal) the work is 137.5 GFLOP against 167.8 MB:
0.139 ms on the bf16 tensor cores, 2.05 ms at the f32 rate.

The wrapper takes strides: q, k and v may be (B,H,S,D) / (B,K,T,D) views
of the model's (B,S,H,D) / (B,T,K,D) tensors, read in place, and the
output is allocated with q's memory layout, so the model's transpose back
is free.  A tensor whose last dimension is not contiguous or whose rows
are not 16-byte aligned is copied to a contiguous one first.  There is
no backward kernel: a call that would need a gradient raises.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from . import build as _build

SOURCE = _build.CSRC / "flash_attention.cu"          # f32, CUDA cores
TC_SOURCE = _build.CSRC / "flash_attention_tc.cu"    # bf16, tensor cores
SOURCES = (SOURCE, TC_SOURCE)
HEAD_DIMS = (16, 32, 64, 112, 128)  # 16: smoke_config(); 112: Kimi-K2
DTYPES = (torch.float32, torch.bfloat16)
MAX_GRID_Y = 65535              # the kernels put B*H on grid.y


class Plan(NamedTuple):
    """How one call runs: ``kernel`` "cuda_core" (f32) or "tensor_core"
    (bf16); ``block_q`` query rows and ``warps`` warps per CTA, keys in
    tiles of ``block_k`` through a ring of ``stages`` buffers; ``grid``
    (query blocks, B*H)."""
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
    if min(B, S, T) < 1 or B * H > MAX_GRID_Y:
        raise ValueError(f"need B, S, T >= 1 and B*H <= {MAX_GRID_Y}, got "
                         f"B={B} H={H} S={S} T={T}")
    if not isinstance(causal, bool):
        raise TypeError(f"causal must be a bool, got {causal!r}")
    if isinstance(window, bool) or not isinstance(window, int) or window < 0:
        raise ValueError(f"window must be an int >= 0, got {window!r}")


def plan(B: int, H: int, S: int, D: int, dtype: torch.dtype) -> Plan:
    """The launch of a call with q (B,H,S,D) in ``dtype``: f32 on the
    CUDA-core kernel (64 query rows, 32-key tiles staged as f32, 8 warps),
    bf16 on the tensor-core kernel (128 query rows, 32 per warp, 64-key
    tiles in a double-buffered cp.async ring)."""
    if D not in HEAD_DIMS:
        raise ValueError(f"head_dim {D} not in {HEAD_DIMS}")
    if dtype == torch.float32:
        return Plan("cuda_core", 64, 32, 8, 1, (-(-S // 64), B * H))
    if dtype != torch.bfloat16:
        raise ValueError(f"dtype must be float32 or bfloat16, got {dtype}")
    return Plan("tensor_core", 128, 64, 4, 2, (-(-S // 128), B * H))


def _bind(lib) -> None:
    fn = lib.flash_attention_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def _bind_tc(lib) -> None:
    fn = lib.flash_attention_bf16_fwd
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int


def kernel_layout(x: torch.Tensor) -> torch.Tensor:
    """``x`` if the kernels can read it in place (contiguous last dimension,
    16-byte aligned rows), else a contiguous copy."""
    per16 = 16 // x.element_size()
    ok = (x.stride(-1) == 1 and x.data_ptr() % 16 == 0
          and all(s % per16 == 0 for s in x.stride()[:-1]))
    return x if ok else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int = 0) -> torch.Tensor:
    """The kernel's wrapper: q (B,H,S,D), k/v (B,K,T,D) CUDA tensors ->
    (B,H,S,D) in q's dtype and memory layout.

    Launches on the current stream and does not synchronise.  Raises on a
    tensor that is not on a CUDA sm_90 device, on bad inputs, on inputs
    that need a gradient and on a failed launch; it never falls back to the
    plain version.
    """
    global launches
    check_args(q, k, v, causal, window)
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
    strides = (ctypes.c_longlong * 12)(*(s for t in (q, k, v, o)
                                         for s in t.stride()[:3]))
    args = (q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), B, H, K,
            S, T, D, strides, int(causal), window, D ** -0.5)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        if p.kernel == "cuda_core":
            lib = _build.load(SOURCE, _bind)
            err = lib.flash_attention_fwd(*args, stream)
        else:
            lib = _build.load(TC_SOURCE, _bind_tc)
            err = lib.flash_attention_bf16_fwd(*args, stream)
    _build.check(lib, err, "flash_attention")
    launches += 1
    return o


__all__ = ["flash_attention", "check_args", "plan", "Plan", "kernel_layout"]
