"""Grouped (per-expert) matrix product on Hopper: x (E,C,d) @ w (E,d,f) ->
(E,C,f), the expert FFNs of the MoE path, f32 or bf16.

Replaces the Pallas TPU kernel ``repro/kernels/moe_gmm.py``
(``grouped_matmul`` -> ``_gmm_kernel``).  The kernel is CUDA C++ in
``csrc/grouped_matmul.cu``, built for ``sm_90a`` at first use and bound
with ``ctypes`` (``build.py``).  Its plain version is ``ref.gmm_reference``.

Bound, at Grok-1's shapes on the serving path (E=8, d=6144, f=32768, bf16):
bytes at decode (8 rows per expert: 3.23 GB of weights, 0.963 ms at 3.35
TB/s) and, narrowly, operations in a 512-token prefill chunk (320 rows per
expert: 1.03 TFLOP, 1.04 ms on the tensor cores).  This first version
runs on the CUDA cores in f32 (see the ``.cu`` note).

The wrapper takes strides: x and w may be views whose last axis is
contiguous (one layer's slice of the stacked expert weights goes in
without a copy); any other layout is copied to a contiguous one first.
The output is a new contiguous (E,C,f) tensor.  There is no backward
kernel, in the port or in ``repro``: a call that would need a gradient
raises.
"""

from __future__ import annotations

import ctypes

import torch

from . import build as _build

SOURCE = _build.CSRC / "grouped_matmul.cu"
DTYPES = (torch.float32, torch.bfloat16)
BN = 128                        # output columns per CTA (kBN in the .cu)
MAX_GRID_YZ = 65535             # column tiles on grid.y, experts on grid.z
MAX_INT = 2 ** 31 - 1           # C, d and f go in as C ints
# Row tiles of the kernel's three variants, smallest first: a launch takes
# the first that holds all C rows, else the largest.
ROW_TILES = (8, 32, 64)

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


def row_tile(C: int) -> int:
    """Index into ``ROW_TILES`` of the variant that a launch with C rows
    takes."""
    for i, bm in enumerate(ROW_TILES):
        if C <= bm:
            return i
    return len(ROW_TILES) - 1


def build():
    """Compile ``csrc/grouped_matmul.cu`` if needed; return its path."""
    return _build.build(SOURCE)


def _bind(lib) -> None:
    fn = lib.grouped_matmul_fwd
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [
        ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p]
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
                           "repro's): the MoE trainer is not ported; call it "
                           "under torch.no_grad()")
    _build.require_card(x.device)
    lib = _build.load(SOURCE, _bind)
    x, w = (t if t.stride(-1) == 1 else t.contiguous() for t in (x, w))
    E, C, d = x.shape
    f = w.shape[2]
    o = torch.empty((E, C, f), dtype=x.dtype, device=x.device)
    strides = (ctypes.c_longlong * 6)(*(s for t in (x, w, o)
                                        for s in t.stride()[:2]))
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.grouped_matmul_fwd(
            x.data_ptr(), w.data_ptr(), o.data_ptr(), E, C, d, f, strides,
            row_tile(C), int(_vec_ok(x) and _vec_ok(w)),
            int(x.dtype == torch.bfloat16), stream)
    _build.check(lib, err, "grouped_matmul")
    launches += 1
    return o


__all__ = ["grouped_matmul", "check_args", "row_tile", "build"]
