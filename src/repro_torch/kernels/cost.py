"""The work of each kernel, defined once by formula, whatever implements it.

Each ``*_work`` function gives ``(flops, nbytes)`` for one call: the
operations the algorithm needs on these inputs, and the bytes it must
move (each needed input byte read once, each output byte written once).
``chip_smoke.py`` turns them into a kernel's least time on the card
(``roof``); the dry run (``launch.op_cost``) charges each kernel call
with them where the call runs on ``meta`` tensors and computes nothing.

``charging(counter)`` makes ``counter`` the one the meta branch of
``kernels.ops`` charges: ``charge(name, flops, nbytes, operands)`` calls
``counter.charge_kernel(name, flops, nbytes, operands)`` on the innermost active
counter of this thread, and does nothing when none is active.
"""

from __future__ import annotations

import contextlib
import threading
from typing import Iterator, Optional, Sequence, Tuple

import numpy as np

# Device-memory rate, non-tensor-core f32 rate and dense bf16 tensor-core
# rate from NVIDIA's H100 SXM data sheet; any other card's bound is
# reported as unknown.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "f32_flops": 67e12,
                                   "bf16_flops": 989.4e12}}


def causal_pairs(S: int, T: int, window: int = 0,
                 causal: bool = True) -> int:
    """(query, key) pairs a causal (and windowed) attention keeps; with
    ``causal=False`` the pairs the window alone keeps (all S*T without
    one)."""
    i = np.arange(S)
    lo = np.maximum(0, i - window + 1) if window > 0 else np.zeros_like(i)
    hi = np.minimum(T, i + 1) if causal else np.full_like(i, T)
    return int(np.maximum(0, hi - lo).sum())


def crop_work(B: int, C: int, OH: int, OW: int,
              out_bytes_per_elem: int) -> Tuple[int, int]:
    """A crop/mirror/normalize call: the cropped uint8 pixels read and the
    outputs written once, the per-image offsets and flags and the
    per-channel mean and std; a subtract and a divide per output."""
    elems = B * C * OH * OW
    nbytes = elems * (1 + out_bytes_per_elem) + 3 * B * 4 + 2 * C * 4
    return 2 * elems, nbytes


def attention_work(B: int, H: int, K: int, S: int, T: int, D: int,
                   elsize: int, causal: bool = True,
                   window: int = 0) -> Tuple[int, int]:
    """A flash-attention call: q, k, v read once and o written once,
    against 4*D flops per kept (query, key) pair per head."""
    nbytes = elsize * D * (2 * B * H * S + 2 * B * K * T)
    flops = 4 * B * H * D * causal_pairs(S, T, window, causal)
    return flops, nbytes


def decode_work(lengths: Sequence[int], K: int, G: int, D: int,
                elsize: int) -> Tuple[int, int]:
    """A flash-decode call: the valid K and V rows, q and o and the lengths
    moved once, against 4*G*D flops per valid key and kv head."""
    B, L = len(lengths), int(sum(lengths))
    nbytes = elsize * (2 * K * D * L + 2 * B * K * G * D) + 4 * B
    return 4 * K * G * D * L, nbytes


def gmm_work(E: int, C: int, d: int, f: int, elsize: int) -> Tuple[int, int]:
    """A grouped-matmul call: x and w read once and the output written
    once, against 2*d flops per output element."""
    nbytes = elsize * (E * C * d + E * d * f + E * C * f)
    return 2 * E * C * d * f, nbytes


def roof(kind: str, nbytes: int, flops: int, flops_key: str
         ) -> Tuple[Optional[float], str]:
    """(least ms on card ``kind``, "bytes" or "operations"): the larger of
    the bytes over the card's memory rate and the flops over its
    ``flops_key`` rate; (None, "bytes") for a card not in ``PEAKS``."""
    peak = PEAKS.get(kind)
    if peak is None:
        return None, "bytes"
    bytes_ms = nbytes / peak["bytes_per_s"] * 1e3
    ops_ms = flops / peak[flops_key] * 1e3
    return max(bytes_ms, ops_ms), \
        "bytes" if bytes_ms >= ops_ms else "operations"


def elsize_key(elsize: int) -> str:
    """The peak a kernel's flops run at: bf16 tensor cores for 2-byte
    inputs, the f32 CUDA cores otherwise."""
    return "bf16_flops" if elsize == 2 else "f32_flops"


_ACTIVE = threading.local()


@contextlib.contextmanager
def charging(counter) -> Iterator[None]:
    """Within the block, ``charge`` goes to ``counter`` (innermost wins)."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack is None:
        stack = _ACTIVE.stack = []
    stack.append(counter)
    try:
        yield
    finally:
        stack.pop()


def charge(name: str, flops: int, nbytes: int, operands=()) -> None:
    """One call of kernel ``name`` with its work, reading the tensors
    ``operands``, to the active counter."""
    stack = getattr(_ACTIVE, "stack", None)
    if stack:
        stack[-1].charge_kernel(name, flops, nbytes, operands)


__all__ = ["PEAKS", "causal_pairs", "crop_work", "attention_work",
           "decode_work", "gmm_work", "roof", "elsize_key", "charging",
           "charge"]
