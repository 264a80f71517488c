"""The benchmark's yardstick for work: operations and bytes by formula.

A frozen copy of the port's kernel work functions (``gmm_work``,
``decode_work``) and the H100's published peaks, plus the model-level
counts the per-layer metrics divide by: the FLOPs of a serving step and
of a train step, and the bytes a serving step must move.  Nothing here
reads the program: a later change to the port cannot move the yardstick.
"""

from __future__ import annotations

from typing import Sequence, Tuple

# NVIDIA's H100 SXM data sheet: HBM3 rate, dense bf16 tensor-core rate.
PEAKS = {"NVIDIA H100 80GB HBM3": {"bytes_per_s": 3.35e12,
                                   "bf16_flops": 989.4e12}}


def peak(kind: str) -> dict:
    """The card's peaks; raises for a card the table does not hold (no
    share of a peak is made up for it)."""
    if kind not in PEAKS:
        raise KeyError(f"no published peaks for {kind!r}")
    return PEAKS[kind]


def bound_s(flops: float, nbytes: float, kind: str) -> float:
    """The least time the card can take: the larger of the operations over
    the bf16 peak and the bytes over the memory rate."""
    p = peak(kind)
    return max(flops / p["bf16_flops"], nbytes / p["bytes_per_s"])


def gmm_work(E: int, C: int, d: int, f: int, elsize: int) -> Tuple[int, int]:
    """A grouped-matmul call (E,C,d) @ (E,d,f): x and w read once and the
    output written once, against 2*d flops per output element."""
    nbytes = elsize * (E * C * d + E * d * f + E * C * f)
    return 2 * E * C * d * f, nbytes


def decode_work(lengths: Sequence[int], K: int, G: int, D: int,
                elsize: int) -> Tuple[int, int]:
    """A flash-decode call: the valid K and V rows, q and o and the lengths
    moved once, against 4*G*D flops per valid key and kv head."""
    B, L = len(lengths), int(sum(lengths))
    nbytes = elsize * (2 * K * D * L + 2 * B * K * G * D) + 4 * B
    return 4 * K * G * D * L, nbytes


def _attn_params(c: dict) -> int:
    hd = c["head_dim"]
    return c["d_model"] * hd * (2 * c["n_heads"] + 2 * c["n_kv_heads"])


def _ffn_params(c: dict, active: bool) -> int:
    """SwiGLU weights of one layer: all experts' (``active=False``) or the
    ``top_k`` a token runs through (``active=True``), with the router."""
    one = 3 * c["d_model"] * c["d_ff"]
    if not c.get("n_experts"):
        return one
    n = c["top_k"] if active else c["n_experts"]
    return n * one + c["d_model"] * c["n_experts"]


def matmul_params(c: dict) -> int:
    """Weights a token multiplies by: every layer's attention and active
    FFN, and the (tied) unembedding; the embedding lookup is free."""
    return (c["n_layers"] * (_attn_params(c) + _ffn_params(c, True))
            + c["vocab"] * c["d_model"])


def serve_step_flops(c: dict, slots: int, length: int) -> int:
    """Model FLOPs of one engine step: every slot decodes one token that
    attends to ``length`` cached positions in every layer."""
    attn = 4 * c["n_heads"] * c["head_dim"] * length * c["n_layers"]
    return slots * (2 * matmul_params(c) + attn)


def serve_step_bytes(c: dict, slots: int, length: int,
                     elsize: int = 2) -> int:
    """Bytes one engine step must move: every weight once (all experts,
    which a batch of slots reaches), each slot's ``length`` cached K and V
    rows in every layer read once and its new row written, its embedding
    row read and its f32 logits written."""
    weights = (c["n_layers"] * (_attn_params(c) + _ffn_params(c, False))
               + c["vocab"] * c["d_model"])
    kv_row = 2 * c["n_kv_heads"] * c["head_dim"] * c["n_layers"]
    return elsize * (weights + slots * kv_row * (length + 1)
                     + slots * c["d_model"]) + 4 * slots * c["vocab"]


def train_step_flops(c: dict, rows: int, seq: int) -> int:
    """Model FLOPs of one train step, with nothing recomputed counted:
    6 per weight a token multiplies by, and 6 * L * d * S per token for
    causal attention (the scores and the weighted sum, forward and
    backward)."""
    T = rows * seq
    attn_width = c["n_heads"] * c["head_dim"]
    return 6 * matmul_params(c) * T + 6 * c["n_layers"] * attn_width * seq * T
