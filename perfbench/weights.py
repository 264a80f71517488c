"""Weights and other seeded tensors, made by the benchmark on the card.

The benchmark makes every input itself from ``--seed`` and hands the same
to the program and to the reference.  The parameter tree is the port's
layout of a decoder (stacked layers; ``wq`` at (L, d, H, D), experts at
(L, E, d, f), a tied embedding), one normal draw per leaf in bf16 from
one generator on the card, in sorted-key order, so the same seed gives
the same weights whenever they are made again.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import torch


def subseed(seed: int, tag: str) -> int:
    """A 63-bit seed for one named stream of a run's seed."""
    digest = hashlib.sha256(f"{seed}:{tag}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def generator(device, seed: int, tag: str) -> torch.Generator:
    return torch.Generator(device).manual_seed(subseed(seed, tag))


def specs(c: Dict) -> Dict:
    """{path: (shape, std)} of every leaf; std 0 is a norm's ones."""
    L, d, hd = c["n_layers"], c["d_model"], c["head_dim"]
    H, K, f = c["n_heads"], c["n_kv_heads"], c["d_ff"]
    out = {
        "embed/embedding": ((c["vocab"], d), 0.02),
        "ln_f/scale": ((d,), 0.0),
        "blocks/ln1/scale": ((L, d), 0.0),
        "blocks/ln2/scale": ((L, d), 0.0),
        "blocks/attn/wq": ((L, d, H, hd), d ** -0.5),
        "blocks/attn/wk": ((L, d, K, hd), d ** -0.5),
        "blocks/attn/wv": ((L, d, K, hd), d ** -0.5),
        "blocks/attn/wo": ((L, H, hd, d), (H * hd) ** -0.5),
    }
    if c.get("n_experts"):
        E = c["n_experts"]
        out.update({
            "blocks/moe/router": ((L, d, E), d ** -0.5),
            "blocks/moe/w_gate": ((L, E, d, f), d ** -0.5),
            "blocks/moe/w_up": ((L, E, d, f), d ** -0.5),
            "blocks/moe/w_down": ((L, E, f, d), f ** -0.5),
        })
    else:
        out.update({
            "blocks/mlp/w_gate": ((L, d, f), d ** -0.5),
            "blocks/mlp/w_up": ((L, d, f), d ** -0.5),
            "blocks/mlp/w_down": ((L, f, d), f ** -0.5),
        })
    return out


def make_params(c: Dict, seed: int, device) -> Dict:
    """The parameter tree of configuration ``c`` for ``seed``, in the
    configuration's dtype."""
    dtype = getattr(torch, c["dtype"])
    gen = generator(device, seed, "params")
    tree: Dict = {}
    for path, (shape, std) in sorted(specs(c).items()):
        if std:
            t = torch.empty(shape, dtype=dtype, device=device)
            t.normal_(0.0, std, generator=gen)
        else:
            t = torch.ones(shape, dtype=dtype, device=device)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def cache_prefix(c: Dict, seed: int, slot: int, length: int, device
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot ``slot``'s seeded K and V for positions 0 .. length-1, each
    (L, length, K, D), N(0, 1): drawn from a stream of the slot's own, so
    any one slot can be drawn again alone."""
    gen = generator(device, seed, f"cache/{slot}")
    shape = (2, c["n_layers"], length, c["n_kv_heads"], c["head_dim"])
    kv = torch.empty(shape, dtype=getattr(torch, c["dtype"]), device=device)
    kv.normal_(0.0, 1.0, generator=gen)
    return kv[0], kv[1]


__all__ = ["subseed", "generator", "specs", "make_params", "cache_prefix"]
