"""The frozen reference agrees with the port's CPU path at smoke size: the
serving step from an empty and from a seeded cache, the train loss and
its gradients, and AdamW."""

from __future__ import annotations

import copy

import pytest
import torch

from perfbench import program, weights
from perfbench.drivers.train_loop import leaves
from perfbench.reference.adamw import AdamW
from perfbench.reference.model import Reference

from .conftest import CONFIGS, SEED, mixes

CPU = torch.device("cpu")


@pytest.mark.parametrize("start", [0, 24])
@pytest.mark.parametrize("name", ["tiny-moe", "tiny-dense"])
def test_serving_logits_match_the_port_step_by_step(name, start):
    c = CONFIGS[name]
    model = program.build(c, CPU)
    params = weights.make_params(c, SEED, CPU)
    B, S = 3, 20
    tokens = torch.randint(0, c["vocab"], (B, S),
                           generator=torch.Generator().manual_seed(1))
    from repro_torch.train.step import make_serve_step
    step = make_serve_step(model)
    cache = model.init_cache(B, 64)
    rows = []
    for b in range(B):
        row = {"tokens": tokens[b], "start": start}
        if start:
            k, v = weights.cache_prefix(c, SEED, b, start, CPU)
            cache["k"][:, b, :start], cache["v"][:, b, :start] = k, v
            row["prefix_k"], row["prefix_v"] = k, v
        rows.append(row)
    cache["pos"] = start
    got = []
    for s in range(S):
        logits, cache = step(params, cache, tokens[:, s:s + 1])
        got.append(logits[:, 0])
    got = torch.stack(got, dim=1)                       # (B, S, V)
    ref = Reference(c, params)
    with torch.no_grad():
        want = torch.stack([ref.logits(h) for h in ref.serve_hidden(rows)])
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), \
        float((got - want).abs().max())


def test_train_loss_and_gradients_match_the_port():
    c = CONFIGS["tiny-dense"]
    model = program.build(c, CPU)
    params = weights.make_params(c, SEED, CPU)
    tokens = torch.randint(0, c["vocab"], (2, 48),
                           generator=torch.Generator().manual_seed(2),
                           dtype=torch.int32)
    flat = leaves(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss, _ = model.train_loss(params, {"tokens": tokens,
                                        "loss_mask": torch.ones(2, 48)})
    got = torch.autograd.grad(loss, list(flat.values()))
    ref_params = {p: t.detach().clone().requires_grad_(True)
                  for p, t in flat.items()}
    from perfbench.drivers.train_loop import _tree
    ref_loss = Reference(c, _tree(ref_params)).train_loss(tokens)
    want = torch.autograd.grad(ref_loss, list(ref_params.values()))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) < 1e-5
    for p, g, w in zip(flat, got, want):
        assert torch.allclose(g, w, atol=1e-6, rtol=1e-4), p


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_adamw_matches_the_port(dtype):
    from repro_torch.train.optimizer import (OptimizerConfig, adamw_init,
                                             adamw_update)
    opt = mixes()["ttrain"]["optimizer"]
    cfg = OptimizerConfig(**opt)
    gen = torch.Generator().manual_seed(3)
    params = {"a": torch.randn(4, 5, generator=gen).to(dtype),
              "b": {"c": torch.randn(7, generator=gen).to(dtype)}}
    mine = copy.deepcopy(params)
    state = adamw_init(params, cfg)
    ref = AdamW(list(leaves(mine).values()), opt)
    for _ in range(3):
        grads = {"a": torch.randn(4, 5, generator=gen),
                 "b": {"c": torch.randn(7, generator=gen)}}
        params, state, _ = adamw_update(grads, state, params, cfg)
        ref.update(list(leaves(grads).values()))
    for p, q in zip(leaves(params).values(), leaves(mine).values()):
        assert torch.allclose(p.float(), q.float(), atol=1e-6, rtol=1e-5)
