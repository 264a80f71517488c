"""Faults planted under a run's timed path, to read what the check makes
of them: the tests' CPU runs and ``calibrate.py --fault`` on the card.

Each ``plant(kind)`` returns a context manager that, while open, breaks
the program at one place by replacing a module attribute:

- ``served_altered``: the engine serves slot 0 its second-best token;
- ``served_half``: the second half of the slots gets the first half's
  logits (half of the batch left out);
- ``served_stale``: the serve step leaves the KV cache as it was (a step
  that returns its state unchanged);
- ``train_unchanged``: the train step returns the state it was given;
- ``train_half``: the train step takes the first half of the batch's
  rows, its loss the mean over them;
- ``feed_altered``: the device feed alters one token of each batch.
"""

from __future__ import annotations

import contextlib
import copy
from typing import Iterator

from perfbench import program  # noqa: F401  (puts the port on the path)

KINDS = ("served_altered", "served_half", "served_stale", "train_unchanged",
         "train_half", "feed_altered")


def _serve(kind):
    from repro_torch.train.step import make_serve_step

    def make(model):
        step = make_serve_step(model)

        def broken(params, cache, tokens):
            if kind == "served_stale":
                k, v = cache["k"].clone(), cache["v"].clone()
            logits, cache = step(params, cache, tokens)
            logits = logits.clone()
            if kind == "served_altered":
                top = logits[0, -1].argmax()
                logits[0, -1, top] -= 1e3
            elif kind == "served_half":
                h = logits.shape[0] // 2
                logits[h:] = logits[:logits.shape[0] - h]
            else:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
            return logits, cache
        return broken
    return make


def _train(kind):
    from repro_torch.train.step import make_train_step

    def make(model, opt_cfg, **kw):
        step = make_train_step(model, opt_cfg, **kw)

        def broken(state, batch):
            if kind == "train_unchanged":
                _, metrics = step(copy.deepcopy(state), batch)
                return state, metrics
            half = {k: v[: v.shape[0] // 2] for k, v in batch.items()}
            return step(state, half)
        return broken
    return make


def _feed():
    from repro_torch.data import pipeline
    form = pipeline.DeviceFeed._form

    def altered(self, batch):
        out = form(self, batch)
        t = out["tokens"]
        t[0, 3] = (t[0, 3] + 1) % (int(t.max()) + 2)
        return out
    return pipeline.DeviceFeed, "_form", altered


@contextlib.contextmanager
def plant(kind: str) -> Iterator[None]:
    if kind not in KINDS:
        raise ValueError(f"unknown fault {kind!r}; one of {KINDS}")
    if kind.startswith("served"):
        from repro_torch.serve import engine
        target, attr, new = engine, "make_serve_step", _serve(kind)
    elif kind.startswith("train"):
        from repro_torch.train import loop
        target, attr, new = loop, "make_train_step", _train(kind)
    else:
        target, attr, new = _feed()
    old = getattr(target, attr)
    setattr(target, attr, new)
    try:
        yield
    finally:
        setattr(target, attr, old)


__all__ = ["KINDS", "plant"]
