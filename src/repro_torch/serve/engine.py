"""Batched serving engine: continuous batching over a fixed-slot KV cache.

The port of ``repro.serve.engine``.  Requests occupy batch slots; each
engine step decodes one token for every active slot; finished slots are
refilled from the queue at once.  As in the reference, prompts go in one
token per engine step through ``decode_step`` (the engine never calls
prefill), and one ``pos`` per cache is shared by every slot, so a
linear cache's writes clamp to its last slot once ``pos`` passes its
length.  The one host sync per step is the greedy ``argmax`` read back to
the host.  Decoding is greedy; ``ServeConfig.greedy`` and ``seed`` are
taken and select nothing, as in the reference (whose RNG is never drawn).

Beside ``steps`` the engine counts ``slot_steps`` (every slot of every
step), ``prompt_tokens_fed`` (slot-steps that fed a prompt token) and
``tokens_out`` (tokens served; the step that feeds a prompt's last token
serves its first).  With ``core.spans`` on, a step is the span
``engine.step`` over ``engine.admit``, ``engine.upload`` (the tokens to
the device), ``engine.forward`` (issuing the step function),
``engine.readback`` (the argmax back to the host, waiting on the device)
and ``engine.emit`` (the slots' bookkeeping).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from repro_torch.core.spans import span
from repro_torch.train.step import make_serve_step


@dataclasses.dataclass
class ServeConfig:
    batch_slots: int = 8
    max_seq: int = 256
    max_new_tokens: int = 32
    eos_id: int = -1              # -1: run to max_new_tokens
    greedy: bool = True
    seed: int = 0


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray            # (P,) int32
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServingEngine:
    """Serves on the model's device; ``params`` must live there too."""

    def __init__(self, model, params, cfg: ServeConfig) -> None:
        self.model = model
        self.params = params
        self.cfg = cfg
        self.step_fn = make_serve_step(model)
        self.cache = model.init_cache(cfg.batch_slots, cfg.max_seq)
        self.slots: List[Optional[Request]] = [None] * cfg.batch_slots
        self.queue: List[Request] = []
        self._slot_pending: List[List[int]] = [[] for _ in
                                               range(cfg.batch_slots)]
        self._next_token = np.zeros((cfg.batch_slots, 1), np.int32)
        self.steps = 0
        self.slot_steps = 0
        self.prompt_tokens_fed = 0
        self.tokens_out = 0
        self.last_logits: Optional[torch.Tensor] = None   # (slots, 1, V)

    # -- request management --------------------------------------------------
    def submit(self, prompt: np.ndarray, rid: Optional[int] = None) -> Request:
        req = Request(rid=rid if rid is not None else len(self.queue),
                      prompt=np.asarray(prompt, np.int32))
        self.queue.append(req)
        return req

    def _admit(self) -> None:
        for i in range(self.cfg.batch_slots):
            if self.slots[i] is None and self.queue:
                req = self.queue.pop(0)
                self.slots[i] = req
                # prompt tokens are fed one at a time through decode steps
                # (single-token engine keeps the step shape static)
                self._slot_pending[i] = list(req.prompt)
                self._next_token[i, 0] = self._slot_pending[i].pop(0)

    # -- stepping ---------------------------------------------------------
    def step(self) -> None:
        with span("engine.step"):
            with span("engine.admit"):
                self._admit()
            with span("engine.upload"):
                tokens = torch.from_numpy(self._next_token).to(
                    self.model.device)
            with span("engine.forward"):
                logits, self.cache = self.step_fn(self.params, self.cache,
                                                  tokens)
            self.last_logits = logits
            self.steps += 1
            self.slot_steps += self.cfg.batch_slots
            with span("engine.readback"):
                next_ids = logits[:, -1, :].argmax(dim=-1).cpu().numpy()
            with span("engine.emit"):
                self._emit(next_ids)

    def _emit(self, next_ids: np.ndarray) -> None:
        fed = out = 0
        for i, req in enumerate(self.slots):
            if req is None:
                continue
            if not req.out_tokens:
                fed += 1                 # this step fed a prompt token
            if self._slot_pending[i]:
                # still consuming the prompt: feed next prompt token
                self._next_token[i, 0] = self._slot_pending[i].pop(0)
                continue
            tok = int(next_ids[i])
            req.out_tokens.append(tok)
            out += 1
            self._next_token[i, 0] = tok
            if (tok == self.cfg.eos_id
                    or len(req.out_tokens) >= self.cfg.max_new_tokens):
                req.done = True
                self.slots[i] = None     # slot freed -> continuous batching
        self.prompt_tokens_fed += fed
        self.tokens_out += out

    def run(self, requests: List[np.ndarray]) -> List[Request]:
        """Serve a list of prompts to completion."""
        out: List[Request] = [self.submit(r) for r in requests]
        while self.queue or any(s is not None for s in self.slots):
            self.step()
        return out


__all__ = ["ServeConfig", "ServingEngine", "Request"]
