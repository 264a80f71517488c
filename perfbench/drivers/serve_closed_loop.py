"""Serving in a closed loop: one client per slot of the port's engine.

Set-up makes the weights, fetches the mix's prompts through the port's
loader (``CassandraLoader`` over the simulated WAN, as its serving
launcher does), warms the serve step on a small cache, builds the
``ServingEngine`` and, for a mix with a ``start_pos``, draws every slot's
K and V for the positions before it.  The window then drives
``ServingEngine.step``: every client submits a request at the start and
its next one when the last completes.  The host clock after each step
(whose greedy ``argmax`` read-back synchronises) stamps the tokens it
produced.  The window closes after ``--seconds``, or earlier once the
engine's shared position reaches the end of its cache (a program fast
enough to get there is measured over the shorter window).

Once the window has closed, the peak memory is read, the engine freed,
and the plain reference recomputes a sample of slots, drawn from the
seed, from the prompts and the served tokens: every served token of a
finished request there is judged by how far its logit lies below the
reference's best at its position.  With ``control`` the fp8 reference
is put in the program's place: the tokens it ranks first at the same
positions are judged in the same way, and ``correct`` has to come out
false.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import program, trace, traffic, weights
from perfbench.reference.model import Reference, exact_f32


class Client:
    """One request's record: what was sent, when, and when each served
    token came."""

    __slots__ = ("prompt_id", "req", "t_sub", "times", "slot", "step")

    def __init__(self, prompt_id: int, req, t_sub: float):
        self.prompt_id = prompt_id
        self.req = req
        self.t_sub = t_sub
        self.times: List[float] = []
        self.slot = -1
        self.step = -1


def fetch_prompts(mix: Dict, vocab: int, seed: int) -> List[np.ndarray]:
    """The mix's prompts, read through the port's loader, each cut to its
    length; raises if a record comes back changed or missing."""
    from repro_torch.core import CassandraLoader, LoaderConfig
    from repro_torch.data.datasets import decode_token_record
    n = mix["prompts"]
    lo, hi = mix["prompt_len"]
    rows = traffic.token_rows(n, hi, vocab, seed)
    lens = traffic.log_uniform_lengths(lo, hi, n)
    store, uuids = traffic.store_of(rows, seed)
    ld = mix["loader"]
    loader = CassandraLoader(store, uuids, LoaderConfig(
        batch_size=n, prefetch_buffers=ld["prefetch_buffers"],
        io_threads=ld["io_threads"], route=ld["route"], materialize=True,
        seed=weights.subseed(seed, "loader") % (1 << 31))).start()
    try:
        batch = loader.next_batch()
    finally:
        loader.close()
    prompts: List = [None] * n
    for sample in batch.samples:
        toks, label = decode_token_record(sample.payload)
        if not np.array_equal(toks, rows[label]):
            raise RuntimeError(f"prompt {label} came back changed")
        prompts[label] = rows[label][:lens[label]]
    if any(p is None for p in prompts):
        raise RuntimeError("the loader's batch missed a prompt")
    return prompts


def seed_cache(engine, config: Dict, seed: int, start: int, device) -> None:
    """Every slot's K and V for positions 0 .. start-1, from the seed, and
    the engine's shared position set to ``start``."""
    for slot in range(engine.cfg.batch_slots):
        k, v = weights.cache_prefix(config, seed, slot, start, device)
        engine.cache["k"][:, slot, :start] = k
        engine.cache["v"][:, slot, :start] = v
    engine.cache["pos"] = start


def warm_up(model, params, slots: int, steps: int, length: int,
            vocab: int, device) -> None:
    """The engine's serve step at its batch on a small cache, with the
    engine's one read-back a step: builds each kernel and warms the
    libraries before the window."""
    from repro_torch.train.step import make_serve_step
    step = make_serve_step(model)
    cache = model.init_cache(slots, length)
    gen = weights.generator(device, 0, "warm-up")
    for _ in range(steps):
        tok = torch.randint(0, vocab, (slots, 1), generator=gen,
                            device=device, dtype=torch.int32)
        logits, cache = step(params, cache, tok)
        logits[:, -1, :].argmax(dim=-1).cpu()
    del cache


def run(config: Dict, mix: Dict, cell: Dict, seed: int, seconds: float,
        trace_on: bool, device, t0: float, control: bool = False) -> Dict:
    from repro_torch.kernels import ops
    from repro_torch.serve import ServeConfig, ServingEngine
    slots, start = mix["slots"], mix.get("start_pos", 0)
    model = program.build(config, device)
    params = weights.make_params(config, seed, device)
    prompts = fetch_prompts(mix, config["vocab"], seed)
    warm_up(model, params, slots, mix["warmup_steps"], mix["warmup_cache"],
            config["vocab"], device)
    engine = ServingEngine(model, params, ServeConfig(
        batch_slots=slots, max_seq=config["max_seq"],
        max_new_tokens=mix["max_new_tokens"]))
    if start:
        seed_cache(engine, config, seed, start, device)
    _sync(device)
    _settle()
    setup_s = time.perf_counter() - t0

    clients: Dict[int, Client] = {}
    live: List[Client] = []
    next_prompt = 0

    def submit(t: float) -> None:
        nonlocal next_prompt
        pid = next_prompt % len(prompts)
        rid = next_prompt
        next_prompt += 1
        c = Client(pid, engine.submit(prompts[pid], rid=rid), t)
        clients[rid] = c
        live.append(c)

    prof = None
    gmm_calls, dec_calls = [], []
    step_end: List[float] = []
    step_s: List[float] = []
    t_start = time.perf_counter()
    for _ in range(slots):
        submit(t_start)
    t_stop = t_start + seconds
    trace_from = t_start + mix["trace"]["after_s"]
    while True:
        if trace_on and prof is None and time.perf_counter() >= trace_from:
            prof = _Trace(device, ops, gmm_calls, dec_calls, engine)
            first_traced = len(step_end)
        t_b = time.perf_counter()
        engine.step()
        t = time.perf_counter()
        step_end.append(t)
        step_s.append(t - t_b)
        k = len(step_end) - 1
        for i, r in enumerate(engine.slots):
            if r is not None and clients[r.rid].slot < 0:
                clients[r.rid].slot, clients[r.rid].step = i, k
        done = []
        for c in live:
            if len(c.req.out_tokens) > len(c.times):
                c.times.append(t)
            if c.req.done:
                done.append(c)
        for c in done:
            live.remove(c)
            submit(t)
        if prof is not None and not prof.closed and \
                k + 1 - first_traced >= mix["trace"]["steps"]:
            prof.close()
        if t >= t_stop or start + len(step_end) >= config["max_seq"]:
            break
    if prof is not None and not prof.closed:
        prof.close()
    _sync(device)
    peak = _peak(device)
    t_end = step_end[-1]
    gc.unfreeze()

    out = {"setup_s": setup_s, "memory_peak_bytes": peak,
           "attempted": len(clients), "e2e": {}, "layer": {}}
    window = t_end - t_start
    tokens = sum(len(c.times) for c in clients.values())
    ttft = [c.times[0] - c.t_sub for c in clients.values() if c.times]
    out["e2e"] = {"gen_tokens_per_s": tokens / window,
                  "ttft_p95_ms": _ms(trace.percentile(ttft, 95))}
    lengths = [min(start + k + 1, config["max_seq"])
               for k in range(len(step_end))]
    # The profiler holds the host while it starts and while it reads its
    # trace when it stops: the host-clock readings of a traced run take
    # the steps before the profiled slice.
    before = first_traced if prof is not None else len(step_end)
    t_cut = step_end[before - 1] if before else t_start
    out["layer"] = {"kind": "serve", "config": config, "slots": slots,
                    "device_kind": _kind(device),
                    "step_s": step_s[:before], "step_len": lengths[:before],
                    "gaps": [b - a for c in clients.values()
                             for a, b in zip(c.times, c.times[1:])
                             if b <= t_cut]}
    if prof is not None:
        out["layer"].update(prof.readings())
        out["busy_s"] = prof.profile.busy_s()
        out["window_s"] = prof.profile.window_s()
        out["breakdown"] = prof.profile.breakdown()

    quarters = np.array_split(np.array(step_s) * 1e3, 4)
    out["step_ms_by_quarter"] = [float(q.mean()) for q in quarters if len(q)]
    out["steps"] = len(step_end)
    finished = [c for c in clients.values() if c.req.done]
    del engine, live
    _free(device)
    t_check = time.perf_counter()
    checked = check(config, params, prompts, finished, cell, seed, start,
                    device, control)
    checked["check_s"] = time.perf_counter() - t_check
    out["checks"] = checked["checks"]
    out["failed"] = checked["failed"]
    out["detail"] = dict(checked, steps=out["steps"],
                         step_ms_by_quarter=out["step_ms_by_quarter"],
                         window_s=window, cache_full=t_end < t_stop)
    return out


class _Trace:
    """The profiled slice of the window, with the two kernels' entry
    points wrapped in ranges."""

    def __init__(self, device, ops, gmm_calls, dec_calls, engine):
        self.gmm_calls, self.dec_calls = gmm_calls, dec_calls
        self.closed = False
        self._wraps = [
            trace.ranges(ops, "grouped_matmul", "perfbench.grouped_matmul",
                         lambda x, w: gmm_calls.append(
                             (tuple(x.shape), w.shape[-1], x.element_size()))),
            trace.ranges(ops, "flash_decode", "perfbench.flash_decode",
                         lambda q, k, v, lengths: dec_calls.append(
                             (tuple(q.shape), q.element_size(),
                              engine.cache["pos"]))),
        ]
        for w in self._wraps:
            w.__enter__()
        self.profile = trace.Profile(device).__enter__()

    def close(self) -> None:
        self.profile.__exit__(None, None, None)
        for w in reversed(self._wraps):
            w.__exit__(None, None, None)
        self.closed = True

    def readings(self) -> Dict:
        return {"gmm": list(zip(self.gmm_calls,
                                self.profile.device_s_of(
                                    "perfbench.grouped_matmul"))),
                "decode": list(zip(self.dec_calls,
                                   self.profile.device_s_of(
                                       "perfbench.flash_decode"))),
                "busy_s": self.profile.busy_s(),
                "window_s": self.profile.window_s()}


def row_tokens(clients: List[Client], start: int):
    """A slot's finished requests in order, as the tokens the slot was fed
    from position ``start`` (each prompt, then each served token but the
    last) and, for each served token, the position whose logits chose
    it; None where the requests do not follow one another step by step."""
    toks: List[int] = []
    judged = []                     # (position, served token, request)
    for c in sorted(clients, key=lambda c: c.step):
        if c.step != len(toks):
            return None
        p = start + len(toks)
        prompt = [int(t) for t in c.req.prompt]
        out = c.req.out_tokens
        judged += [(p + len(prompt) - 1 + m, t, c.req.rid)
                   for m, t in enumerate(out)]
        toks += prompt + list(out[:-1])
    return toks, judged


def check(config: Dict, params: Dict, prompts, finished: List[Client],
          cell: Dict, seed: int, start: int, device,
          control: bool = False) -> Dict:
    """Every served token of the finished requests in a seeded sample of
    slots (with the slot of the longest finished prompt) is judged by the
    gap between the reference's best logit at its position and the
    reference's logit of it.  The number compared is the largest share,
    over those requests, of a request's tokens whose gap exceeds the
    cell's ``off_gap``; the widest gap itself is reported beside it.  With
    ``control``, the tokens the fp8 reference puts first at those
    positions are judged in the served tokens' place, and the program's
    own share is reported beside them."""
    limit = cell["limits"]["off_share_worst_request"]
    if not finished:            # nothing to judge: not shown correct
        return {"checks": {"off_share_worst_request": (float("inf"), limit),
                           "rows_out_of_order": (0, 0)},
                "failed": 0, "requests_checked": 0}
    slots = sorted({c.slot for c in finished})
    r = traffic.rng(seed, "check")
    pick = list(r.choice(slots, size=min(cell["check_slots"], len(slots)),
                         replace=False))
    longest = max(finished, key=lambda c: len(c.req.prompt)).slot
    if longest not in pick:
        pick[-1] = longest
    by_slot = {s: [c for c in finished if c.slot == s] for s in pick}
    bad_rows = 0
    rows, judged = [], []
    for s in pick:
        for c in by_slot[s]:
            if not np.array_equal(c.req.prompt, prompts[c.prompt_id]):
                bad_rows += 1
        got = row_tokens(by_slot[s], start)
        if got is None:
            bad_rows += 1
            continue
        toks, jud = got
        row = {"tokens": torch.tensor(toks, device=device), "start": start}
        if start:
            row["prefix_k"], row["prefix_v"] = weights.cache_prefix(
                config, seed, int(s), start, device)
        rows.append(row)
        judged.append(jud)
    ref = Reference(config, params)
    gaps = _gaps(ref, rows, judged, start)
    off = cell["off_gap"]
    shares = off_shares(gaps, judged, off)
    out = {"served_tokens_checked": sum(len(j) for j in judged),
           "requests_checked": len(shares),
           "slots_checked": [int(s) for s in pick]}
    if gaps:
        out["gaps"] = _spread(torch.cat(gaps))
    if control:
        out["program_off_share_worst_request"] = max(shares.values(),
                                                     default=float("inf"))
        gaps = _gaps(ref, rows, judged, start,
                     Reference(config, params, quant="fp8"))
        shares = off_shares(gaps, judged, off)
        out["control_gaps"] = _spread(torch.cat(gaps))
    worst = max(shares.values(), default=float("inf"))
    out["checks"] = {"off_share_worst_request": (worst, limit),
                     "rows_out_of_order": (bad_rows, 0)}
    out["failed"] = sum(v > limit for v in shares.values()) + bad_rows
    return out


def off_shares(gaps, judged, off: float) -> Dict[int, float]:
    """Each request's share of served tokens whose logit lies more than
    ``off`` below the reference's best at its position."""
    n: Dict[int, int] = {}
    bad: Dict[int, int] = {}
    for g, jud in zip(gaps, judged):
        for (_, _, rid), x in zip(jud, g.tolist()):
            n[rid] = n.get(rid, 0) + 1
            bad[rid] = bad.get(rid, 0) + (x > off)
    return {rid: bad[rid] / n[rid] for rid in n}


def _spread(g: torch.Tensor) -> Dict:
    q = torch.quantile(g.double().cpu(), torch.tensor(
        [0.5, 0.9, 0.99], dtype=torch.float64))
    return {"n": int(g.numel()), "p50": float(q[0]), "p90": float(q[1]),
            "p99": float(q[2]), "max": float(g.max()),
            "over_0.1": int((g > 0.1).sum()), "over_1": int((g > 1).sum())}


def _gaps(ref: Reference, rows, judged, start: int,
          control: Reference = None) -> List[torch.Tensor]:
    """For each row, at each judged position, the gap between the
    reference's best logit and its logit of the served token or, with a
    ``control``, of the token the control ranks first."""
    with torch.no_grad(), exact_f32():
        hidden = ref.serve_hidden(rows)
        other = control.serve_hidden(rows) if control else None
        out = []
        for i, jud in enumerate(judged):
            pos = torch.tensor([p - start for p, _, _ in jud],
                               device=hidden[i].device)
            tok = torch.tensor([t for _, t, _ in jud], device=pos.device)
            gaps = []
            for s in range(0, len(pos), 512):
                p = pos[s:s + 512]
                truth = ref.logits(hidden[i][p])
                pick = (tok[s:s + 512] if control is None else
                        control.logits(other[i][p]).argmax(dim=-1))
                gaps.append(truth.max(dim=-1).values
                            - truth.gather(1, pick[:, None])[:, 0])
            out.append(torch.cat(gaps))
        return out


def _settle() -> None:
    """Collect once and freeze what set-up made, so that the collector's
    passes in the window walk only what the window makes."""
    gc.collect()
    gc.freeze()


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


def _ms(x):
    return None if x is None else x * 1e3


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak(device) -> int:
    return torch.cuda.max_memory_allocated(device) if device.type == "cuda" \
        else 0


def _free(device) -> None:
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


__all__ = ["run", "check", "row_tokens", "fetch_prompts", "Client"]
