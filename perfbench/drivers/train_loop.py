"""Training from the network loader: the port's ``run_training``.

Set-up makes the weights and the AdamW state (the one training object),
ingests the mix's token rows into the port's data store and calls
``run_training`` with that state: ``CassandraLoader`` over the simulated
WAN (virtual clock) -> ``DeviceFeed`` -> the train step.  Its first
``warmup_steps`` steps are set-up, taken through the window's own call
and feed.  Each step's state is the one the train step returns: after
the first, its optimizer's first moment gives each leaf's gradient as
the optimizer got it; after the third, each leaf's change since the
start is read from its parameters.  The window then runs for
``--seconds`` and is closed from the loop's per-step callback, and the
loader is closed after it.  The host clock after each step
(the loop synchronises it) stamps the window; ``StepStats.compute_s`` is
each step's own time.

Once the window has closed, the peak memory is read, the program's state
freed, and the plain reference trains the same weights on the rows the
feed delivered for the first three steps: each step's loss, each leaf's
first gradient and each leaf's change after three steps are compared.
With ``control`` the same three steps of the reference in fp8 are
compared in the program's place, and ``correct`` has to come out false.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List

import numpy as np
import torch

from perfbench import program, trace, traffic, weights
from perfbench.reference.adamw import AdamW
from perfbench.reference.model import Reference, exact_f32


class WindowClosed(Exception):
    pass


class Recorder:
    """The loop's feed, passing its first ``keep`` batches to the host."""

    def __init__(self, feed, keep: int):
        self._feed = feed
        self._keep = keep
        self.kept: List[Dict[str, np.ndarray]] = []

    def __iter__(self):
        return self

    def __next__(self):
        batch, meta = next(self._feed)
        if len(self.kept) < self._keep:
            self.kept.append({k: batch[k].cpu().numpy()
                              for k in ("tokens", "loss_mask")})
        return batch, meta

    def __getattr__(self, name):
        return getattr(self._feed, name)


def leaves(tree: Dict, prefix: str = "") -> Dict[str, torch.Tensor]:
    """{path: tensor} of a tree of dicts."""
    out = {}
    for k in sorted(tree):
        v = tree[k]
        if isinstance(v, dict):
            out.update(leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = v
    return out


@torch.no_grad()
def norms(tensors: Dict[str, torch.Tensor]) -> Dict[str, float]:
    return {k: float(t.float().norm()) for k, t in tensors.items()}


def run(config: Dict, mix: Dict, cell: Dict, seed: int, seconds: float,
        trace_on: bool, device, t0: float, control: bool = False) -> Dict:
    from repro_torch.core import LoaderConfig
    from repro_torch.train import loop as train_loop
    from repro_torch.train.optimizer import OptimizerConfig, adamw_init
    warm = mix["warmup_steps"]
    rows, seq = mix["rows"], mix["seq_len"]
    model = program.build(config, device)
    params = weights.make_params(config, seed, device)
    opt_cfg = OptimizerConfig(**mix["optimizer"])
    state = {"params": params, "opt": adamw_init(params, opt_cfg)}
    data = traffic.token_rows(mix["dataset_rows"], seq, config["vocab"], seed)
    store, uuids = traffic.store_of(data, seed)
    ld = mix["loader"]
    loader_cfg = LoaderConfig(
        batch_size=rows, prefetch_buffers=ld["prefetch_buffers"],
        io_threads=ld["io_threads"], route=ld["route"],
        out_of_order=ld["out_of_order"], materialize=True,
        seed=weights.subseed(seed, "loader") % (1 << 31))
    loop_cfg = train_loop.TrainLoopConfig(
        total_steps=1 << 30, seq_len=seq, log_every=1,
        seed=weights.subseed(seed, "loop") % (1 << 31))

    stack = {}
    build_stack = train_loop.build_stack
    make_step = train_loop.make_train_step

    def capture(**kw):
        s = build_stack(**kw)
        s.feed = stack["feed"] = Recorder(s.feed, keep=warm)
        stack["stack"] = s
        return s

    def returned(*a, **kw):
        step = make_step(*a, **kw)

        def kept(st, batch):
            st, metrics = step(st, batch)
            state.update(st)
            return st, metrics
        return kept

    seen: Dict = {"loss": [], "t": []}
    span: Dict = {}

    def on_step(rec: Dict) -> None:
        k = rec["step"]
        seen["loss"].append(rec["loss"])
        if k == 1:
            m = leaves(state["opt"]["m"])
            seen["grad"] = {p: n / (1 - opt_cfg.b1)
                            for p, n in norms(m).items()}
        if k == warm:
            start = weights.make_params(config, seed, device)
            now, then = leaves(state["params"]), leaves(start)
            seen["change"] = norms({p: now[p].detach().float()
                                    - then[p].float() for p in now})
            del start, now, then
            _sync(device)
            gc.collect()
            gc.freeze()
            span["setup_s"] = time.perf_counter() - t0
        t = time.perf_counter()
        seen["t"].append(t)
        if k < warm:
            return
        if trace_on:
            _trace_step(span, k, warm, mix, device)
        if k > warm and t >= seen["t"][warm - 1] + seconds:
            raise WindowClosed

    train_loop.build_stack = capture
    train_loop.make_train_step = returned
    try:
        train_loop.run_training(model, store, uuids, loader_cfg, loop_cfg,
                                opt_cfg=opt_cfg, state=dict(state),
                                on_metrics=on_step)
    except WindowClosed:
        pass
    finally:
        train_loop.build_stack = build_stack
        train_loop.make_train_step = make_step
        if "stack" in stack:
            stack.pop("stack").close()
        if span.get("profile") and not span["profile"].closed:
            span["profile"].close()
            span["profiled"] = set(range(span["first"], len(seen["t"])))
    _sync(device)
    peak = _peak(device)
    gc.unfreeze()

    feed = stack["feed"]
    n = len(seen["t"])                       # steps run
    ss = feed.step_stats
    profiled = span.get("profiled", set())
    window = range(warm, n)                  # 0-based steps in the window
    t_marks = seen["t"]
    out = {"setup_s": span["setup_s"], "memory_peak_bytes": peak,
           "attempted": n - warm}
    steps_s = t_marks[-1] - t_marks[warm - 1]
    out["e2e"] = {"train_tokens_per_s": (n - warm) * rows * seq / steps_s}
    steady = [k for k in window if k not in profiled]
    out["layer"] = {"kind": "train", "config": config, "rows": rows,
                    "seq": seq, "device_kind": _kind(device),
                    "compute_s": [ss.compute_s[k] for k in steady],
                    "wall_s": [t_marks[k] - t_marks[k - 1] for k in steady]}
    if span.get("profile"):
        p = span["profile"].profile
        out["busy_s"], out["window_s"] = p.busy_s(), p.window_s()
        out["layer"].update(busy_s=out["busy_s"], window_s=out["window_s"])
        out["breakdown"] = p.breakdown()

    kept = feed.kept
    program_readings = {"loss": seen["loss"][:warm], "grad": seen["grad"],
                        "change": seen["change"]}
    del state, params, model, stack, feed
    _free(device)
    t_check = time.perf_counter()
    checked = check(config, mix, cell, seed, data, kept, program_readings,
                    device, control)
    checked["check_s"] = time.perf_counter() - t_check
    out["checks"] = checked["checks"]
    out["failed"] = checked["failed"]
    out["detail"] = checked
    return out


class _Profiled:
    def __init__(self, device):
        self.profile = trace.Profile(device).__enter__()
        self.closed = False

    def close(self) -> None:
        self.profile.__exit__(None, None, None)
        self.closed = True


def _trace_step(span: Dict, k: int, warm: int, mix: Dict, device) -> None:
    """Profile steps ``warm + after .. warm + after + steps - 1`` (1-based),
    opened and closed from the loop's callback."""
    first = warm + mix["trace"]["after_steps"]
    last = first + mix["trace"]["steps"]
    if k == first:
        span["profile"], span["first"] = _Profiled(device), first
    elif k == last and span.get("profile") and not span["profile"].closed:
        span["profile"].close()
        # the next step's wall time holds the profile's reading
        span["profiled"] = set(range(first, last + 1))


def reference_steps(config: Dict, mix: Dict, seed: int, batches, device,
                    quant=None) -> Dict:
    """The reference's readings over ``batches``: each step's loss, each
    leaf's first (clipped) gradient norm, and each leaf's change after
    the last step."""
    params = leaves(weights.make_params(config, seed, device))
    start = {p: t.clone() for p, t in params.items()}
    names = list(params)
    opt = AdamW([params[p] for p in names], mix["optimizer"])
    out: Dict = {"loss": []}
    with exact_f32():
        for i, tokens in enumerate(batches):
            f32 = {p: params[p].float().requires_grad_(True) for p in names}
            ref = Reference(config, _tree(f32), quant=quant)
            loss = ref.train_loss(tokens)
            grads = torch.autograd.grad(loss, [f32[p] for p in names])
            out["loss"].append(float(loss.detach()))
            if i == 0:
                gnorm = torch.sqrt(sum(g.square().sum() for g in grads))
                clip = min(1.0, mix["optimizer"]["clip_norm"]
                           / max(float(gnorm), 1e-9))
                out["grad"] = {p: float(g.norm()) * clip
                               for p, g in zip(names, grads)}
            del f32, ref, loss
            opt.update(list(grads))
            del grads
    out["change"] = norms({p: params[p].float() - start[p].float()
                           for p in names})
    return out


def compare(got: Dict, ref: Dict) -> Dict[str, float]:
    """The three numbers a cell may compare (those its limits name): the
    widest loss gap over the steps, and by the worst leaf the gap of the
    first gradient's norm and of the change's norm, each against the
    reference's norm of that leaf or of the median leaf, whichever is
    larger.  Leaves whose reference gradient is under a thousandth of the
    median leaf's are left out of the change: Adam moves them by
    round-off alone."""
    loss = max(abs(a - b) for a, b in zip(got["loss"], ref["loss"]))
    g_med = float(np.median(list(ref["grad"].values())))
    grad = max(abs(got["grad"][p] - r) / max(r, g_med)
               for p, r in ref["grad"].items())
    moved = [p for p, g in ref["grad"].items() if g >= 1e-3 * g_med]
    c_med = float(np.median([ref["change"][p] for p in moved]))
    change = max(abs(got["change"][p] - ref["change"][p])
                 / max(ref["change"][p], c_med) for p in moved)
    return {"loss_gap": loss, "grad_norm_gap": grad,
            "change_norm_gap": change}


def delivered_rows(data: np.ndarray, kept) -> tuple:
    """The delivered rows as tensors of the dataset's own rows, and how
    many delivered rows are no row of the dataset, repeat one, or come
    with a loss mask that is not all ones."""
    index = {data[i].tobytes(): i for i in range(len(data))}
    bad, used, batches = 0, set(), []
    for b in kept:
        ids = []
        for row, mask in zip(b["tokens"], b["loss_mask"]):
            i = index.get(row.astype(np.int32).tobytes())
            if i is None or i in used or not np.all(mask == 1):
                bad += 1
            else:
                used.add(i)
                ids.append(i)
        batches.append(ids)
    return batches, bad


def check(config: Dict, mix: Dict, cell: Dict, seed: int, data, kept,
          got: Dict, device, control: bool = False) -> Dict:
    ids, bad = delivered_rows(data, kept)
    batches = [torch.from_numpy(data[b]).to(device) for b in ids]
    ref = reference_steps(config, mix, seed, batches, device)
    gaps = compare(got, ref)
    limits = cell["limits"]
    out = {"program": gaps, "loss_program": got["loss"],
           "loss_reference": ref["loss"]}
    if control:
        ctrl = reference_steps(config, mix, seed, batches, device, "fp8")
        gaps = out["control"] = compare(ctrl, ref)
    checks = {k: (v, limits[k]) for k, v in gaps.items() if k in limits}
    checks["rows_not_delivered_as_stored"] = (bad, 0)
    out["checks"] = checks
    out["failed"] = sum(v > lim for v, lim in checks.values())
    return out


def _tree(flat: Dict[str, torch.Tensor]) -> Dict:
    tree: Dict = {}
    for path, t in flat.items():
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = t
    return tree


def _kind(device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" \
        else device.type


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


__all__ = ["run", "check", "compare", "reference_steps", "delivered_rows",
           "Recorder", "WindowClosed"]
