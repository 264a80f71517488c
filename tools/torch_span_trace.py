#!/usr/bin/env python3
"""A benchmark cell run with the program's spans on: the per-layer metrics
of ``perfbench/span_metrics.json``, the spans' detail, and whether the
spans account for the work.

    python3 tools/torch_span_trace.py --workload NAME --seed N [N ...]
        [--seconds S] [--cost] [--out FILE] [--device cuda|cpu] [--root DIR]

Each run calls the cell's own driver (``perfbench/drivers/``) as
``perfbench/run.py`` does, in this process, with ``repro_torch.core.spans``
on.  Without ``--cost`` the run is traced (``--trace 1``'s profiled
slice); the tool keeps the driver's ``perfbench.trace.Profile`` and the
serving engine's counters after each step, adds ``spans``,
``span_device`` and ``counters`` to the driver's ``layer`` (see
``perfbench/spans.py``) and reads each metric with its reader in
``perfbench/metrics/``.  It prints, per run, those metrics, the detail
(``span_host_ms``, ``harness_ms``, ``idle_by_span``, the kernel builds)
and ``accounting``: the share of the slice's device time launched inside
the step spans and inside ``engine.forward``, the children of
``engine.step`` against its duration, ``unembed_ms`` against its kernels'
time by name over the slice, ``tokens_out`` against the driver's count of
served tokens, and the train step's three spans against its busy time;
``misses`` names each of these that falls outside its limit (``LIMITS``).
The tool exits non-zero when a run is not correct or a traced run's
accounting misses, so a wrong link between launches and kernels cannot
pass silently.

With ``--cost`` each seed runs untraced twice, spans off and on, in turns
(off, on; then on, off), and each run prints its end-to-end metrics and
mean host-clock step: the cost of the spans when on.  With ``--cost
--toggle K`` (serving) each seed runs once, its spans turned on and off
every K engine steps, and prints the mean and median host-clock step of
each state over the same stretch of the window, with the garbage
collector's passes and seconds in each state.

The first run in a process builds the kernels; later runs find them
loaded.  Without a card, ``--device cpu`` runs the cell on the kernels'
plain versions (a tiny cell: see ``perfbench/tests/``).  The last line of
standard output is one JSON object of every run; ``--out`` also writes it
to a file.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import importlib
import json
import subprocess
import sys
import time
from pathlib import Path
from typing import Dict, Iterator, List, Optional

ROOT = Path(__file__).resolve().parents[1]
for p in (ROOT, ROOT / "src"):
    if str(p) not in sys.path:
        sys.path.insert(0, str(p))

ENTRIES = Path("perfbench") / "span_metrics.json"
ENGINE_CHILDREN = ("engine.admit", "engine.upload", "engine.forward",
                   "engine.readback", "engine.emit")
TRAIN_PARTS = ("train.forward", "train.backward", "train.optimizer")
# the accounting's limits: the share of the slice's busy time launched
# inside ``engine.step`` (at least), the children of ``engine.step``
# against its host time, ``unembed_ms`` against its kernels by name, and
# train's three spans against the busy time (each as |x - 1|, at most)
LIMITS = {"step_device_share": 0.99, "children_of_step": 0.03,
          "unembed_vs_kernels": 0.10, "parts_over_busy": 0.03}


@contextlib.contextmanager
def watched(profiles: List, counters: Dict, toggle: int = 0
            ) -> Iterator[None]:
    """Within the block, every ``perfbench.trace.Profile`` the driver opens
    is kept in ``profiles``, and ``counters`` holds the serving engine's
    counts after each of its steps.  With ``toggle``, spans are turned on
    and off every ``toggle`` engine steps (off first),
    ``counters["spans_on"]`` lists each step's state and
    ``counters["gc"]`` the collector's passes and seconds in each (and
    under ``long`` each pass over a millisecond: the steps before it, the
    state, its generation and seconds; the driver's own collection after
    the window is the last)."""
    from perfbench import spans as readings
    from perfbench import trace
    from repro_torch.core import spans
    from repro_torch.serve.engine import ServingEngine
    profile, step = trace.Profile, ServingEngine.step
    modes: List[bool] = []
    collected: Dict = {"off": [0, 0.0], "on": [0, 0.0]}
    began = [0]

    class Kept(profile):
        def __enter__(self):
            profiles.append(self)
            return super().__enter__()

        def _read(self, events):
            self.launched = readings.launches(events)
            super()._read(events)

    def counted(engine):
        if toggle:
            on = (engine.steps // toggle) % 2 == 1
            (spans.enable if on else spans.disable)()
            modes.append(on)
        step(engine)
        counters.update(steps=engine.steps, slot_steps=engine.slot_steps,
                        prompt_tokens_fed=engine.prompt_tokens_fed,
                        tokens_out=engine.tokens_out)
        if toggle:
            counters["spans_on"] = modes
            counters["gc"] = collected

    def timed(phase, info):
        if phase == "start":
            began[0] = time.perf_counter_ns()
        elif modes:
            took = (time.perf_counter_ns() - began[0]) / 1e9
            c = collected["on" if modes[-1] else "off"]
            c[0] += 1
            c[1] += took
            if took > 1e-3:             # and when, of generation what
                collected.setdefault("long", []).append(
                    [len(modes), modes[-1], info["generation"], took])

    trace.Profile, ServingEngine.step = Kept, counted
    if toggle:
        gc.callbacks.append(timed)
    try:
        yield
    finally:
        trace.Profile, ServingEngine.step = profile, step
        if toggle:
            gc.callbacks.remove(timed)


def drive(root: Path, name: str, seed: int, seconds: float, traced: bool,
          device, spans_on: bool, toggle: int = 0) -> Dict:
    """One run of the cell's driver, with spans on or off; returns the
    driver's result and, with spans on, the records, the profile and the
    engine's counters."""
    import torch

    from perfbench import run
    from repro_torch.core import spans
    from repro_torch.kernels import build
    cell = run.load_cell(root, name)
    driver = importlib.import_module(
        f"perfbench.drivers.{cell['mix']['driver']}")
    profiles: List = []
    counters: Dict = {}
    before = dict(build.counts)
    if device.type == "cuda":           # each run's peak is its own
        torch.cuda.reset_peak_memory_stats(device)
    spans.take()
    (spans.enable if spans_on else spans.disable)()
    try:
        with watched(profiles, counters, toggle):
            got = driver.run(cell["config"], cell["mix"], cell["cell"], seed,
                             seconds, traced, device, time.perf_counter())
    finally:
        spans.disable()
        gc.collect()                    # the last run's card memory back
        if device.type == "cuda":
            torch.cuda.empty_cache()
    records = spans.take()
    builds = {k: build.counts[k] - before[k] for k in before}
    builds["build_s"] = sum(r.end_ns - r.start_ns for r in records
                            if r.name == "kernels.build") / 1e9
    return {"cell": cell, "got": got, "records": records,
            "profile": profiles[-1] if profiles else None,
            "counters": counters, "builds": builds}


def layer_of(ran: Dict) -> Dict:
    """The driver's ``layer`` with the spans' three keys added."""
    from perfbench import spans as readings
    layer = dict(ran["got"]["layer"])
    records, prof = ran["records"], ran["profile"]
    if records:
        layer["spans"] = records
    if ran["counters"]:
        layer["counters"] = dict(ran["counters"])
    if prof is not None and records:
        layer["span_device"] = readings.device_by_span(
            prof, {r.name for r in records}, prof.launched)
    return layer


def metrics_of(root: Path, name: str, layer: Dict) -> Dict:
    """Each metric of the checkout's ``perfbench/span_metrics.json`` that
    lists the cell, as its reader gives it (left out where it gives
    None)."""
    from perfbench import run
    out = {}
    for m in json.loads((root / ENTRIES).read_text()):
        if name not in m["workloads"]:
            continue
        value = run.reader(m["name"])(layer)
        if value is not None:
            out[m["name"]] = {"value": value, "unit": m["unit"]}
    return out


def accounting(ran: Dict, layer: Dict) -> Dict:
    """Whether the spans account for the work (see the docstring)."""
    from perfbench import spans as readings
    from perfbench.trace import union_ns
    got, prof, records = ran["got"], ran["profile"], layer.get("spans", [])
    out: Dict = {}
    if layer.get("kind") == "serve":
        tops = readings.steps_before(layer, prof)
        step_ns = sum(records[i].end_ns - records[i].start_ns for i in tops)
        kids = readings.child_ms(records, tops, ENGINE_CHILDREN)
        if step_ns:
            out["children_of_step"] = kids * len(tops) * 1e6 / step_ns
        served = got["e2e"]["gen_tokens_per_s"] * got["detail"]["window_s"]
        out["tokens_out"] = layer.get("counters", {}).get("tokens_out")
        out["tokens_served_by_the_driver"] = round(served)
    dev = layer.get("span_device")
    if prof is None or not dev or layer.get("device_kind") == "cpu":
        out["misses"] = misses(out)
        return out
    busy = prof.busy_s()
    a, b = prof.window_ns
    out["busy_s"] = busy
    # the device time whose launch was found in the slice, of the busy
    out["linked_share"] = union_ns(
        (max(s, a), min(e, b)) for t, s, e, _ in prof.launched
        if a <= t <= b and e > a and s < b) / 1e9 / busy
    if layer["kind"] == "serve":
        steps = dev["engine.step"]["calls"]
        out["step_device_share"] = dev["engine.step"]["device_s"] / busy
        out["forward_device_share"] = \
            dev.get("engine.forward", {}).get("device_s", 0.0) / busy
        inside = kernels_inside(prof, "unembed")
        out["unembed_kernels_s"] = inside
        out["unembed_ms"] = readings.per_step_ms(layer, "serve", "unembed")
        out["unembed_kernel_names_ms_per_step"] = 1e3 * sum(
            kernels_named(prof, inside).values()) / steps
        # the benchmark's own kernel ranges, linked both ways
        ranges = readings.device_by_span(
            prof, ("perfbench.grouped_matmul", "perfbench.flash_decode"),
            prof.launched)
        out["kernel_ranges_device_s"] = {
            n: {"cupti_link": ranges.get(n, {}).get("device_s"),
                "profile_link": sum(prof.device_s_of(n))}
            for n in ("perfbench.grouped_matmul", "perfbench.flash_decode")}
    else:
        steps = dev["train.step"]["calls"]
        parts = sum(dev.get(p, {}).get("device_s", 0.0)
                    for p in TRAIN_PARTS)
        out["parts_over_busy"] = parts / busy
        out["step_device_share"] = dev["train.step"]["device_s"] / busy
    out["profiled_steps"] = steps
    out["misses"] = misses(out)
    return out


def misses(acc: Dict) -> List[str]:
    """The accounting's readings that fall outside ``LIMITS``."""
    out = []
    if "children_of_step" in acc and \
            abs(acc["children_of_step"] - 1) > LIMITS["children_of_step"]:
        out.append("children_of_step")
    if acc.get("tokens_out") != acc.get("tokens_served_by_the_driver"):
        out.append("tokens_out")
    if "parts_over_busy" in acc:
        if abs(acc["parts_over_busy"] - 1) > LIMITS["parts_over_busy"]:
            out.append("parts_over_busy")
    elif "step_device_share" in acc and \
            acc["step_device_share"] < LIMITS["step_device_share"]:
        out.append("step_device_share")
    if "unembed_kernel_names_ms_per_step" in acc:
        ref = acc["unembed_kernel_names_ms_per_step"]
        if not ref or acc["unembed_ms"] is None or \
                abs(acc["unembed_ms"] / ref - 1) > \
                LIMITS["unembed_vs_kernels"]:
            out.append("unembed_vs_kernels")
    return out


def kernels_inside(prof, name: str) -> Dict[str, float]:
    """Device seconds by kernel name of what was launched inside the
    profile's ``name`` annotations in its slice."""
    a, b = prof.window_ns
    spans = sorted((s, e) for s, e, n in prof.annotations
                   if n == name and s >= a and e <= b)
    out: Dict[str, float] = {}
    j = 0
    for t, s, e, n in prof.launched:
        while j < len(spans) and spans[j][1] < t:
            j += 1
        if j < len(spans) and spans[j][0] <= t:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
    return out


def kernels_named(prof, names) -> Dict[str, float]:
    """Device seconds over the whole slice of the kernels named."""
    a, b = prof.window_ns
    out: Dict[str, float] = {}
    for s, e, n, _ in prof.device_ops:
        if n in names and s >= a and e <= b:
            out[n] = out.get(n, 0.0) + (e - s) / 1e9
    return out


def traced_run(root: Path, name: str, seed: int, seconds: float,
               device) -> Dict:
    from perfbench import spans as readings
    ran = drive(root, name, seed, seconds, True, device, True)
    layer = layer_of(ran)
    got = ran["got"]
    skip = ran["cell"]["mix"].get("warmup_steps", 0) \
        if layer.get("kind") == "train" else 0
    return {"workload": name, "seed": seed, "spans": True, "trace": True,
            "correct": correct(got), "metrics": metrics_of(root, name, layer),
            "e2e": got["e2e"], "setup_s": got["setup_s"],
            "counters": layer.get("counters"),
            "span_device": layer.get("span_device"),
            "detail": dict(readings.detail(layer, ran["profile"], skip),
                           kernel_builds=ran["builds"]),
            "accounting": accounting(ran, layer),
            "breakdown": got.get("breakdown")}


def cost_run(root: Path, name: str, seed: int, seconds: float, device,
             spans_on: bool) -> Dict:
    from perfbench import spans as readings
    ran = drive(root, name, seed, seconds, False, device, spans_on)
    got, layer = ran["got"], layer_of(ran)
    out = {"workload": name, "seed": seed, "spans": spans_on, "trace": False,
           "correct": correct(got), "e2e": got["e2e"],
           "setup_s": got["setup_s"], "kernel_builds": ran["builds"],
           "records": len(ran["records"])}
    if layer.get("kind") == "serve":
        out["step_ms"] = 1e3 * sum(layer["step_s"]) / len(layer["step_s"])
        out["steps"] = len(layer["step_s"])
    else:
        out["step_ms"] = 1e3 * sum(layer["compute_s"]) / len(
            layer["compute_s"])
    if spans_on:
        skip = ran["cell"]["mix"].get("warmup_steps", 0) \
            if layer.get("kind") == "train" else 0
        out["detail"] = readings.detail(layer, None, skip)
        out["counters"] = layer.get("counters")
    return out


def toggled_run(root: Path, name: str, seed: int, seconds: float, device,
                toggle: int) -> Dict:
    """One untraced serving run with spans turned on and off every
    ``toggle`` engine steps: the host-clock step ms of each state over the
    same stretch of the window, and the collector's passes and seconds in
    each."""
    ran = drive(root, name, seed, seconds, False, device, False, toggle)
    got, layer = ran["got"], ran["got"]["layer"]
    modes = ran["counters"]["spans_on"]
    out = {"workload": name, "seed": seed, "toggle": toggle,
           "correct": correct(got),
           "e2e": got["e2e"], "records": len(ran["records"]),
           "gc": ran["counters"]["gc"]}
    for on in (False, True):
        ms = sorted(1e3 * t for t, m in zip(layer["step_s"], modes)
                    if m == on)
        key = "on" if on else "off"
        out[f"step_ms_{key}"] = sum(ms) / len(ms)
        out[f"step_ms_median_{key}"] = ms[len(ms) // 2]
        out[f"steps_{key}"] = len(ms)
    return out


def correct(got: Dict) -> bool:
    return all(v <= lim for v, lim in got["checks"].values())


def card(device) -> Dict:
    import torch
    if device.type != "cuda":
        return {"kind": device.type}
    out = {"kind": torch.cuda.get_device_name(device)}
    try:
        out["power_limit"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        out["power_limit"] = f"not read: {e}"
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=None,
                    help="the window (default: BENCHMARK.json's run_seconds)")
    ap.add_argument("--cost", action="store_true")
    ap.add_argument("--toggle", type=int, default=0,
                    help="with --cost, one run a seed with spans turned on "
                    "and off every N engine steps")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--out", type=Path, default=None)
    args = ap.parse_args(argv)
    import torch

    from perfbench import run
    run.pin_caches(ROOT)
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        print("torch_span_trace: no CUDA card; --device cpu runs the plain "
              "kernels", file=sys.stderr)
        return 1
    if device.type == "cuda":           # before its memory stats are reset
        torch.cuda.init()
    seconds = args.seconds or json.loads(
        (args.root / "BENCHMARK.json").read_text())["run_seconds"]
    runs = []
    for i, seed in enumerate(args.seed):
        if args.cost and args.toggle:
            runs.append(toggled_run(args.root, args.workload, seed, seconds,
                                    device, args.toggle))
            print(json.dumps(runs[-1]), flush=True)
        elif args.cost:
            for on in ((False, True) if i % 2 == 0 else (True, False)):
                runs.append(cost_run(args.root, args.workload, seed, seconds,
                                     device, on))
                print(json.dumps(runs[-1]), flush=True)
        else:
            runs.append(traced_run(args.root, args.workload, seed, seconds,
                                   device))
            print(json.dumps(runs[-1]), flush=True)
    out = {"device": card(device), "runs": runs}
    if args.out:
        args.out.parent.mkdir(parents=True, exist_ok=True)
        args.out.write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    missed = [(r["seed"], r["accounting"]["misses"]) for r in runs
              if r.get("accounting", {}).get("misses")]
    if missed:
        print(f"torch_span_trace: the accounting missed {missed}",
              file=sys.stderr)
    return 0 if all(r["correct"] for r in runs) and not missed else 1


if __name__ == "__main__":
    sys.exit(main())
