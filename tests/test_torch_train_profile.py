"""``tools/torch_train_profile.py`` on the CPU: it refuses to run without a
card, and its split of a step by where the work was launched
(``scope_times``) finds Hymba's Mamba scan in the forward, in remat's
recompute and in the backward, and AdamW whole (the port's
``train.optimizer`` span), on a CPU profile of the
smoke config's train step (CPU time standing in for the card's kernel
time)."""

import importlib.util
import subprocess
import sys
from pathlib import Path
from unittest import mock

import pytest
import torch

from repro_torch.configs.base import get_arch
from repro_torch.models import build_model, ssm
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step

ROOT = Path(__file__).resolve().parents[1]
_spec = importlib.util.spec_from_file_location(
    "torch_train_profile", ROOT / "tools" / "torch_train_profile.py")
tool = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(tool)


def test_exits_nonzero_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "tools/torch_train_profile.py",
                          "--arch", "hymba_1_5b"], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0 and "{" not in out.stdout


def test_scope_times_split_a_hymba_step():
    cfg = get_arch("hymba_1_5b").smoke_config().scaled(remat=True)
    model = build_model(cfg, device="cpu")
    opt = OptimizerConfig(total_steps=4)
    gen = torch.Generator().manual_seed(0)
    state = init_state(model, opt, gen)
    batch = {"tokens": torch.randint(0, cfg.vocab, (2, 300), generator=gen,
                                     dtype=torch.int32)}
    step = make_train_step(model, opt)
    with mock.patch.object(ssm, "_ssm_scan_chunked", tool.annotated(
            "mamba_scan", ssm._ssm_scan_chunked)), tool.spans_on(), \
            torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        step(state, batch)
    events = prof.events()
    got = tool.scope_times(events, tool.SCOPES,
                           lambda e: e.self_cpu_time_total)
    scans = [e for e in events if e.name == "mamba_scan"]
    adamw = [e for e in events if e.name == "train.optimizer"]
    # each layer's scan runs in the forward and again in remat's recompute
    assert len(scans) == 2 * cfg.n_layers and len(adamw) == 1
    # AdamW runs no autograd: exactly the time under its annotation
    assert got["train.optimizer"] == pytest.approx(adamw[0].cpu_time_total,
                                                   rel=1e-9)
    # the scan's backward adds to the time under its annotations, and the
    # rest of the step (attention, the MLP, their recompute) stays out
    under = sum(e.cpu_time_total for e in scans)
    total = sum(e.self_cpu_time_total for e in events
                if e.device_type == torch.autograd.DeviceType.CPU)
    assert under < got["mamba_scan"] < total - got["train.optimizer"]
