"""The twin of ``tests/test_arch_smoke.py`` on the port, on the CPU: for
every one of the ten configs, the full config builds (nothing is
allocated until ``init``), and its smoke config takes a train step that
moves the parameters, two finite decode steps and eight steps on one
batch that lower the loss; ``long_500k`` applies to the ssm and hybrid
families only.  Batches come from each model's ``make_batch`` with a
seeded ``torch.Generator``.  (``input_specs`` and ``input_logical_axes``
come with ROADMAP A9.)"""

import numpy as np
import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, applicable_shapes,
                                      get_arch)
from repro_torch.models import build_model
from repro_torch.models.params import count_params, tree_leaves
from repro_torch.train.optimizer import OptimizerConfig
from repro_torch.train.step import init_state, make_train_step


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _smoke(arch_id):
    return build_model(get_arch(arch_id).smoke_config(), device="cpu")


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_full_config_loads(arch_id):
    cfg = get_arch(arch_id)
    assert cfg.n_layers > 0 and cfg.d_model > 0 and cfg.vocab > 0
    n = count_params(build_model(cfg, device="cpu").param_specs())
    assert n > 1e6  # full configs are real-sized


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_train_step(arch_id):
    model = _smoke(arch_id)
    opt = OptimizerConfig(total_steps=10, peak_lr=1e-3)
    state = init_state(model, opt, _gen())
    before = [p.detach().clone() for p in tree_leaves(state["params"])]
    batch = model.make_batch(_gen(1), SHAPES["train_4k"].smoke())
    state, metrics = make_train_step(model, opt)(state, batch)
    assert np.isfinite(float(metrics["loss"]))
    assert float(metrics["grad_norm"]) > 0
    delta = [float((a.detach() - b).abs().max())
             for a, b in zip(tree_leaves(state["params"]), before)]
    assert max(delta) > 0


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_decode_step(arch_id):
    model = _smoke(arch_id)
    params = model.init(_gen())
    shape = SHAPES["decode_32k"].smoke()
    batch = model.make_batch(_gen(1), shape)
    with torch.no_grad():
        logits, cache = model.decode_step(params, batch["cache"],
                                          batch["tokens"])
        assert logits.shape == (shape.global_batch, 1, model.cfg.vocab)
        assert torch.isfinite(logits).all()
        logits2, _ = model.decode_step(params, cache, batch["tokens"])
    assert torch.isfinite(logits2).all()
    assert not torch.equal(logits, logits2)   # the second step advanced


@pytest.mark.parametrize("arch_id", ARCH_IDS)
def test_smoke_loss_decreases(arch_id):
    """A few steps on a repeated batch must reduce the loss."""
    model = _smoke(arch_id)
    opt = OptimizerConfig(total_steps=20, peak_lr=3e-3, warmup_steps=2)
    state = init_state(model, opt, _gen())
    batch = model.make_batch(_gen(1), SHAPES["train_4k"].smoke())
    step = make_train_step(model, opt)
    losses = []
    for _ in range(8):
        state, metrics = step(state, batch)
        losses.append(float(metrics["xent"]))
    assert losses[-1] < losses[0], losses


def test_long_500k_only_for_subquadratic():
    for arch_id in ARCH_IDS:
        cfg = get_arch(arch_id)
        shapes = applicable_shapes(cfg)
        if cfg.family in ("ssm", "hybrid"):
            assert "long_500k" in shapes
        else:
            assert "long_500k" not in shapes


# ---- the launchers on the hybrid, ssm and audio families ----------------

@pytest.mark.parametrize("arch_id", ["hymba_1_5b", "xlstm_350m",
                                     "whisper_tiny"])
def test_serve_launcher_serves_the_family_on_cpu(arch_id, capsys):
    from repro_torch.launch import serve
    serve.main(["--arch", arch_id, "--device", "cpu", "--requests", "4",
                "--slots", "2", "--max-new-tokens", "3"])
    out = capsys.readouterr().out
    assert "served 4 requests, 12 tokens" in out and "cpu" in out


@pytest.mark.parametrize("arch_id", ["hymba_1_5b", "xlstm_350m"])
def test_train_launcher_trains_the_family_on_cpu(arch_id, capsys):
    from repro_torch.launch import train
    train.main(["--arch", arch_id, "--device", "cpu", "--steps", "2",
                "--batch-size", "4", "--seq-len", "32"])
    assert "over 2 steps on cpu" in capsys.readouterr().out


def test_train_launchers_both_lack_whisper_frames(monkeypatch):
    """The reference's training loop feeds tokens and a loss mask only, so
    its launcher cannot train Whisper, whose forward needs frames: it
    raises ``KeyError('frames')``, and the port's does the same."""
    import repro.launch.train as jax_train
    from repro_torch.launch import train
    argv = ["--arch", "whisper_tiny", "--steps", "2", "--batch-size", "4",
            "--seq-len", "32"]
    monkeypatch.setattr("sys.argv", ["train"] + argv)
    with pytest.raises(KeyError, match="frames"):
        jax_train.main()
    with pytest.raises(KeyError, match="frames"):
        train.main(argv + ["--device", "cpu"])
