"""``chip_smoke.py``'s phases I, J and K (training Hymba-1.5B, xLSTM-350M
and Whisper-tiny, each with its f32 check) rehearsed on the CPU at each
family's smoke config.  Kept apart from ``tests/test_torch_chip_smoke.py``:
phase J's rehearsal (xLSTM's sLSTM loop) is the suite's longest test."""

import numpy as np
import pytest
import torch

import chip_smoke


FAMILY_TRAIN_SMOKE = {"I": ("hymba_1_5b", 40), "J": ("xlstm_350m", 300),
                      "K": ("whisper_tiny", 40)}


@pytest.mark.parametrize("phase", sorted(FAMILY_TRAIN_SMOKE))
def test_family_training_phases_rehearse_on_cpu(phase):
    """Phases I, J and K on the CPU at each family's smoke config with
    remat: 3 steps at 2 x 64 tokens (xLSTM 1, timed; Whisper's
    through its own loop with make_batch's frames), finite losses and
    norms, every probe of the
    family's tree moved, no kernel launched; the last step's flop count
    equal to the dry run's (phase H) for I and K, none taken for J; then
    the f32 check (CPU against CPU) at zero, xLSTM's over two mLSTM
    chunks, where the reference's gradient is NaN."""
    arch, check_seq = FAMILY_TRAIN_SMOKE[phase]
    assert chip_smoke.FAMILY_TRAIN[phase][0] == arch
    sizes, check = chip_smoke.FAMILY_TRAIN[phase][1:]
    cfg = chip_smoke.get_arch(arch).smoke_config().scaled(remat=True)
    steps = min(sizes["steps"], 3)
    out = chip_smoke.drive_family_training(
        torch.device("cpu"), "cpu", cfg, dict(sizes, batch=2, seq=64,
                                              steps=steps),
        dict(check, seq=check_seq))
    run = out["run"]
    assert run["steps"] == steps == len(run["losses"])
    assert all(np.isfinite(run["losses"] + run["grad_norms"]))
    assert not any(run["launches"].values())
    want = {"I": {"embedding", "wq layer 0", "w_down last layer",
                  "mamba w_in layer 0"},
            "J": {"embedding", "mlstm wq pair 0", "slstm r_gates last pair"},
            "K": {"embedding", "encoder wq layer 0", "cross wq last layer",
                  "mlp w_out last layer"}}[phase]
    assert set(run["changed"]) == want
    assert all(v > 0 for v in run["changed"].values())
    if phase == "J":
        assert run["step_flops"] is None
        assert run["ms_per_step"] == run["ms_per_step_all"][0]
        assert run["ms_per_slstm_step_layer_derived"] == pytest.approx(
            run["ms_per_step"] / 64)
    else:
        rec = chip_smoke.dry_cell(cfg, "train", 64, 2, microbatches=1,
                                  opt_cfg=chip_smoke.OptimizerConfig(
                                      total_steps=steps,
                                      **chip_smoke.TRAIN_OPT))
        assert int(rec["flops_per_device"]) == run["step_flops"] > 0
    assert ("stall_frac" in run) == (phase != "K")
    assert out["check"]["loss_max_abs_diff"] == 0.0
    assert out["check"]["grad_max_rel_diff"] == 0.0
    assert out["seconds"] > 0
