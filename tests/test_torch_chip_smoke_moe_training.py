"""``chip_smoke.py``'s phase C (Grok-1's MoE training path, its f32 check
and the training forward against the serving forward) rehearsed on the
CPU at Grok-1's smoke config.  Kept apart from
``tests/test_torch_chip_smoke.py``, whose other rehearsals it would
lengthen on one test worker."""

import torch

import chip_smoke


def test_moe_training_phase_rehearses_on_cpu():
    """Phase C on the CPU at Grok-1's smoke config: run_training over the
    loader with the MoE metrics, the probes (router, an expert) moved, no
    kernel launched; the f32 check (CPU against CPU) at zero, and the
    training forward against the serving forward (plain versions)."""
    cpu = torch.device("cpu")
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).smoke_config().scaled(
        n_layers=1, remat=True)
    run = chip_smoke.drive_training(cpu, "cpu", cfg, batch=2, seq=1024,
                                    steps=3)
    assert run["steps"] == 3 and len(run["moe_aux_loss"]) == 3
    assert set(run["changed"]) == {"embedding", "wq layer 0",
                                   "router last layer",
                                   "w_down expert 0 last layer"}
    experts = 3 * cfg.n_experts * cfg.d_model * cfg.d_ff
    assert run["active_params"] == run["params"] - experts + experts // 2
    out = chip_smoke.check_f32_training(
        cpu, cfg, batch=1, seq=1024, restart=False, serving=True)
    assert out["loss_max_abs_diff"] == 0.0 and out["grad_max_rel_diff"] == 0
    assert out["serving"]["chunks"] == 2
    assert out["serving"]["max_abs_diff"] <= chip_smoke.CHECK_TOL
    assert "restart" not in out
