"""``chip_smoke.py``'s phase G (Grok-1 on int8 AdamW moments, its f32
checks of both quantized states, the state restored onto a mesh and the
compressed all-reduce) rehearsed on the CPU at Grok-1's smoke config.
Kept apart from ``tests/test_torch_chip_smoke.py``, whose other
rehearsals it would lengthen on one test worker."""

import torch

import chip_smoke


def test_int8_training_phase_rehearses_on_cpu():
    """Phase G on the CPU at Grok-1's smoke config: run_training on int8
    moments with the probes moved and no kernel launched; the f32 check
    (CPU against CPU) at zero for both quantized state dtypes, moments
    included; the int8 state restored onto a 1 x 1 mesh over a one-rank
    gloo group bit for bit, and compressed_psum_grads equal to itself."""
    cpu = torch.device("cpu")
    cfg = chip_smoke.get_arch(chip_smoke.MOE_ARCH).smoke_config().scaled(
        n_layers=2, remat=True)
    out = chip_smoke.drive_int8_training(
        cpu, "cpu", cfg, batch=2, seq=1024, steps=3,
        check_cfg=cfg.scaled(n_layers=1, dtype="float32"), check_seq=1024)
    run = out["run"]
    assert run["steps"] == 3 and run["state_dtype"] == "int8"
    assert run["layers"] == 2 and len(run["moe_aux_loss"]) == 3
    assert all(v > 0 for v in run["changed"].values())
    for sd in chip_smoke.INT8_CHECK_STATES:
        check = out["checks"][sd]
        assert check["state_dtype"] == sd
        assert check["loss_max_abs_diff"] == 0.0
        assert check["grad_max_rel_diff"] == 0
        zero = {"int8_codes": 0, "int8_excess": 0.0, "f32_rel": 0.0}
        assert check["moment_err"] == check["moment_err_last"] == zero
        assert "state" not in check and "grads" not in check
    mesh = out["mesh"]
    assert mesh["backend"] == "gloo" and mesh["restore_bit_exact"]
    assert mesh["compress_max_abs_diff"] == 0.0 and mesh["step"] == 3
    assert not any(out["launches"].values())
    assert not torch.distributed.is_initialized()
