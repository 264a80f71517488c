"""``benchmarks/bench_torch_roofline.py`` against the reference's
``benchmarks/bench_roofline.py``, and the kernels' bounds in
``chip_smoke.py`` against ``repro_torch.kernels.cost``.

The records are the committed dry run, ``results/dryrun_torch.jsonl``
(``python -m repro_torch.launch.dryrun --both-meshes``); the reference's
functions run on them with its constants set to the H100's."""

from pathlib import Path

import pytest

from benchmarks import bench_roofline as ref
from benchmarks import bench_torch_roofline as port
from repro_torch.configs.base import all_cells
from repro_torch.kernels import cost
from repro_torch.launch.mesh import HW
from repro_torch.launch.op_cost import COLLECTIVE_OPS

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
RECORDS = port.load_results()
KEYS = {"arch", "shape", "mesh", "devices", "flops_per_device",
        "bytes_per_device", "collective_bytes_per_device",
        "raw_cost_analysis", "memory", "model_flops_total", "lower_s",
        "compile_s"}


def test_every_cell_on_both_meshes_with_the_reference_keys():
    """One record per cell and mesh, in the CLI's order, each with the
    reference's keys (and the kernel calls it counted)."""
    want = [(a, s, m) for a, s in all_cells() for m in ("16x16", "2x16x16")]
    assert [(r["arch"], r["shape"], r["mesh"]) for r in RECORDS] == want
    for r in RECORDS:
        assert KEYS <= set(r), r["arch"]
        assert set(r["memory"]) == {"argument_bytes", "output_bytes",
                                    "temp_bytes", "alias_bytes"}
        assert set(r["collective_bytes_per_device"]) == \
            set(COLLECTIVE_OPS) | {"total"}
        assert r["devices"] == (256 if r["mesh"] == "16x16" else 512)
        assert r["flops_per_device"] > 0 and r["bytes_per_device"] > 0


@pytest.mark.parametrize("rec", RECORDS,
                         ids=[f"{r['arch']}-{r['shape']}-{r['mesh']}"
                              for r in RECORDS])
def test_roofline_terms_match_reference(monkeypatch, rec):
    """The reference's ``roofline_terms`` with its constants set to the
    H100's gives the twin's terms, fractions and footprint; only the fit
    differs (16 GiB of a v5e against the H100's 80 GB)."""
    monkeypatch.setattr(ref, "PEAK_FLOPS", HW["peak_bf16_flops"])
    monkeypatch.setattr(ref, "HBM_BW", HW["hbm_bandwidth"])
    monkeypatch.setattr(ref, "ICI_BW", HW["link_bandwidth"])
    want, got = ref.roofline_terms(rec), port.roofline_terms(rec)
    assert want.pop("fits_16g") == (got["hbm_gib"] <= 16)
    assert got.pop("fits_80g") == (got["hbm_gib"] * 2 ** 30 <=
                                   HW["hbm_bytes"])
    assert got == want


def test_committed_csv_is_the_twins_output(tmp_path):
    out = tmp_path / "roofline_torch.csv"
    text = port.run(out_csv=str(out))
    assert out.read_text() == (ROOT / "results" /
                               "roofline_torch.csv").read_text()
    assert text.count("\n") == 2 * (len(all_cells()) + 2) + 2


def test_h100_constants_are_the_data_sheets():
    assert (port.PEAK_FLOPS, port.HBM_BW, port.LINK_BW) == (
        989.4e12, 3.35e12, 50e9)
    peak = cost.PEAKS["NVIDIA H100 80GB HBM3"]
    assert (peak["bf16_flops"], peak["bytes_per_s"]) == (
        HW["peak_bf16_flops"], HW["hbm_bandwidth"])


def test_chip_smoke_bounds_come_from_kernels_cost():
    """The bounds ``chip_smoke.py`` prints are ``cost``'s formulas over
    the data sheet: the same numbers, shape for shape."""
    kind = "NVIDIA H100 80GB HBM3"
    assert chip_smoke.PEAKS is cost.PEAKS
    assert chip_smoke.causal_pairs is cost.causal_pairs
    flops, nbytes = cost.crop_work(chip_smoke.B, chip_smoke.C,
                                   chip_smoke.OH, chip_smoke.OW, 4)
    assert chip_smoke.bound(kind, 4) == (
        nbytes, *cost.roof(kind, nbytes, flops, "f32_flops"))
    flops, nbytes = cost.attention_work(*chip_smoke.TIME_PREFILL[:4],
                                        chip_smoke.TIME_PREFILL[3],
                                        chip_smoke.TIME_PREFILL[4], 2)
    assert chip_smoke.attention_bound(
        kind, *chip_smoke.TIME_PREFILL[:4], chip_smoke.TIME_PREFILL[3],
        chip_smoke.TIME_PREFILL[4], 2) == (
            nbytes, flops, *cost.roof(kind, nbytes, flops, "bf16_flops"))
    B, K, G, T, D = chip_smoke.TIME_DECODE
    flops, nbytes = cost.decode_work([T] * B, K, G, D, 2)
    assert chip_smoke.decode_bound(kind, [T] * B, K, G, D, 2) == (
        nbytes, flops, *cost.roof(kind, nbytes, flops, "bf16_flops"))
    flops, nbytes = cost.gmm_work(*chip_smoke.GMM_PREFILL, 4)
    assert chip_smoke.gmm_bound(kind, *chip_smoke.GMM_PREFILL, 4) == (
        nbytes, flops, *cost.roof(kind, nbytes, flops, "f32_flops"))

