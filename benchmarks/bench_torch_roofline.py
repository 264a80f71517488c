"""Roofline analysis of the port's dry run on the H100: three terms per
(arch x shape x mesh), the twin of ``benchmarks/bench_roofline.py``.

Reads the dry-run JSONL (``results/dryrun_torch.jsonl``, written by
``python -m repro_torch.launch.dryrun --both-meshes --out ...``) and
derives, per cell:

    compute term    = FLOPs per device / 989.4e12 FLOP/s (bf16, dense)
    memory term     = HBM bytes per device / 3.35e12 B/s
    collective term = collective bytes per device / 50e9 B/s (one link)

with the constants of ``repro_torch.launch.mesh.HW`` (NVIDIA's H100 SXM
data sheet; one 400 Gb/s InfiniBand port per GPU).  The dry run counts
per device already, so each term is a per-device quantity over a
per-device peak.  The dominant term is the bottleneck;
MODEL_FLOPS/FLOPs measures how much of the counted compute is 'useful'
(remat recompute, replicated projections and attention show here).

    PYTHONPATH=src python -m benchmarks.bench_torch_roofline

prints both meshes' tables and writes ``results/roofline_torch.csv``.
(The reference's ``inject_into_experiments`` is not ported: it edits an
``EXPERIMENTS.md`` that this repo does not have and returns without one;
``PERF.md`` §5 holds the table.)
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

from repro_torch.configs.base import SHAPES, get_arch
from repro_torch.launch.dryrun_lib import peak_bytes
from repro_torch.launch.mesh import HW

PEAK_FLOPS = HW["peak_bf16_flops"]     # FLOP/s per H100
HBM_BW = HW["hbm_bandwidth"]           # B/s per H100
LINK_BW = HW["link_bandwidth"]         # B/s per GPU's inter-node port

DEFAULT_RESULTS = os.path.join(os.path.dirname(__file__), "..", "results",
                               "dryrun_torch.jsonl")


def _score_traffic_bytes_per_dev(rec: Dict) -> float:
    """Modeled HBM traffic of materialized attention score tiles in the
    port's chunked-attention training path (and the plain attention it
    runs up to 2048 tokens), which materialise score blocks as XLA does:
    the traffic the flash kernel keeps on chip.  ~passes x B x H x S x T x
    4 bytes / devices (passes: fwd writes+reads s and p ~4; bwd recompute
    ~4 more)."""
    cfg = get_arch(rec["arch"])
    shape = SHAPES[rec["shape"]]
    if shape.kind == "decode" or cfg.family == "ssm":
        return 0.0
    B, S = shape.global_batch, shape.seq_len
    T = min(cfg.window, S) if cfg.window else S
    passes = 8.0 if shape.kind == "train" else 4.0
    total = passes * B * cfg.n_heads * S * T * 4.0
    if cfg.family == "audio":   # decoder-only self-attn portion
        total *= cfg.n_layers / max(cfg.n_layers + cfg.enc_layers, 1)
    return total / rec["devices"]


def time_terms(rec: Dict) -> Dict[str, float]:
    """Seconds of the compute, memory and collective terms of ``rec``."""
    return {"compute": rec["flops_per_device"] / PEAK_FLOPS,
            "memory": rec["bytes_per_device"] / HBM_BW,
            "collective": rec["collective_bytes_per_device"]["total"]
            / LINK_BW}


def roofline_terms(rec: Dict) -> Dict:
    flops_dev = rec["flops_per_device"]
    bytes_dev = rec["bytes_per_device"]
    terms = time_terms(rec)
    t_compute, t_coll = terms["compute"], terms["collective"]
    dominant = max(terms, key=terms.get)
    bound = max(terms.values())
    model_flops_dev = rec["model_flops_total"] / rec["devices"]
    useful = model_flops_dev / max(flops_dev, 1e-9)
    # roofline fraction: useful model FLOPs per second achievable if the
    # dominant term were the only cost, vs the card's peak
    frac = (model_flops_dev / max(bound, 1e-12)) / PEAK_FLOPS
    # memory term with the score tiles kept on chip (a flash kernel)
    kern_mem = max(bytes_dev - _score_traffic_bytes_per_dev(rec), 0) / HBM_BW
    kern_bound = max(t_compute, kern_mem, t_coll)
    kern_frac = (model_flops_dev / max(kern_bound, 1e-12)) / PEAK_FLOPS
    fit_bytes = peak_bytes(rec)
    return {**terms, "dominant": dominant, "useful_flops_frac": useful,
            "roofline_frac": frac, "kern_memory": kern_mem,
            "kern_roofline_frac": kern_frac,
            "hbm_gib": fit_bytes / 2 ** 30,
            "fits_80g": fit_bytes <= HW["hbm_bytes"]}


def load_results(path: str = DEFAULT_RESULTS) -> List[Dict]:
    out = []
    with open(path) as f:
        for line in f:
            out.append(json.loads(line))
    return out


def format_table(records: List[Dict], mesh: Optional[str] = "16x16") -> str:
    rows = []
    header = (f"{'arch':18s} {'shape':12s} {'mesh':8s} {'comp(ms)':>9s} "
              f"{'mem(ms)':>9s} {'kern-mem':>9s} {'coll(ms)':>9s} "
              f"{'bound':>10s} {'useful':>7s} {'roof%':>6s} {'kern%':>6s} "
              f"{'HBM GiB':>8s} fit")
    rows.append(header)
    rows.append("-" * len(header))
    for rec in records:
        if mesh and rec["mesh"] != mesh:
            continue
        t = roofline_terms(rec)
        rows.append(
            f"{rec['arch']:18s} {rec['shape']:12s} {rec['mesh']:8s} "
            f"{t['compute']*1e3:9.2f} {t['memory']*1e3:9.2f} "
            f"{t['kern_memory']*1e3:9.2f} "
            f"{t['collective']*1e3:9.2f} {t['dominant']:>10s} "
            f"{t['useful_flops_frac']:7.2f} {t['roofline_frac']*100:5.1f}% "
            f"{t['kern_roofline_frac']*100:5.1f}% "
            f"{t['hbm_gib']:8.2f} {'Y' if t['fits_80g'] else 'OVER'}")
    return "\n".join(rows)


def run(out_csv: Optional[str] = None,
        results: str = DEFAULT_RESULTS) -> str:
    records = load_results(results)
    lines = ["# Roofline on the H100 — single-pod 16x16 (roofline table)",
             format_table(records, "16x16"),
             "", "# Multi-pod 2x16x16 (runnability pass)",
             format_table(records, "2x16x16")]
    text = "\n".join(lines)
    if out_csv:
        with open(out_csv, "w") as f:
            f.write("arch,shape,mesh,compute_s,memory_s,collective_s,"
                    "dominant,useful_frac,roofline_frac,hbm_gib,fits\n")
            for rec in records:
                t = roofline_terms(rec)
                f.write(f"{rec['arch']},{rec['shape']},{rec['mesh']},"
                        f"{t['compute']:.6f},{t['memory']:.6f},"
                        f"{t['collective']:.6f},{t['dominant']},"
                        f"{t['useful_flops_frac']:.3f},"
                        f"{t['roofline_frac']:.4f},{t['hbm_gib']:.2f},"
                        f"{int(t['fits_80g'])}\n")
    return text


def main() -> None:
    print(run(out_csv=os.path.join(os.path.dirname(DEFAULT_RESULTS),
                                   "roofline_torch.csv")))


if __name__ == "__main__":
    main()
